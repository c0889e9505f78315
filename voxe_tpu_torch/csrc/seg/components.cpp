// 3D connected-components labeling (6/18/26-connectivity) + largest-k ranking.
//
// Native replacement for the connected-components-3d (cc3d) dependency of the
// reference (reference: edit_pretrained_relu_field.py:384-416: cc3d.largest_k
// on the binarized density grid, 26-connectivity, k=10, where the LARGEST
// component carries label k). Flood-fill over the dense volume in C++.
//
// Exposed C ABI (ctypes):
//   largest_k_components(volume, X, Y, Z, connectivity, k, labels_out) -> N
// volume: uint8 binary [X*Y*Z] (x-major: idx = (x*Y + y)*Z + z)
// labels_out: int32 [X*Y*Z]; the i-th largest component gets label k-i+1
// (largest -> k, second -> k-1, ...); everything else 0. Returns the total
// number of components found.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

extern "C" int32_t largest_k_components(
    const uint8_t* volume, int32_t X, int32_t Y, int32_t Z,
    int32_t connectivity, int32_t k, int32_t* labels_out) {
  const int64_t total = (int64_t)X * Y * Z;
  std::vector<int32_t> comp(total, -1);

  // neighbor offsets
  std::vector<int> dx, dy, dz;
  for (int ox = -1; ox <= 1; ++ox)
    for (int oy = -1; oy <= 1; ++oy)
      for (int oz = -1; oz <= 1; ++oz) {
        if (ox == 0 && oy == 0 && oz == 0) continue;
        int manhattan = std::abs(ox) + std::abs(oy) + std::abs(oz);
        if (connectivity == 6 && manhattan != 1) continue;
        if (connectivity == 18 && manhattan > 2) continue;
        dx.push_back(ox);
        dy.push_back(oy);
        dz.push_back(oz);
      }

  std::vector<int64_t> stack;
  std::vector<int64_t> comp_sizes;
  int32_t num_components = 0;

  for (int64_t seed = 0; seed < total; ++seed) {
    if (!volume[seed] || comp[seed] >= 0) continue;
    const int32_t cid = num_components++;
    int64_t size = 0;
    stack.push_back(seed);
    comp[seed] = cid;
    while (!stack.empty()) {
      int64_t v = stack.back();
      stack.pop_back();
      ++size;
      int32_t x = (int32_t)(v / ((int64_t)Y * Z));
      int32_t rem = (int32_t)(v % ((int64_t)Y * Z));
      int32_t y = rem / Z;
      int32_t z = rem % Z;
      for (size_t n = 0; n < dx.size(); ++n) {
        int32_t nx = x + dx[n], ny = y + dy[n], nz = z + dz[n];
        if (nx < 0 || nx >= X || ny < 0 || ny >= Y || nz < 0 || nz >= Z)
          continue;
        int64_t nv = ((int64_t)nx * Y + ny) * Z + nz;
        if (volume[nv] && comp[nv] < 0) {
          comp[nv] = cid;
          stack.push_back(nv);
        }
      }
    }
    comp_sizes.push_back(size);
  }

  // rank components by size (descending); i-th largest -> label k-i
  std::vector<std::pair<int64_t, int32_t>> ranked;
  ranked.reserve(comp_sizes.size());
  for (int32_t c = 0; c < num_components; ++c)
    ranked.push_back({comp_sizes[c], c});
  std::sort(ranked.rbegin(), ranked.rend());

  std::vector<int32_t> relabel(num_components, 0);
  for (int32_t rank = 0; rank < (int32_t)ranked.size() && rank < k; ++rank)
    relabel[ranked[rank].second] = k - rank;

  for (int64_t v = 0; v < total; ++v)
    labels_out[v] = comp[v] >= 0 ? relabel[comp[v]] : 0;
  return num_components;
}
