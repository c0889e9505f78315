// Max-flow / min-cut over a voxel adjacency graph (Dinic's algorithm).
//
// Native replacement for the PyMaxflow (Boykov-Kolmogorov) dependency of the
// reference (reference: thre3d_atom/modules/refinement_functions.py:185,289-293).
// The reference builds its graph in a Python loop over ~1e5 nodes (minutes of
// interpreter overhead); here the caller passes flat edge arrays built with
// vectorized NumPy and the cut itself runs in optimized C++.
//
// Exposed C ABI (ctypes):
//   maxflow_mincut(num_nodes, num_edges, edge_u, edge_v, cap, cap_rev,
//                  cap_src, cap_snk, labels_out) -> double (flow value)
// labels_out[i] = 0 if node i is on the SOURCE side (edit), 1 otherwise
// (object) — matching PyMaxflow's get_segment convention used by the
// reference (refinement_functions.py:293-297).

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Edge {
  int32_t to;
  int32_t rev;   // index of reverse edge in graph[to]
  double cap;
};

class Dinic {
 public:
  explicit Dinic(int n) : n_(n), graph_(n), level_(n), iter_(n) {}

  void add_edge(int from, int to, double cap, double cap_rev) {
    graph_[from].push_back({to, (int32_t)graph_[to].size(), cap});
    graph_[to].push_back({from, (int32_t)(graph_[from].size() - 1), cap_rev});
  }

  double max_flow(int s, int t) {
    double flow = 0;
    while (bfs(s, t)) {
      std::fill(iter_.begin(), iter_.end(), 0);
      double f;
      while ((f = dfs(s, t, kInf)) > 0) flow += f;
    }
    return flow;
  }

  // after max_flow: label 1 = nodes that can still REACH THE SINK in the
  // residual graph; everything else — including nodes disconnected from both
  // terminals — labels 0 (SOURCE), matching PyMaxflow's what_segment default
  // segment (SOURCE) for free nodes. Labeling by source-reachability instead
  // would put free nodes on the sink side and diverge from the reference.
  void sink_side(int t, uint8_t* labels) {
    std::memset(labels, 0, n_);
    std::queue<int> q;
    q.push(t);
    labels[t] = 1;
    while (!q.empty()) {
      int v = q.front();
      q.pop();
      for (const Edge& e : graph_[v]) {
        // residual capacity on the REVERSE arc (e.to -> v)?
        if (graph_[e.to][e.rev].cap > kEps && !labels[e.to]) {
          labels[e.to] = 1;
          q.push(e.to);
        }
      }
    }
  }

 private:
  static constexpr double kInf = 1e300;
  static constexpr double kEps = 1e-12;

  bool bfs(int s, int t) {
    std::fill(level_.begin(), level_.end(), -1);
    std::queue<int> q;
    level_[s] = 0;
    q.push(s);
    while (!q.empty()) {
      int v = q.front();
      q.pop();
      for (const Edge& e : graph_[v]) {
        if (e.cap > kEps && level_[e.to] < 0) {
          level_[e.to] = level_[v] + 1;
          q.push(e.to);
        }
      }
    }
    return level_[t] >= 0;
  }

  double dfs(int v, int t, double f) {
    if (v == t) return f;
    for (int32_t& i = iter_[v]; i < (int32_t)graph_[v].size(); ++i) {
      Edge& e = graph_[v][i];
      if (e.cap > kEps && level_[v] < level_[e.to]) {
        double d = dfs(e.to, t, f < e.cap ? f : e.cap);
        if (d > 0) {
          e.cap -= d;
          graph_[e.to][e.rev].cap += d;
          return d;
        }
      }
    }
    return 0;
  }

  int n_;
  std::vector<std::vector<Edge>> graph_;
  std::vector<int32_t> level_;
  std::vector<int32_t> iter_;
};

}  // namespace

extern "C" double maxflow_mincut(
    int32_t num_nodes, int64_t num_edges,
    const int32_t* edge_u, const int32_t* edge_v,
    const float* cap, const float* cap_rev,
    const float* cap_src, const float* cap_snk,
    uint8_t* labels_out) {
  const int source = num_nodes;
  const int sink = num_nodes + 1;
  Dinic dinic(num_nodes + 2);

  for (int64_t i = 0; i < num_edges; ++i) {
    dinic.add_edge(edge_u[i], edge_v[i], cap[i], cap_rev[i]);
  }
  for (int32_t i = 0; i < num_nodes; ++i) {
    if (cap_src[i] > 0) dinic.add_edge(source, i, cap_src[i], 0);
    if (cap_snk[i] > 0) dinic.add_edge(i, sink, cap_snk[i], 0);
  }

  double flow = dinic.max_flow(source, sink);

  std::vector<uint8_t> labels(num_nodes + 2);
  dinic.sink_side(sink, labels.data());
  std::memcpy(labels_out, labels.data(), num_nodes);
  return flow;
}
