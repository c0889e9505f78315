// Max-flow / min-cut via the Boykov-Kolmogorov dual-tree algorithm.
//
// Native replacement for the PyMaxflow (BK) dependency of the reference
// (reference: thre3d_atom/modules/refinement_functions.py:185,289-293).
// BK is the standard choice for sparse grid-structured vision graphs: it
// grows source and sink search trees simultaneously and reuses them across
// augmentations instead of rebuilding BFS levels like Dinic, which on the
// 6-connected voxel graphs this framework cuts (0.27M-4M nodes) is worth
// an order of magnitude (measured: 268k nodes 1.8 s Dinic vs ~0.1 s BK;
// 4.1M nodes 159 s vs ~2 s). Written fresh from the published algorithm
// (Boykov & Kolmogorov, PAMI 2004), flat-array CSR-style adjacency.
//
// Exposed C ABI (ctypes), same contract as maxflow.cpp's Dinic entry:
//   bk_maxflow_mincut(num_nodes, num_edges, edge_u, edge_v, cap, cap_rev,
//                     cap_src, cap_snk, labels_out) -> double (flow value)
// labels_out[i] = 0 if node i ends on the SOURCE side (edit), 1 otherwise,
// matching PyMaxflow's get_segment convention (refinement_functions.py:293).

#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

constexpr uint8_t kFree = 0, kS = 1, kT = 2;
constexpr int32_t kNoArc = -1;    // no parent arc
constexpr int32_t kTerminal = -2; // parent is the terminal (tree root)
constexpr int32_t kOrphan = -3;   // parentless, awaiting adoption

class BK {
 public:
  BK(int32_t n, int64_t m)
      : n_(n),
        first_(n, kNoArc),
        tr_cap_(n, 0.0),
        parent_(n, kNoArc),
        tree_(n, kFree),
        ts_(n, 0),
        dist_(n, 0),
        in_active_(n, 0) {
    // each undirected input edge becomes an arc pair (a, a^1)
    head_.reserve(2 * m);
    next_.reserve(2 * m);
    rcap_.reserve(2 * m);
  }

  void add_edge(int32_t u, int32_t v, double cap_uv, double cap_vu) {
    int32_t a = (int32_t)head_.size();
    head_.push_back(v); rcap_.push_back(cap_uv); next_.push_back(first_[u]);
    first_[u] = a;
    head_.push_back(u); rcap_.push_back(cap_vu); next_.push_back(first_[v]);
    first_[v] = a + 1;
  }

  // combined terminal capacity: flow routed source->node->sink saturates
  // min(cap_src, cap_snk) immediately; only the surplus needs the graph
  void set_terminal(int32_t v, double cap_src, double cap_snk) {
    double direct = cap_src < cap_snk ? cap_src : cap_snk;
    flow_ += direct;
    tr_cap_[v] = cap_src - cap_snk;
  }

  double run() {
    for (int32_t v = 0; v < n_; ++v) {
      if (tr_cap_[v] > 0) {
        tree_[v] = kS; parent_[v] = kTerminal; dist_[v] = 1; ts_[v] = 0;
        push_active(v);
      } else if (tr_cap_[v] < 0) {
        tree_[v] = kT; parent_[v] = kTerminal; dist_[v] = 1; ts_[v] = 0;
        push_active(v);
      }
    }
    int32_t time = 0;
    while (!active_.empty()) {
      int32_t p = active_.front();
      active_.pop_front();
      in_active_[p] = 0;
      if (tree_[p] == kFree || parent_[p] == kOrphan) continue;
      ++time;
      grow(p, time);
    }
    return flow_;
  }

  void source_side(uint8_t* labels) const {
    // free nodes (in neither search tree, i.e. disconnected from both
    // terminals in the residual graph) default to SOURCE (0), matching
    // PyMaxflow's what_segment(..., default_segm=SOURCE)
    for (int32_t v = 0; v < n_; ++v)
      labels[v] = (tree_[v] == kT) ? 1 : 0;
  }

 private:
  void push_active(int32_t v) {
    if (!in_active_[v]) { in_active_[v] = 1; active_.push_back(v); }
  }

  // GROWTH from active node p; on tree collision, augment + adopt, then
  // RESTART the arc scan from p's first arc — the adoption can free nodes
  // (or re-open residual arcs) behind the scan cursor, and skipping them
  // loses augmenting paths / terminates with residual S->T paths left
  // (matches the reference BK implementation's current_node re-scan).
  void grow(int32_t p, int32_t& time) {
    uint8_t t = tree_[p];
    int32_t a = first_[p];
    while (a != kNoArc) {
      // S grows along residual p->q; T grows along residual q->p
      double r = (t == kS) ? rcap_[a] : rcap_[a ^ 1];
      if (r <= 0) { a = next_[a]; continue; }
      int32_t q = head_[a];
      if (tree_[q] == kFree) {
        tree_[q] = t;
        parent_[q] = a ^ 1;  // arc q->p: child's arc toward its parent
        ts_[q] = ts_[p];
        dist_[q] = dist_[p] + 1;
        push_active(q);
        a = next_[a];
      } else if (tree_[q] != t) {
        // bridge between the trees: arc must run S-side -> T-side
        int32_t bridge = (t == kS) ? a : (a ^ 1);
        augment(bridge);
        ++time;
        adopt(time);
        if (tree_[p] != t || parent_[p] == kOrphan) return;
        a = first_[p];  // restart: adoption may have freed earlier frontiers
      } else {
        if (ts_[q] <= ts_[p] && dist_[q] > dist_[p] + 1) {
          // same tree: shorter path to root found — re-parent (heuristic)
          parent_[q] = a ^ 1;
          ts_[q] = ts_[p];
          dist_[q] = dist_[p] + 1;
        }
        a = next_[a];
      }
    }
  }

  // residual capacity of the arc that feeds node v FROM its parent, in the
  // direction flow moves along v's tree (S: parent->v, T: v->parent)
  double& parent_rcap(int32_t v) {
    int32_t pa = parent_[v];  // arc v->parent
    return tree_[v] == kS ? rcap_[pa ^ 1] : rcap_[pa];
  }

  void augment(int32_t bridge) {
    // Bottleneck over: S path root..s_end, the bridge, T path t_end..root.
    // The roots are recorded HERE, while the parent chains are intact — the
    // push phase below orphans saturated mid-path nodes, which would cut the
    // chain before a later walk could reach the terminal arcs.
    double b = rcap_[bridge];
    int32_t s_end = head_[bridge ^ 1], t_end = head_[bridge];
    int32_t s_root = s_end;
    while (parent_[s_root] != kTerminal) {
      double r = parent_rcap(s_root);
      if (r < b) b = r;
      s_root = head_[parent_[s_root]];
    }
    if (tr_cap_[s_root] < b) b = tr_cap_[s_root];
    int32_t t_root = t_end;
    while (parent_[t_root] != kTerminal) {
      double r = parent_rcap(t_root);
      if (r < b) b = r;
      t_root = head_[parent_[t_root]];
    }
    if (-tr_cap_[t_root] < b) b = -tr_cap_[t_root];

    // push b along the path; saturated tree arcs orphan their child node
    rcap_[bridge] -= b;
    rcap_[bridge ^ 1] += b;
    for (int32_t v = s_end; parent_[v] != kTerminal;) {
      int32_t pa = parent_[v];
      int32_t nxt = head_[pa];
      rcap_[pa ^ 1] -= b;  // parent->v carries S-tree flow
      rcap_[pa] += b;
      if (rcap_[pa ^ 1] <= 0) { parent_[v] = kOrphan; orphans_.push_back(v); }
      v = nxt;
    }
    tr_cap_[s_root] -= b;
    if (tr_cap_[s_root] <= 0) {
      parent_[s_root] = kOrphan;
      orphans_.push_back(s_root);
    }
    for (int32_t v = t_end; parent_[v] != kTerminal;) {
      int32_t pa = parent_[v];
      int32_t nxt = head_[pa];
      rcap_[pa] -= b;  // v->parent carries T-tree flow
      rcap_[pa ^ 1] += b;
      if (rcap_[pa] <= 0) { parent_[v] = kOrphan; orphans_.push_back(v); }
      v = nxt;
    }
    tr_cap_[t_root] += b;
    if (tr_cap_[t_root] >= 0) {
      parent_[t_root] = kOrphan;
      orphans_.push_back(t_root);
    }
    flow_ += b;
  }

  // does v reach a terminal-rooted ancestor? stamps dist/ts on the way back
  bool rooted(int32_t v, int32_t time, int32_t& d_out) {
    int32_t d = 0;
    int32_t u = v;
    while (true) {
      if (ts_[u] == time) { d += dist_[u]; break; }
      int32_t pa = parent_[u];
      if (pa == kTerminal) { d += 1; break; }
      if (pa == kNoArc || pa == kOrphan) return false;
      ++d;
      u = head_[pa];
    }
    // stamp the walked prefix so later checks are O(1)
    int32_t dd = d;
    for (int32_t w = v; ts_[w] != time && parent_[w] != kTerminal;
         w = head_[parent_[w]]) {
      ts_[w] = time;
      dist_[w] = dd--;
    }
    d_out = d;
    return true;
  }

  void adopt(int32_t time) {
    while (!orphans_.empty()) {
      int32_t v = orphans_.front();
      orphans_.pop_front();
      if (tree_[v] == kFree) continue;
      uint8_t t = tree_[v];
      // find the closest-to-root valid neighbor in the same tree with a
      // residual arc toward v (S: q->v, T: v->q)
      int32_t best_arc = kNoArc, best_d = INT32_MAX;
      for (int32_t a = first_[v]; a != kNoArc; a = next_[a]) {
        int32_t q = head_[a];
        if (tree_[q] != t) continue;
        double r = (t == kS) ? rcap_[a ^ 1] : rcap_[a];
        if (r <= 0) continue;
        if (parent_[q] == kOrphan || parent_[q] == kNoArc) continue;
        int32_t d;
        if (!rooted(q, time, d)) continue;
        if (d < best_d) { best_d = d; best_arc = a; }
      }
      if (best_arc != kNoArc) {
        parent_[v] = best_arc;
        ts_[v] = time;
        dist_[v] = best_d + 1;
        continue;
      }
      // no parent: v leaves the tree; neighbors may re-grow it, children
      // become orphans
      for (int32_t a = first_[v]; a != kNoArc; a = next_[a]) {
        int32_t q = head_[a];
        if (tree_[q] != t) continue;
        double r = (t == kS) ? rcap_[a ^ 1] : rcap_[a];
        if (r > 0) push_active(q);
        int32_t pq = parent_[q];
        if (pq >= 0 && head_[pq] == v) {
          parent_[q] = kOrphan;
          orphans_.push_back(q);
        }
      }
      tree_[v] = kFree;
      parent_[v] = kNoArc;
    }
  }

  int32_t n_;
  std::vector<int32_t> first_, head_, next_;
  std::vector<double> rcap_;
  std::vector<double> tr_cap_;
  std::vector<int32_t> parent_;
  std::vector<uint8_t> tree_;
  std::vector<int32_t> ts_, dist_;
  std::vector<uint8_t> in_active_;
  std::deque<int32_t> active_;
  std::deque<int32_t> orphans_;
  double flow_ = 0.0;
};

}  // namespace

extern "C" double bk_maxflow_mincut(
    int32_t num_nodes, int64_t num_edges,
    const int32_t* edge_u, const int32_t* edge_v,
    const float* cap, const float* cap_rev,
    const float* cap_src, const float* cap_snk,
    uint8_t* labels_out) {
  BK bk(num_nodes, num_edges);
  for (int64_t i = 0; i < num_edges; ++i) {
    bk.add_edge(edge_u[i], edge_v[i], cap[i], cap_rev[i]);
  }
  for (int32_t i = 0; i < num_nodes; ++i) {
    if (cap_src[i] > 0 || cap_snk[i] > 0) {
      bk.set_terminal(i, cap_src[i], cap_snk[i]);
    }
  }
  double flow = bk.run();
  bk.source_side(labels_out);
  return flow;
}
