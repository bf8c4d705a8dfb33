// The tile compiler's node-space reach tables: one bounded Dijkstra per
// node, spread over threads.
//
// Counterpart: reporter_tpu/native/reach.cc (reporter_build_reach). Bit
// for bit the tables of the plain version, tiles/reach.py's
// build_reach_tables:
//   - distances accumulate in double and are stored as float;
//   - the heap pops (dist, node) in the tuple order of Python's heapq;
//   - the nearest max_targets are kept by (dist, edge id), as
//     np.lexsort((tos, dists)), then laid out ascending by target id (the
//     walk binary-searches rows).
// A restricted tile's ban-aware rows are built in Python on top of these
// (tiles/reach.py::build_reach_tables_restricted).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <limits>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct Target {
  double dist;
  int32_t to;
  int32_t next;
};

// Single-source bounded Dijkstra from node u; appends one Target per
// out-edge of every reached node (u itself included, at distance 0).
void node_targets(int32_t u, const int32_t* node_out, int64_t deg,
                  const int32_t* edge_dst, const float* edge_len,
                  double radius,
                  // scratch, stamped by epoch so nothing is cleared per call
                  std::vector<double>& dist, std::vector<int32_t>& first,
                  std::vector<int32_t>& stamp, int32_t epoch,
                  std::vector<int32_t>& reached, std::vector<Target>& out) {
  using QItem = std::pair<double, int32_t>;  // (dist, node): heapq order
  std::priority_queue<QItem, std::vector<QItem>, std::greater<QItem>> pq;

  auto get_dist = [&](int32_t v) {
    return stamp[v] == epoch ? dist[v]
                             : std::numeric_limits<double>::infinity();
  };

  dist[u] = 0.0;
  first[u] = -1;
  stamp[u] = epoch;
  pq.push({0.0, u});
  reached.clear();
  reached.push_back(u);

  while (!pq.empty()) {
    auto [d, v] = pq.top();
    pq.pop();
    if (d > get_dist(v)) continue;  // a stale entry
    const int32_t* row = node_out + int64_t(v) * deg;
    for (int64_t i = 0; i < deg; ++i) {
      int32_t e = row[i];
      if (e < 0) break;
      int32_t w = edge_dst[e];
      double nd = d + double(edge_len[e]);
      if (nd <= radius && nd < get_dist(w)) {
        if (stamp[w] != epoch) {
          stamp[w] = epoch;
          reached.push_back(w);
        }
        dist[w] = nd;
        first[w] = (v == u) ? e : first[v];
        pq.push({nd, w});
      }
    }
  }

  for (int32_t v : reached) {
    const int32_t* row = node_out + int64_t(v) * deg;
    for (int64_t i = 0; i < deg; ++i) {
      int32_t e2 = row[i];
      if (e2 < 0) break;
      out.push_back({dist[v], e2, (v == u) ? e2 : first[v]});
    }
  }
}

}  // namespace

extern "C" {

// reach_to / reach_next i32 [N, max_targets] (-1 padded) and reach_dist
// f32 [N, max_targets] (+inf padded), keyed by node; they arrive filled
// with the pads. n_threads <= 0 takes every hardware thread. Returns the
// number of nodes whose target list was cut.
int64_t reporter_build_reach(const int32_t* node_out, int64_t num_nodes,
                             int64_t deg, const int32_t* edge_dst,
                             const float* edge_len, double radius,
                             int32_t max_targets, int32_t n_threads,
                             int32_t* reach_to, float* reach_dist,
                             int32_t* reach_next) {
  std::atomic<int64_t> truncated{0};
  std::atomic<int64_t> next_node{0};
  if (n_threads <= 0) {
    n_threads = int32_t(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }

  auto worker = [&]() {
    std::vector<double> dist(num_nodes);
    std::vector<int32_t> first(num_nodes);
    std::vector<int32_t> stamp(num_nodes, -1);
    std::vector<int32_t> reached;
    std::vector<Target> targets;
    int32_t epoch = 0;
    for (;;) {
      int64_t u = next_node.fetch_add(1);
      if (u >= num_nodes) break;
      targets.clear();
      node_targets(int32_t(u), node_out, deg, edge_dst, edge_len, radius,
                   dist, first, stamp, epoch++, reached, targets);
      // (dist, edge id) is a total order here: a target edge appears once
      std::sort(targets.begin(), targets.end(),
                [](const Target& a, const Target& b) {
                  if (a.dist != b.dist) return a.dist < b.dist;
                  return a.to < b.to;
                });
      if (int64_t(targets.size()) > max_targets) {
        truncated.fetch_add(1);
        targets.resize(max_targets);
      }
      std::sort(targets.begin(), targets.end(),
                [](const Target& a, const Target& b) { return a.to < b.to; });
      int32_t* rt = reach_to + u * max_targets;
      float* rd = reach_dist + u * max_targets;
      int32_t* rn = reach_next + u * max_targets;
      for (size_t k = 0; k < targets.size(); ++k) {
        rt[k] = targets[k].to;
        rd[k] = float(targets[k].dist);
        rn[k] = targets[k].next;
      }
    }
  };

  std::vector<std::thread> pool;
  for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return truncated.load();
}

}  // extern "C"
