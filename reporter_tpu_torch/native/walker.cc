// Native segment walker: decoded match output -> OSMLR segment records.
//
// Counterpart: reporter_tpu/native/walker.cc (reporter_walk_segments). The
// same walk as the port's Python one (matcher/segments.py: build_segments
// and its helpers) over the same flat arrays, multithreaded across traces;
// matcher/native_walk.py binds it with ctypes and the tests hold its
// records equal to the Python walk's and to the JAX package's, at
// tolerance 0:
//   - accumulation in double; edge lengths are float32 widened per element
//   - route expansion via reach_to/reach_dist/reach_next with the same
//     first-hit / monotone-gap / next<0 bail-outs (reach rows ascending by
//     target edge id, so a binary search finds the first hit)
//   - _time_at: searchsorted-left with index clamped to [1, len-1]
//   - record emission thresholds (kMinSpan, 1.0 m origin/tail tolerance)
//
// Build: native/build.py (g++ -O3 -Wall -Wextra -Werror -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

// matcher/segments.MIN_RECORD_SPAN: spans below one wire offset quantum
// are float noise; both walkers must agree on the emission threshold.
constexpr double kMinSpan = 0.25;

// matcher/segments.QUEUE_SPEED / QUEUE_WINDOW: movement slower than
// kQueueSpeed averaged over a kQueueWindow trailing span counts as queued
// traffic (dwell-at-the-stop-line model; the window absorbs the decoder's
// plateau-then-pulse shape for creeping points).
constexpr double kQueueSpeed = 2.0;
constexpr double kQueueWindow = 10.0;

struct Record {
  int64_t seg_id;
  double t0, t1, length, queue;
  bool internal;
  std::vector<int64_t> way_ids;
};

// matcher/segments._queue_length: queue backed up from the segment tail.
// Walk points backward from the tail anchor; a point extends the queue when
// the average speed over the kQueueWindow span after it (capped at the
// anchor) is below kQueueSpeed (dd < kQueueSpeed*dt — divisionless, so
// dt<=0 spans are never slow). Clamped to [0, seg_len].
double queue_length(const std::vector<double>& pd,
                    const std::vector<double>& pt, double d_tail,
                    double seg_len) {
  // Anchor at the LAST point at/before the tail (segments.py parity);
  // point distances are monotone, so binary-search the anchor.
  size_t i = std::upper_bound(pd.begin(), pd.end(), d_tail + 1e-6) -
             pd.begin();
  i = (i == 0) ? 0 : i - 1;
  double q_start = d_tail;
  size_t j = i, k = i;  // j: min index with time >= cand time + window
  while (k >= 1) {
    size_t cand = k - 1;
    while (j > cand + 1 && pt[j - 1] - pt[cand] >= kQueueWindow) --j;
    double dd = pd[j] - pd[cand];
    double dt = pt[j] - pt[cand];
    if (!(dd < kQueueSpeed * dt)) break;
    q_start = pd[cand];
    k = cand;
  }
  return std::min(std::max(d_tail - q_start, 0.0), seg_len);
}

struct Tile {
  const float* edge_len;
  const int64_t* edge_way;
  const int32_t* edge_osmlr;
  const float* edge_osmlr_off;
  const int64_t* osmlr_id;
  const float* osmlr_len;
  const int32_t* reach_row;   // edge → governing reach row (its dst node)
  const int32_t* reach_to;
  const float* reach_dist;
  const int32_t* reach_next;
  int32_t reach_m;
};

// segments.reach_route_fn: intermediate edges strictly between e1 and e2, or nullopt
// (signalled by returning false) when unreachable within the reach tables.
bool route_between(const Tile& t, int32_t e1, int32_t e2,
                   std::vector<int32_t>& mid) {
  mid.clear();
  if (e1 == e2) return true;
  int32_t e = e1;
  double gap = std::numeric_limits<double>::infinity();
  while (true) {
    int64_t u = t.reach_row[e];
    const int32_t* row = t.reach_to + u * t.reach_m;
    // Rows are laid out ascending by target id with -1 padding at the end
    // (tiles/reach.build_reach_tables; NativeWalker checks it) — binary
    // search with -1 mapped past every real id, instead of an O(M) scan
    // per hop.
    auto key = [](int32_t v) {
      return v < 0 ? std::numeric_limits<int64_t>::max() : int64_t(v);
    };
    const int32_t* lo = std::lower_bound(
        row, row + t.reach_m, e2,
        [&](int32_t a, int32_t b) { return key(a) < key(b); });
    if (lo == row + t.reach_m || *lo != e2) return false;
    int32_t hit = int32_t(lo - row);
    double new_gap = t.reach_dist[u * t.reach_m + hit];
    if (new_gap >= gap) return false;  // no progress ⇒ inconsistent tables
    gap = new_gap;
    int32_t nxt = t.reach_next[u * t.reach_m + hit];
    if (nxt == e2) return true;
    if (nxt < 0) return false;
    mid.push_back(nxt);
    e = nxt;
  }
}

// matcher/segments._time_at: linear interpolation at path distance d.
double time_at(const std::vector<double>& ds, const std::vector<double>& ts,
               double d) {
  if (ds.empty() || d < ds.front() - 1e-6 || d > ds.back() + 1e-6) return -1.0;
  // np.searchsorted side='left'
  size_t i = std::lower_bound(ds.begin(), ds.end(), d) - ds.begin();
  if (i < 1) i = 1;
  if (i > ds.size() - 1) i = ds.size() - 1;
  double d0 = ds[i - 1], t0 = ts[i - 1];
  double d1 = ds[i], t1 = ts[i];
  if (d1 <= d0 + 1e-9) return t0;
  double w = (d - d0) / (d1 - d0);
  return t0 + w * (t1 - t0);
}

// matcher/segments._path_to_records for one (path, pts) pair.
void path_to_records(const Tile& t, const std::vector<int32_t>& path,
                     const std::vector<double>& pd,   // per-point path dist
                     const std::vector<double>& pt,   // per-point time
                     std::vector<Record>& out) {
  size_t n = path.size();
  std::vector<double> cum(n + 1, 0.0);
  for (size_t i = 0; i < n; ++i)
    cum[i + 1] = cum[i] + static_cast<double>(t.edge_len[path[i]]);
  double observed_lo = pd.front(), observed_hi = pd.back();

  size_t i = 0;
  while (i < n) {
    int32_t row = t.edge_osmlr[path[i]];
    size_t j = i;
    while (j + 1 < n && t.edge_osmlr[path[j + 1]] == row &&
           (row < 0 ||
            std::fabs(static_cast<double>(t.edge_osmlr_off[path[j + 1]]) -
                      (static_cast<double>(t.edge_osmlr_off[path[j]]) +
                       static_cast<double>(t.edge_len[path[j]]))) < 1.0)) {
      ++j;
    }
    double d_lo = cum[i], d_hi = cum[j + 1];
    double c_lo = std::max(d_lo, observed_lo);
    double c_hi = std::min(d_hi, observed_hi);
    if (c_hi > c_lo + kMinSpan) {
      Record r;
      for (size_t e = i; e <= j; ++e) {
        int64_t w = t.edge_way[path[e]];
        if (r.way_ids.empty() || r.way_ids.back() != w) r.way_ids.push_back(w);
      }
      if (row < 0) {
        r.seg_id = -1;
        r.t0 = time_at(pd, pt, c_lo);
        r.t1 = time_at(pd, pt, c_hi);
        r.length = c_hi - c_lo;
        r.queue = 0.0;
        r.internal = true;
      } else {
        double o_start = static_cast<double>(t.edge_osmlr_off[path[i]]);
        double seg_len = static_cast<double>(t.osmlr_len[row]);
        double covered_lo = o_start + (c_lo - d_lo);
        double covered_hi = o_start + (c_hi - d_lo);
        bool starts_at_origin = covered_lo <= 1.0;
        bool ends_at_tail = covered_hi >= seg_len - 1.0;
        r.seg_id = t.osmlr_id[row];
        r.t0 = starts_at_origin ? time_at(pd, pt, c_lo) : -1.0;
        r.t1 = ends_at_tail ? time_at(pd, pt, c_hi) : -1.0;
        r.length = covered_hi - covered_lo;
        // Queue needs the stop line observed (matcher/segments.py parity).
        r.queue = ends_at_tail
                      ? queue_length(pd, pt, d_lo + (seg_len - o_start),
                                     seg_len)
                      : 0.0;
        r.internal = false;
      }
      out.push_back(std::move(r));
    }
    i = j + 1;
  }
}

// matcher/segments._chain_to_path + build_segments for one trace.
void walk_trace(const Tile& tile, const int32_t* edges, const float* offs,
                const uint8_t* starts, const double* times, int64_t T,
                double backward_slack, std::vector<Record>& out) {
  // _to_chains: group matched points into breakage-free chains
  std::vector<int32_t> ce;       // chain edges
  std::vector<double> co, ct;    // chain offsets / times
  std::vector<int32_t> path, mid;
  std::vector<double> cum, pd, pt;

  auto flush_path = [&]() {
    if (!path.empty() && !pd.empty()) path_to_records(tile, path, pd, pt, out);
    path.clear();
    cum.clear();
    pd.clear();
    pt.clear();
  };

  auto run_chain = [&]() {
    if (ce.empty()) return;
    // _chain_to_path
    path.assign(1, ce[0]);
    cum.assign(1, 0.0);
    pd.assign(1, co[0]);
    pt.assign(1, ct[0]);
    for (size_t i = 1; i < ce.size(); ++i) {
      int32_t e_prev = ce[i - 1], e_cur = ce[i];
      double off = co[i], tm = ct[i];
      if (e_cur == e_prev && off >= co[i - 1] - backward_slack) {
        double d = cum.back() + std::max(off, pd.back() - cum.back());
        pd.push_back(d);
        pt.push_back(tm);
        continue;
      }
      if (!route_between(tile, e_prev, e_cur, mid)) {
        flush_path();
        path.assign(1, e_cur);
        cum.assign(1, 0.0);
        pd.assign(1, off);
        pt.assign(1, tm);
        continue;
      }
      mid.push_back(e_cur);
      for (int32_t m : mid) {
        cum.push_back(cum.back() +
                      static_cast<double>(tile.edge_len[path.back()]));
        path.push_back(m);
      }
      pd.push_back(cum.back() + off);
      pt.push_back(tm);
    }
    flush_path();
    ce.clear();
    co.clear();
    ct.clear();
  };

  for (int64_t t = 0; t < T; ++t) {
    if (edges[t] < 0) continue;
    if (starts[t]) run_chain();  // closes the previous chain (no-op if empty)
    ce.push_back(edges[t]);
    co.push_back(static_cast<double>(offs[t]));
    ct.push_back(times[t]);
  }
  run_chain();
}

}  // namespace

extern "C" {

// Returns the total record count (which may exceed rec_cap — caller retries
// with larger buffers; outputs are only written up to the capacities).
// way_off must hold rec_cap + 1 entries; *n_ways_out reports the total
// way-id count (valid only when everything fit).
int64_t reporter_walk_segments(
    const int32_t* edges, const float* offs, const uint8_t* starts,
    const double* times, int64_t B, int64_t T,
    const float* edge_len, const int64_t* edge_way, const int32_t* edge_osmlr,
    const float* edge_osmlr_off,
    const int64_t* osmlr_id, const float* osmlr_len,
    const int32_t* reach_row,
    const int32_t* reach_to, const float* reach_dist,
    const int32_t* reach_next, int32_t reach_m,
    double backward_slack, int32_t n_threads,
    int32_t* rec_trace, int64_t* rec_seg, double* rec_t0, double* rec_t1,
    double* rec_len, double* rec_queue, uint8_t* rec_internal,
    int64_t rec_cap,
    int32_t* way_off, int64_t* way_ids, int64_t way_cap,
    int64_t* n_ways_out) {
  Tile tile{edge_len,  edge_way,  edge_osmlr, edge_osmlr_off, osmlr_id,
            osmlr_len, reach_row, reach_to,   reach_dist,     reach_next,
            reach_m};

  if (n_threads < 1) n_threads = 1;
  if (n_threads > B) n_threads = static_cast<int32_t>(B > 0 ? B : 1);
  std::vector<std::vector<std::vector<Record>>> shards(n_threads);
  std::vector<std::thread> workers;
  int64_t per = (B + n_threads - 1) / n_threads;
  for (int32_t w = 0; w < n_threads; ++w) {
    workers.emplace_back([&, w]() {
      int64_t lo = w * per, hi = std::min(B, lo + per);
      if (lo >= hi) return;
      shards[w].resize(hi - lo);
      for (int64_t b = lo; b < hi; ++b) {
        walk_trace(tile, edges + b * T, offs + b * T, starts + b * T,
                   times + b * T, T, backward_slack, shards[w][b - lo]);
      }
    });
  }
  for (auto& th : workers) th.join();

  int64_t nrec = 0, nway = 0;
  for (int32_t w = 0; w < n_threads; ++w) {
    int64_t lo = w * per;
    for (size_t i = 0; i < shards[w].size(); ++i) {
      for (Record& r : shards[w][i]) {
        if (nrec < rec_cap &&
            nway + static_cast<int64_t>(r.way_ids.size()) <= way_cap) {
          rec_trace[nrec] = static_cast<int32_t>(lo + i);
          rec_seg[nrec] = r.seg_id;
          rec_t0[nrec] = r.t0;
          rec_t1[nrec] = r.t1;
          rec_len[nrec] = r.length;
          rec_queue[nrec] = r.queue;
          rec_internal[nrec] = r.internal ? 1 : 0;
          way_off[nrec] = static_cast<int32_t>(nway);
          std::memcpy(way_ids + nway, r.way_ids.data(),
                      r.way_ids.size() * sizeof(int64_t));
        }
        nway += static_cast<int64_t>(r.way_ids.size());
        ++nrec;
      }
    }
  }
  if (nrec <= rec_cap) way_off[nrec] = static_cast<int32_t>(nway);
  *n_ways_out = nway;
  return nrec;
}

}  // extern "C"
