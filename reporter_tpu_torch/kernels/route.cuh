// The HMM's transition between two candidates, for Hopper (sm_90a): the
// lookup of the previous candidate's reach row and the route's cost, as
// ops/hmm.py::_route and _transition compute them, one rounding per
// operation in their order (the intrinsics below, and -fmad=false). Shared
// by viterbi.cu (the batched decode) and lattice.cu (the ranked-path
// forward).
//
// Every reach row holds strictly ascending target edge ids with the -1
// padding at the end (tiles/tileset.py::host_tables refuses a row that
// does not). Read as unsigned, -1 sorts past every real id, so a lookup is
// a binary search of ceil(log2(M + 1)) probes, and a row holds an id at
// most once: the hit's distance is the plain version's masked minimum.

#pragma once

#include <cuda_runtime.h>

namespace rtt_route {

constexpr float kRouteBig = 1e30f;   // ops/dense_candidates.BIG

// N binary searches at once (independent probes in flight): for each u
// with ok[u], the index of key[u] in the row at to[u] (M entries), -1
// where it is absent. top: the largest power of two <= M. The lower
// bound, where the key sits if present, is always probed when it is < M.
// kLoadsFirst: each step's N probes are loaded before any is compared,
// unconditionally (an index past the row reads its last entry, and is
// then ignored), so no branch stands between the loads (lattice.cu,
// viterbi.cu's wide kernel); else each probe is loaded under its test
// (viterbi.cu's instance 0).
template <int N, bool kLoadsFirst = false>
__device__ __forceinline__ void search_rows(const int* const (&to)[N],
                                            const unsigned (&key)[N],
                                            const bool (&ok)[N], int M,
                                            int top, int (&hit)[N]) {
  int pos[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    pos[u] = -1;
    hit[u] = -1;
  }
  for (int step = top; step > 0; step >>= 1) {
    if constexpr (kLoadsFirst) {
      unsigned v[N];
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const int at = min(pos[u] + step, M - 1);
        v[u] = static_cast<unsigned>(__ldg(to[u] + at));
      }
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const int idx = pos[u] + step;
        const bool in = ok[u] && idx < M;
        pos[u] = in && v[u] < key[u] ? idx : pos[u];
        hit[u] = in && v[u] == key[u] ? idx : hit[u];
      }
    } else {
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const int idx = pos[u] + step;
        if (ok[u] && idx < M) {
          const unsigned v = static_cast<unsigned>(__ldg(to[u] + idx));
          if (v < key[u]) {
            pos[u] = idx;
          } else if (v == key[u]) {
            hit[u] = idx;
          }
        }
      }
    }
  }
}

// The transition cost from a candidate on edge e1 (length len1, offset o1)
// to one on edge e2 (offset o2), both valid with an edge, gap the reach
// row's distance from the end of e1 to the start of e2 (kRouteBig where
// the row does not hold e2), gc the straight-line distance between the
// two points: |route - gc| / beta, kRouteBig where the route is
// unreachable or longer than factor * gc + 10 m. Going back along one
// edge by less than `slack` counts as no progress.
__device__ __forceinline__ float transition_cost(int e1, float len1, float o1,
                                                 int e2, float o2, float gap,
                                                 float gc, float beta,
                                                 float factor, float slack) {
  // the detour guard's limit: a multiply, then an add
  const float limit = __fadd_rn(__fmul_rn(factor, gc), 10.0f);
  const float cross = __fadd_rn(__fadd_rn(__fsub_rn(len1, o1), gap), o2);
  const bool same = e1 == e2 && o2 >= __fsub_rn(o1, slack);
  const float direct = fmaxf(__fsub_rn(o2, o1), 0.0f);
  const float route = same ? fminf(direct, cross) : cross;
  float trans = kRouteBig;
  if (route < kRouteBig && route <= limit) {
    trans = __fdiv_rn(fabsf(__fsub_rn(route, gc)), beta);
  }
  return trans;
}

}  // namespace rtt_route
