// The running top-K of one probe point, held in registers, shared by the
// five arms of the sweep kernel (sweep_exact.cu). K, the list's width, is a
// template parameter: every arm is instantiated at each K of SWEEP_KS
// (ops/dense_candidates.py).
//
// Order: (d^2 ascending, edge id ascending). An edge already held keeps its
// smallest d^2 and, at equal d^2, its smallest projection offset -- the
// same answer as the reference's repeated _select_topk merge. Empty slots:
// edge -1, offset 0, d^2 kBig.

#pragma once

namespace rtt {

constexpr float kBig = 1e30f;

__device__ __forceinline__ bool before(float d1, int e1, float d2, int e2) {
  return d1 < d2 || (d1 == d2 && e1 < e2);
}

// One pass from the bottom restores the order after the bottom slot was
// replaced, or after a held slot's d^2 decreased (it can only move up).
template <int K>
__device__ __forceinline__ void bubble(float (&bd)[K], int (&be)[K],
                                       float (&bo)[K]) {
#pragma unroll
  for (int i = K - 1; i > 0; --i) {
    if (before(bd[i], be[i], bd[i - 1], be[i - 1])) {
      float td = bd[i]; bd[i] = bd[i - 1]; bd[i - 1] = td;
      int te = be[i]; be[i] = be[i - 1]; be[i - 1] = te;
      float to = bo[i]; bo[i] = bo[i - 1]; bo[i - 1] = to;
    }
  }
}

template <int K>
__device__ __forceinline__ void offer(float d, int e, float o,
                                      float (&bd)[K], int (&be)[K],
                                      float (&bo)[K]) {
  bool held = false;
  bool moved = false;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (be[i] == e) {
      held = true;
      if (d < bd[i]) {
        bd[i] = d; bo[i] = o; moved = true;
      } else if (d == bd[i] && o < bo[i]) {
        bo[i] = o;
      }
    }
  }
  if (held) {
    if (moved) bubble(bd, be, bo);
    return;
  }
  if (!before(d, e, bd[K - 1], be[K - 1])) return;
  bd[K - 1] = d; be[K - 1] = e; bo[K - 1] = o;
  bubble(bd, be, bo);
}

template <int K>
__device__ __forceinline__ void reset(float (&bd)[K], int (&be)[K],
                                      float (&bo)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) { bd[i] = kBig; be[i] = -1; bo[i] = 0.f; }
}

}  // namespace rtt
