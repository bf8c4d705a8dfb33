// Dense candidate sweep for Hopper (sm_90a): per probe point, the top-K
// distinct edges within the search radius.
//
// Replaces the Pallas TPU kernels of reporter_tpu/ops/dense_candidates.py:
//   _sweep_kernel      (whole-block arm)  -> SUBCULL = false
//   _sweep_kernel_sub  (exact two-level arm, lowp="off", mxu=False)
//                                         -> SUBCULL = true
// It computes what they compute, not how: the TPU kernel runs a sequential
// (chunk, block-slot) grid with a [256, K] VMEM scratch merged by K masked
// reductions; here one 256-thread block owns one 256-point chunk, each
// thread owns one point and keeps its running top-K in registers, and the
// block walks only its own compacted hit list (ids[chunk, 0:nhits[chunk]])
// from the PyTorch cull pre-pass, so culled slots cost nothing.
//
// Per hit block the 8 x 512 f32 component rows (ax, ay, bx, by, off, len,
// edge-bits, spare) are staged in shared memory (16 KB); every thread of a
// warp reads the same column at once, a broadcast. With SUBCULL each
// 128-column slice is first tested against its bbox quad: a warp sweeps
// the slice only if one of its 32 points lies within the dilated cull
// radius of the quad (a lower bound on every point-to-segment distance in
// the slice, so no in-radius pair is ever skipped). NaN quads (all-padding
// slices) are skipped.
//
// Bound on this card: the arithmetic of the swept (point, column) pairs,
// about 20 f32 operations each, on the CUDA cores (no tensor-core form of
// the exact geometry); the bytes moved (the hit blocks, the points, the
// [N, K] outputs) are small beside it. The design keeps the top-K merge off
// the per-pair path: a pair outside the radius costs only its geometry and
// one compare.
//
// Exactness: built with -fmad=false -prec-div=true -prec-sqrt=true, so
// every operation rounds once, in the reference's order, exactly like the
// plain PyTorch version (_dense_plain); FMA contraction would move d^2 by
// an ulp and flip d = 0 junction ties and radius-boundary points.
//
// Top-K order: (d^2 ascending, edge id ascending). An edge already held
// keeps its smallest d^2 and, at equal d^2, its smallest projection
// offset -- the same answer as the reference's repeated _select_topk
// merge. Empty slots: edge -1, offset 0, dist BIG.

#include <cuda_runtime.h>

namespace {

constexpr int kP = 256;       // points per chunk = threads per block
constexpr int kSblk = 512;    // segment columns per block
constexpr int kSub = 128;     // columns per culling slice
constexpr int kNsub = kSblk / kSub;
constexpr int kNcomp = 8;
constexpr int kK = 8;         // top-K width
constexpr float kBig = 1e30f;

__device__ __forceinline__ bool before(float d1, int e1, float d2, int e2) {
  return d1 < d2 || (d1 == d2 && e1 < e2);
}

// One pass from the bottom restores the order after the bottom slot was
// replaced, or after a held slot's d^2 decreased (it can only move up).
__device__ __forceinline__ void bubble(float (&bd)[kK], int (&be)[kK],
                                       float (&bo)[kK]) {
#pragma unroll
  for (int i = kK - 1; i > 0; --i) {
    if (before(bd[i], be[i], bd[i - 1], be[i - 1])) {
      float td = bd[i]; bd[i] = bd[i - 1]; bd[i - 1] = td;
      int te = be[i]; be[i] = be[i - 1]; be[i - 1] = te;
      float to = bo[i]; bo[i] = bo[i - 1]; bo[i - 1] = to;
    }
  }
}

__device__ __forceinline__ void offer(float d, int e, float o,
                                      float (&bd)[kK], int (&be)[kK],
                                      float (&bo)[kK]) {
  bool held = false;
  bool moved = false;
#pragma unroll
  for (int i = 0; i < kK; ++i) {
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
  if (!before(d, e, bd[kK - 1], be[kK - 1])) return;
  bd[kK - 1] = d; be[kK - 1] = e; bo[kK - 1] = o;
  bubble(bd, be, bo);
}

template <bool SUBCULL>
__global__ void __launch_bounds__(kP)
sweep_topk_kernel(const float* __restrict__ pts,    // [nchunks*P, 2]
                  const int* __restrict__ ids,      // [nchunks, nblocks]
                  const int* __restrict__ nhits,    // [nchunks]
                  const float* __restrict__ pack,   // [8, spad]
                  const float* __restrict__ sub,    // [nblocks, nsub*4]
                  int nblocks, int spad, float r2, float rc2,
                  int* __restrict__ out_edge,       // [nchunks*P, K]
                  float* __restrict__ out_off,
                  float* __restrict__ out_dist) {
  __shared__ float seg[kNcomp][kSblk];
  __shared__ float quad[kNsub * 4];

  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const long p = static_cast<long>(chunk) * kP + tid;
  const float px = pts[2 * p];
  const float py = pts[2 * p + 1];

  float bd[kK];
  int be[kK];
  float bo[kK];
#pragma unroll
  for (int i = 0; i < kK; ++i) { bd[i] = kBig; be[i] = -1; bo[i] = 0.f; }

  const int nh = nhits[chunk];
  for (int j = 0; j < nh; ++j) {
    const int blk = ids[static_cast<long>(chunk) * nblocks + j];
    __syncthreads();                    // the previous block's reads are done
    const float* src = pack + static_cast<long>(blk) * kSblk;
    for (int i = tid; i < kNcomp * kSblk; i += kP) {
      const int c = i / kSblk;
      const int col = i - c * kSblk;
      seg[c][col] = src[static_cast<long>(c) * spad + col];
    }
    if (SUBCULL && tid < kNsub * 4) {
      quad[tid] = sub[static_cast<long>(blk) * kNsub * 4 + tid];
    }
    __syncthreads();

    for (int s = 0; s < (SUBCULL ? kNsub : 1); ++s) {
      const int c0 = SUBCULL ? s * kSub : 0;
      const int c1 = SUBCULL ? c0 + kSub : kSblk;
      if (SUBCULL) {
        const float lox = quad[4 * s], loy = quad[4 * s + 1];
        const float hix = quad[4 * s + 2], hiy = quad[4 * s + 3];
        bool near = false;
        if (lox <= hix && loy <= hiy) {           // false for NaN quads
          const float dx = fmaxf(fmaxf(lox - px, px - hix), 0.f);
          const float dy = fmaxf(fmaxf(loy - py, py - hiy), 0.f);
          near = dx * dx + dy * dy <= rc2;
        }
        if (!__any_sync(0xffffffffu, near)) continue;   // warp-uniform
      }
      for (int c = c0; c < c1; ++c) {
        const int e = __float_as_int(seg[6][c]);
        const float ax = seg[0][c], ay = seg[1][c];
        const float abx = seg[2][c] - ax;
        const float aby = seg[3][c] - ay;
        const float denom = fmaxf(abx * abx + aby * aby, 1e-12f);
        float t = ((px - ax) * abx + (py - ay) * aby) / denom;
        t = fminf(fmaxf(t, 0.f), 1.f);
        const float dx = px - (ax + t * abx);
        const float dy = py - (ay + t * aby);
        const float d2 = dx * dx + dy * dy;
        if (e >= 0 && d2 <= r2) {
          offer(d2, e, seg[4][c] + t * seg[5][c], bd, be, bo);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kK; ++i) {
    const long o = p * kK + i;
    out_edge[o] = be[i];
    out_off[o] = bo[i];
    out_dist[o] = bd[i] < kBig ? sqrtf(fmaxf(bd[i], 0.f)) : kBig;
  }
}

}  // namespace

// Launches one arm on `stream`; returns the launch's cudaError_t (0 = ok).
// sub == nullptr selects the whole-block arm.
extern "C" int rtt_sweep_topk(const float* pts, const int* ids,
                              const int* nhits, const float* pack,
                              const float* sub, int nchunks, int nblocks,
                              int spad, float r2, float rc2, int* out_edge,
                              float* out_off, float* out_dist,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sub != nullptr) {
    sweep_topk_kernel<true><<<nchunks, kP, 0, st>>>(
        pts, ids, nhits, pack, sub, nblocks, spad, r2, rc2, out_edge,
        out_off, out_dist);
  } else {
    sweep_topk_kernel<false><<<nchunks, kP, 0, st>>>(
        pts, ids, nhits, pack, sub, nblocks, spad, r2, rc2, out_edge,
        out_off, out_dist);
  }
  return static_cast<int>(cudaGetLastError());
}
