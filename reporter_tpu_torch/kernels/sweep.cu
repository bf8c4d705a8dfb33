// Dense candidate sweep for Hopper (sm_90a), the bf16 coarse-filter arm:
// per probe point, the top-K distinct edges within the search radius.
//
// Replaces one arm of the Pallas TPU kernel of
// reporter_tpu/ops/dense_candidates.py (one pl.pallas_call, :755):
//   sub_bf16  _sweep_kernel_sub :567-614 (bf16 VPU coarse filter)
// The other four arms (block, sub and the tensor-core arms mxu, mxu_bf16)
// are sweep_exact.cu's.
// It computes what the TPU kernel computes, not how: the TPU kernel runs a
// sequential (chunk, block-slot) grid with a [256, K] VMEM scratch merged
// by K masked reductions; here one 256-thread block owns one 256-point
// chunk, each thread owns one point and keeps its running top-K in
// registers, and the block walks only its own compacted hit list
// (ids[chunk, 0:nhits[chunk]]) from the PyTorch cull pre-pass, so culled
// slots cost nothing.
//
// Per hit block the 8 x 512 f32 component rows (ax, ay, bx, by, off, len,
// edge-bits, spare) are staged in shared memory (16 KB); every thread of a
// warp reads the same column at once, a broadcast. Each 128-column slice
// is first tested against its bbox quad: a warp votes to sweep the slice
// only if one of its 32 points lies within the dilated cull radius of the
// quad (a lower bound on every point-to-segment distance in the slice, so
// no in-radius pair is ever skipped). NaN quads (all-padding slices) are
// skipped.
//
// Between the vote and the exact pass sits a warp-uniform gate: the warp
// sweeps the slice exactly only if the minimum of a cheap lower bound over
// its 32 points x the slice's 128 columns passes the JAX kernel's
// threshold. The TPU takes that minimum over the chunk's 256 points; the
// per-warp minimum is tighter and still conservative. The bound: point and
// endpoints recentred on the slice bbox and clamped into it (dilated by
// ~radius), then the point-to-segment d^2 in bf16, every operation rounded
// once in the JAX kernel's order (__h*_rn forms are never contracted). The
// column side (endpoints, direction, denominator) is computed once per
// block into shared memory. Pass: min d2c <= (r + 0.0625 scale + 0.5)^2.
// It runs on the CUDA cores, 17 bf16 operations a pair against ~24 f32
// ones for the exact geometry, so it gains only where it skips most voted
// tiles.
//
// Bound on this card: the arithmetic of the exactly swept (point, column)
// pairs, about 20 f32 operations each, on the CUDA cores, plus the bf16
// filter's pairs on the same cores; the bytes moved (the hit blocks, the
// points, the [N, K] outputs) are small beside it. The design keeps the
// top-K merge off the per-pair path: a pair outside the radius costs only
// its geometry and one compare, and the gate skips whole (warp, slice)
// tiles.
//
// Exactness: built with -fmad=false -prec-div=true -prec-sqrt=true, so
// every operation rounds once, in the reference's order, exactly like the
// plain PyTorch version (_dense_plain); FMA contraction would move d^2 by
// an ulp and flip d = 0 junction ties and radius-boundary points. The gate
// only skips tiles that provably hold no pair within the radius, so the
// arm returns the same candidates as every other, bit for bit. The running
// top-K and its order are topk.cuh's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "topk.cuh"

namespace {

using rtt::kBig;
using rtt::kK;

constexpr int kP = 256;       // points per chunk = threads per block
constexpr int kWarps = kP / 32;
constexpr int kSblk = 512;    // segment columns per block
constexpr int kSub = 128;     // columns per culling slice
constexpr int kNsub = kSblk / kSub;
constexpr int kNcomp = 8;

__device__ __forceinline__ float clampf(float v, float e) {
  return fminf(fmaxf(v, -e), e);       // jnp.clip(v, -e, e)
}

// Column side of the bf16 filter for the block's 512 columns, in the order
// of :584-597: endpoints recentred and clamped in f32, then bf16.
struct Bf16Cols {
  __nv_bfloat16 ax[kSblk], ay[kSblk], abx[kSblk], aby[kSblk], den[kSblk];
};

// The bf16 gate of one slice for this lane's point: its minimum d2c over
// the slice's 128 columns (:598-603, one bf16 rounding per operation).
__device__ float bf16_lane_min(const Bf16Cols& cb, int c0, float px,
                               float py, float cx, float cy, float ex,
                               float ey) {
  const __nv_bfloat16 pxl = __float2bfloat16_rn(clampf(px - cx, ex));
  const __nv_bfloat16 pyl = __float2bfloat16_rn(clampf(py - cy, ey));
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const __nv_bfloat16 one = __float2bfloat16_rn(1.f);
  float mn = __int_as_float(0x7f800000);   // +inf
  for (int c = c0; c < c0 + kSub; ++c) {
    const __nv_bfloat16 axl = cb.ax[c], ayl = cb.ay[c];
    const __nv_bfloat16 abx = cb.abx[c], aby = cb.aby[c];
    const __nv_bfloat16 num = __hadd_rn(__hmul_rn(__hsub_rn(pxl, axl), abx),
                                        __hmul_rn(__hsub_rn(pyl, ayl), aby));
    __nv_bfloat16 t = __hdiv(num, cb.den[c]);
    t = __hmin(__hmax(t, zero), one);
    const __nv_bfloat16 dx = __hsub_rn(pxl, __hadd_rn(axl, __hmul_rn(t, abx)));
    const __nv_bfloat16 dy = __hsub_rn(pyl, __hadd_rn(ayl, __hmul_rn(t, aby)));
    const __nv_bfloat16 d2 = __hadd_rn(__hmul_rn(dx, dx), __hmul_rn(dy, dy));
    mn = fminf(mn, __bfloat162float(d2));
  }
  return mn;
}

__global__ void __launch_bounds__(kP)
sweep_bf16_kernel(const float* __restrict__ pts,    // [nchunks*P, 2]
                  const int* __restrict__ ids,      // [nchunks, nblocks]
                  const int* __restrict__ nhits,    // [nchunks]
                  const float* __restrict__ pack,   // [8, spad]
                  const float* __restrict__ sub,    // [nblocks, nsub*4]
                  int nblocks, int spad, float r2, float rc2, float radius,
                  int* __restrict__ out_edge,       // [nchunks*P, K]
                  float* __restrict__ out_off,
                  float* __restrict__ out_dist,
                  int* __restrict__ gate_log) {     // [nchunks, 8, nblocks]
  __shared__ float seg[kNcomp][kSblk];
  __shared__ float quad[kNsub * 4];
  __shared__ __align__(16) unsigned char cb_raw[sizeof(Bf16Cols)];
  Bf16Cols& cb = *reinterpret_cast<Bf16Cols*>(cb_raw);

  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long p = static_cast<long>(chunk) * kP + tid;
  const float px = pts[2 * p];
  const float py = pts[2 * p + 1];
  const float mx = radius * 1.001f + 0.5f;     // the clamp box's dilation

  float bd[kK];
  int be[kK];
  float bo[kK];
  rtt::reset(bd, be, bo);

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
    if (tid < kNsub * 4) {
      quad[tid] = sub[static_cast<long>(blk) * kNsub * 4 + tid];
    }
    __syncthreads();

    // the warp's vote per slice (bit s)
    unsigned vote = 0u;
#pragma unroll
    for (int s = 0; s < kNsub; ++s) {
      const float lox = quad[4 * s], loy = quad[4 * s + 1];
      const float hix = quad[4 * s + 2], hiy = quad[4 * s + 3];
      bool near = false;
      if (lox <= hix && loy <= hiy) {           // false for NaN quads
        const float dx = fmaxf(fmaxf(lox - px, px - hix), 0.f);
        const float dy = fmaxf(fmaxf(loy - py, py - hiy), 0.f);
        near = dx * dx + dy * dy <= rc2;
      }
      if (__any_sync(0xffffffffu, near)) vote |= 1u << s;
    }
    // column side of the bf16 filter, once per block (two columns a thread)
    for (int c = tid; c < kSblk; c += kP) {
      const int s = c / kSub;
      const float lox = quad[4 * s], loy = quad[4 * s + 1];
      const float hix = quad[4 * s + 2], hiy = quad[4 * s + 3];
      const float cx = (lox + hix) * 0.5f, cy = (loy + hiy) * 0.5f;
      const float ex = (hix - lox) * 0.5f + mx, ey = (hiy - loy) * 0.5f + mx;
      const __nv_bfloat16 axl = __float2bfloat16_rn(clampf(seg[0][c] - cx, ex));
      const __nv_bfloat16 ayl = __float2bfloat16_rn(clampf(seg[1][c] - cy, ey));
      const __nv_bfloat16 bxl = __float2bfloat16_rn(clampf(seg[2][c] - cx, ex));
      const __nv_bfloat16 byl = __float2bfloat16_rn(clampf(seg[3][c] - cy, ey));
      const __nv_bfloat16 abx = __hsub_rn(bxl, axl);
      const __nv_bfloat16 aby = __hsub_rn(byl, ayl);
      cb.ax[c] = axl; cb.ay[c] = ayl; cb.abx[c] = abx; cb.aby[c] = aby;
      cb.den[c] = __hmax(__hadd_rn(__hmul_rn(abx, abx), __hmul_rn(aby, aby)),
                         __float2bfloat16_rn(1e-12f));
    }
    __syncthreads();

    unsigned gated = 0u;
    for (int s = 0; s < kNsub; ++s) {
      if (!((vote >> s) & 1u)) continue;            // warp-uniform
      const int c0 = s * kSub;
      const int c1 = c0 + kSub;
      const float lox = quad[4 * s], loy = quad[4 * s + 1];
      const float hix = quad[4 * s + 2], hiy = quad[4 * s + 3];
      const float ex = (hix - lox) * 0.5f + mx, ey = (hiy - loy) * 0.5f + mx;
      const float scale = fmaxf(ex, ey);
      const float cx = (lox + hix) * 0.5f, cy = (loy + hiy) * 0.5f;
      const float rl = radius + scale * 0.0625f + 0.5f;
      const float mn = bf16_lane_min(cb, c0, px, py, cx, cy, ex, ey);
      if (!__any_sync(0xffffffffu, mn <= rl * rl)) continue;
      gated |= 1u << s;
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
          rtt::offer(d2, e, seg[4][c] + t * seg[5][c], bd, be, bo);
        }
      }
    }
    if (gate_log != nullptr && lane == 0) {
      gate_log[(static_cast<long>(chunk) * kWarps + warp) * nblocks + j] =
          static_cast<int>(vote | (gated << kNsub));
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

// Launches the bf16 filter arm (sub_bf16) over `nchunks` chunks on
// `stream`; returns the launch's cudaError_t (0 = ok). gate_log (may be
// null) receives per (chunk, warp, hit slot) the slice votes (bits 0-3)
// and the slices swept exactly (4-7).
extern "C" int rtt_sweep_bf16(const float* pts, const int* ids,
                              const int* nhits, const float* pack,
                              const float* sub, int nchunks, int nblocks,
                              int spad, float r2, float rc2, float radius,
                              int* out_edge, float* out_off, float* out_dist,
                              int* gate_log, void* stream) {
  sweep_bf16_kernel<<<nchunks, kP, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, ids, nhits, pack, sub, nblocks, spad, r2, rc2, radius, out_edge,
      out_off, out_dist, gate_log);
  return static_cast<int>(cudaGetLastError());
}
