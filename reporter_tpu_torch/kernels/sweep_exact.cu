// Exact sweep arms for Hopper (sm_90a): per probe point, the top-K distinct
// edges within the search radius.
//
// Replaces two arms of the Pallas TPU kernel of
// reporter_tpu/ops/dense_candidates.py (one pl.pallas_call, :755):
//   block  _sweep_kernel :389-430: every column of every hit block;
//   sub    _sweep_kernel_sub :433-519 with lowp="off" and mxu off: only the
//          128-column slices whose bbox lies within the cull radius of one
//          of a warp's 32 points (the vote; NaN quads never pass).
// The coarse-filter arms are sweep.cu's. The running top-K is topk.cuh's.
//
// Bound on this card: the arithmetic of the swept (point, column) pairs on
// the CUDA cores; the bytes (hit blocks from L2, points, [N, K] outputs)
// are small beside it. The design answers what held the first port of
// these arms back (one CTA per chunk staging each hit block synchronously
// behind two CTA barriers, the column side recomputed per pair, one
// dependent chain per thread):
//
// 1. The column side once per column. seg_sweep (build_seg_pack, numpy
//    f32, one rounding per operation in _block_geometry's order) holds per
//    column (ax, ay, abx, aby), (denom, edge bits), (off0, len). A hit
//    block is one contiguous 16 KB; a pair reads 24 bytes of its column
//    as broadcast loads and does only the point-side chain.
// 2. Asynchronous staging in a ring, no CTA barrier in the loop. One lane
//    of a producer warp walks the CTA's chunks and their hit lists and
//    fills a ring of 4 stages with cp.async.bulk, each stage tracked by a
//    full mbarrier (the copy's bytes) and an empty one (one arrival per
//    consumer warp). Each consumer warp waits only on the stage it needs
//    and releases it when done -- at once if it voted for no slice -- so a
//    warp runs up to 4 blocks ahead of the slowest one and the copies
//    overlap the sweep. The ring runs on across chunks, so the mbarrier
//    parity is that of the CTA's item count.
// 3. Chunks balanced across SMs. A persistent grid (the occupancy times
//    the SM count) takes chunks from an atomic counter, in the order the
//    wrapper gives: descending hit count, heaviest first. A chunk's output
//    rows are its own, so the order changes no result.
// 4. Cheaper pairs, and several in flight. The division is skipped where
//    t clamps anyway: t = clamp(num / denom, 0, 1) with denom >= 1e-12 > 0.
//    If num <= 0 the exact quotient is <= 0 and so is its correctly
//    rounded value (rounding is monotone and 0 is representable): the
//    clamp gives 0. If num >= denom the quotient is >= 1 and clamps to 1.
//    The kernel sets t there without dividing; the clamped quotient could
//    differ only in the sign of a zero, which changes neither dx, dy
//    (squared) nor the value of off0 + t len. A NaN num fails both tests
//    and divides, as before. A warp sweeps kBatch = 4 columns per step as
//    straight-line code (4 independent chains for the scheduler), leaving
//    it only for a division or an in-radius offer, both rare.
//
// Measured on the card against two alternatives (PERF.md), both slower
// and so not kept: two points per thread in the block arm (two chains per
// column load, half the warps; +37%) and reading the columns straight
// from global memory instead of the staged ring (+37% block, +3-6% sub).
// The batch of 4 (80-odd registers, 2 CTAs per SM) was chosen on the card
// over batches of 1, 2 and 8 and over a register cap that fits 3 CTAs per
// SM but spills.
//
// Exactness: built with -fmad=false -prec-div=true -prec-sqrt=true, so
// every operation rounds once, in the plain version's order
// (_dense_plain); the candidates equal it bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "topk.cuh"

namespace {

using rtt::kBig;
using rtt::kK;

constexpr int kP = 256;            // points per chunk (the pre-pass's unit)
constexpr int kSblk = 512;         // columns per block
constexpr int kSub = 128;          // columns per culling slice
constexpr int kNsub = kSblk / kSub;
constexpr int kMaxDevices = 16;
constexpr unsigned kAll = 0xffffffffu;

constexpr int kBatch = 4;          // columns per step of a warp's sweep
constexpr int kCons = kP / 32;     // consumer warps, one point per thread
constexpr int kThreads = 32 * (kCons + 1);  // and the producer warp

// arm codes (ops/dense_candidates.py SWEEP_ARMS order)
constexpr int kBlock = 0, kSubArm = 1;

// one hit block: per column (ax, ay, abx, aby), (denom, edge bits), (off0,
// len); then the block's 4 slice quads (xmin, ymin, xmax, ymax)
struct __align__(16) Stage {
  float4 col[2 * kSblk];
  float4 quad[kNsub];
};
constexpr unsigned kColBytes = sizeof(float4) * 2 * kSblk;
constexpr unsigned kQuadBytes = sizeof(float4) * kNsub;

// dynamic shared memory: the stages, one item word (chunk, slot, block,
// nhits) per stage, the full and the empty mbarriers
constexpr int kDepth = 4;
constexpr int kItemOff = kDepth * int(sizeof(Stage));
constexpr int kBarOff = kItemOff + kDepth * int(sizeof(int4));
constexpr int kSmemBytes = kBarOff + 2 * kDepth * int(sizeof(uint64_t));

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// global -> shared bulk copy (16-byte aligned, a multiple of 16 bytes),
// completing `bytes` of the barrier's expected transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Columns [c0, c1) of one staged block against the thread's point, U =
// kBatch columns at a time. The common path of a column is straight-line
// code: its (ax, ay, abx, aby) and (denom, edge) loads, the numerator, t
// by the clamp shortcut, d^2 and the test; the U chains interleave. Two
// branches per U columns leave it, both rare: the division where
// 0 < num < denom (or num is NaN), and the offers of pairs within the
// radius, which load (off0, len) only then.
__device__ __forceinline__ void sweep_cols(
    const float4* col, int c0, int c1, float px, float py, float r2,
    float (&bd)[kK], int (&be)[kK], float (&bo)[kK]) {
  constexpr int U = kBatch;
  const float2* col2 = reinterpret_cast<const float2*>(col);
  for (int c = c0; c < c1; c += U) {
    float4 g[U];
    float2 h[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      g[u] = col[2 * (c + u)];                 // ax ay abx aby
      h[u] = col2[4 * (c + u) + 2];            // den edge
    }
    float num[U], t[U], d2[U];
    bool divide = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      num[u] = (px - g[u].x) * g[u].z + (py - g[u].y) * g[u].w;
      t[u] = num[u] <= 0.f ? 0.f : 1.f;
      divide |= !(num[u] <= 0.f) && !(num[u] >= h[u].x);
    }
    if (divide) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!(num[u] <= 0.f) && !(num[u] >= h[u].x)) {
          t[u] = fminf(fmaxf(num[u] / h[u].x, 0.f), 1.f);
        }
      }
    }
    bool near = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float dx = px - (g[u].x + t[u] * g[u].z);
      const float dy = py - (g[u].y + t[u] * g[u].w);
      d2[u] = dx * dx + dy * dy;
      near |= __float_as_int(h[u].y) >= 0 && d2[u] <= r2;
    }
    if (near) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = __float_as_int(h[u].y);
        if (e >= 0 && d2[u] <= r2) {
          const float2 ol = col2[4 * (c + u) + 3];     // off0 len
          rtt::offer(d2[u], e, ol.x + t[u] * ol.y, bd, be, bo);
        }
      }
    }
  }
}

template <int ARM>
__device__ void produce(const int* __restrict__ ids,
                        const int* __restrict__ nhits,
                        const int* __restrict__ order, int* next_chunk,
                        const float4* __restrict__ table,
                        const float4* __restrict__ quads, int nchunks,
                        int nblocks, Stage* stage, int4* item,
                        uint64_t* full, uint64_t* empty, int lane) {
  uint32_t it = 0;
  for (;;) {
    int chunk = -1, nh = 0;
    if (lane == 0) {
      const int c = atomicAdd(next_chunk, 1);
      if (c < nchunks) {
        chunk = order[c];
        nh = nhits[chunk];
      }
    }
    chunk = __shfl_sync(kAll, chunk, 0);
    nh = __shfl_sync(kAll, nh, 0);
    // a chunk with no hit block still passes one item (its empty rows);
    // chunk -1 is the last item, which ends the consumers
    const int items = chunk < 0 ? 1 : max(nh, 1);
    for (int j0 = 0; j0 < items; j0 += 32) {
      const int mine = j0 + lane < nh
          ? ids[static_cast<long>(chunk) * nblocks + j0 + lane] : -1;
      const int m = min(32, items - j0);
      for (int jj = 0; jj < m; ++jj, ++it) {
        const int blk = __shfl_sync(kAll, mine, jj);
        if (lane != 0) continue;
        const int s = it % kDepth;
        mbar_wait(empty + s, ((it / kDepth) & 1u) ^ 1u);
        item[s] = make_int4(chunk, j0 + jj, blk, nh);
        if (blk >= 0) {
          mbar_arrive_tx(full + s,
                         kColBytes + (ARM == kSubArm ? kQuadBytes : 0u));
          bulk_load(stage[s].col, table + static_cast<long>(blk) * 2 * kSblk,
                    kColBytes, full + s);
          if (ARM == kSubArm) {
            bulk_load(stage[s].quad, quads + static_cast<long>(blk) * kNsub,
                      kQuadBytes, full + s);
          }
        } else {
          mbar_arrive(full + s);
        }
      }
    }
    if (chunk < 0) return;
  }
}

template <int ARM>
__global__ void __launch_bounds__(kThreads)
sweep_exact_kernel(const float2* __restrict__ pts,   // [nchunks*P]
                   const int* __restrict__ ids,      // [nchunks, nblocks]
                   const int* __restrict__ nhits,    // [nchunks]
                   const int* __restrict__ order,    // [nchunks]
                   int* next_chunk,                  // [1], zeroed
                   const float4* __restrict__ table, // [spad, 2]
                   const float4* __restrict__ quads, // [nblocks, nsub]
                   int nchunks, int nblocks, float r2, float rc2,
                   int* __restrict__ out_edge,       // [nchunks*P, K]
                   float* __restrict__ out_off,
                   float* __restrict__ out_dist,
                   int* __restrict__ gate_log) {     // [nchunks, 8, nblocks]
  extern __shared__ __align__(128) unsigned char smem[];
  Stage* stage = reinterpret_cast<Stage*>(smem);
  int4* item = reinterpret_cast<int4*>(smem + kItemOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kDepth;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDepth; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kCons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == kCons) {
    produce<ARM>(ids, nhits, order, next_chunk, table, quads, nchunks,
                 nblocks, stage, item, full, empty, lane);
    return;
  }

  float px = 0.f, py = 0.f;
  float bd[kK];
  int be[kK];
  float bo[kK];
  for (uint32_t it = 0;; ++it) {
    const int s = it % kDepth;
    mbar_wait(full + s, (it / kDepth) & 1u);
    const int4 h = item[s];                 // (chunk, slot, block, nhits)
    if (h.x < 0) break;
    const long p = static_cast<long>(h.x) * kP + warp * 32 + lane;
    if (h.y == 0) {                         // the chunk's first item
      const float2 pt = pts[p];
      px = pt.x;
      py = pt.y;
      rtt::reset(bd, be, bo);
    }
    if (h.z >= 0) {
      const float4* col = stage[s].col;
      if constexpr (ARM == kBlock) {
        sweep_cols(col, 0, kSblk, px, py, r2, bd, be, bo);
      } else {
        unsigned vote = 0u;
#pragma unroll
        for (int sl = 0; sl < kNsub; ++sl) {
          const float4 qd = stage[s].quad[sl];
          bool near = false;
          if (qd.x <= qd.z && qd.y <= qd.w) {      // false for NaN quads
            const float dx = fmaxf(fmaxf(qd.x - px, px - qd.z), 0.f);
            const float dy = fmaxf(fmaxf(qd.y - py, py - qd.w), 0.f);
            near = dx * dx + dy * dy <= rc2;
          }
          if (__any_sync(kAll, near)) vote |= 1u << sl;
        }
        for (int sl = 0; sl < kNsub; ++sl) {
          if ((vote >> sl) & 1u) {                 // warp-uniform
            sweep_cols(col, sl * kSub, sl * kSub + kSub, px, py, r2, bd, be,
                       bo);
          }
        }
        if (gate_log != nullptr && lane == 0) {
          gate_log[(static_cast<long>(h.x) * kCons + warp) * nblocks + h.y] =
              static_cast<int>(vote | (vote << kNsub));
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // the stage is free again
    if (h.y + 1 < max(h.w, 1)) continue;
    // the chunk's last item: its rows
    float d[kK];
#pragma unroll
    for (int i = 0; i < kK; ++i) {
      d[i] = bd[i] < kBig ? sqrtf(fmaxf(bd[i], 0.f)) : kBig;
    }
    int4* oe = reinterpret_cast<int4*>(out_edge + p * kK);
    float4* oo = reinterpret_cast<float4*>(out_off + p * kK);
    float4* od = reinterpret_cast<float4*>(out_dist + p * kK);
    oe[0] = make_int4(be[0], be[1], be[2], be[3]);
    oe[1] = make_int4(be[4], be[5], be[6], be[7]);
    oo[0] = make_float4(bo[0], bo[1], bo[2], bo[3]);
    oo[1] = make_float4(bo[4], bo[5], bo[6], bo[7]);
    od[0] = make_float4(d[0], d[1], d[2], d[3]);
    od[1] = make_float4(d[4], d[5], d[6], d[7]);
  }
}

// Launch shape of one arm on the current device: threads per CTA,
// dynamic shared memory, resident CTAs per SM and the SM count. The
// shared-memory attribute is set (once per device) before the occupancy
// query and the first launch. Returns a cudaError_t, or -2 / -3.
template <int ARM>
int shape(int* threads, int* smem, int* per_sm, int* sms) {
  static int cached_per_sm[kMaxDevices] = {};
  static int cached_sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return -2;
  if (cached_per_sm[dev] == 0) {
    auto kern = sweep_exact_kernel<ARM>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int n = 0, m = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads,
                                                        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n < 1) return -3;
    cached_sms[dev] = m;
    cached_per_sm[dev] = n;
  }
  *threads = kThreads;
  *smem = kSmemBytes;
  *per_sm = cached_per_sm[dev];
  *sms = cached_sms[dev];
  return 0;
}

template <int ARM>
int launch(const float* pts, const int* ids, const int* nhits,
           const int* order, int* next_chunk, const float* table,
           const float* sub, int nchunks, int nblocks, float r2, float rc2,
           int* out_edge, float* out_off, float* out_dist, int* gate_log,
           cudaStream_t st) {
  int threads, smem, per_sm, sms;
  const int rc = shape<ARM>(&threads, &smem, &per_sm, &sms);
  if (rc != 0) return rc;
  const int grid = nchunks < per_sm * sms ? nchunks : per_sm * sms;
  sweep_exact_kernel<ARM><<<grid, threads, smem, st>>>(
      reinterpret_cast<const float2*>(pts), ids, nhits, order, next_chunk,
      reinterpret_cast<const float4*>(table),
      reinterpret_cast<const float4*>(sub), nchunks, nblocks, r2, rc2,
      out_edge, out_off, out_dist, gate_log);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the exact sweep in arm `arm` (0 block, 1 sub) on `stream`.
// `order` lists the chunks heaviest first and `next_chunk` is a zeroed
// counter the CTAs take chunks from; `table` is seg_sweep [spad, 8];
// `sub` (the slice quads, [nblocks, 16]) is read by the sub arm; gate_log
// (may be null, sub arm) receives per (chunk, warp, hit slot) the slice
// votes (bits 0-3, repeated in 4-7: every voted slice is swept). Returns
// the launch's cudaError_t (0 = ok), -1 for an unknown arm, -2 / -3 for a
// device index or an occupancy out of range.
extern "C" int rtt_sweep_exact(const float* pts, const int* ids,
                               const int* nhits, const int* order,
                               int* next_chunk, const float* table,
                               const float* sub, int arm, int nchunks,
                               int nblocks, float r2, float rc2,
                               int* out_edge, float* out_off,
                               float* out_dist, int* gate_log, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (arm) {
    case kBlock:
      return launch<kBlock>(pts, ids, nhits, order, next_chunk, table, sub,
                            nchunks, nblocks, r2, rc2, out_edge, out_off,
                            out_dist, gate_log, st);
    case kSubArm:
      return launch<kSubArm>(pts, ids, nhits, order, next_chunk, table, sub,
                             nchunks, nblocks, r2, rc2, out_edge, out_off,
                             out_dist, gate_log, st);
    default:
      return -1;
  }
}

// The launch shape of arm `arm` on the current device (see shape()): the
// grid of a launch is min(nchunks, per_sm * sms).
extern "C" int rtt_sweep_exact_shape(int arm, int* threads, int* smem,
                                     int* per_sm, int* sms) {
  switch (arm) {
    case kBlock:
      return shape<kBlock>(threads, smem, per_sm, sms);
    case kSubArm:
      return shape<kSubArm>(threads, smem, per_sm, sms);
    default:
      return -1;
  }
}
