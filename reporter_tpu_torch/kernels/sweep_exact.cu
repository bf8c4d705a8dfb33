// Ring-fed sweep arms for Hopper (sm_90a): per probe point, the top-K
// distinct edges within the search radius.
//
// Replaces the five arms of the Pallas TPU kernel of
// reporter_tpu/ops/dense_candidates.py (one pl.pallas_call, :755):
//   block     _sweep_kernel :389-430: every column of every hit block;
//   sub       _sweep_kernel_sub :433-519 with lowp="off" and mxu off: only
//             the 128-column slices whose bbox lies within the cull radius
//             of one of a warp's 32 points (the vote; NaN quads never pass);
//   sub_bf16  _sweep_kernel_sub's bf16 VPU filter :567-614: between the
//             vote and the exact pass of a slice, a gate on a bf16
//             point-to-segment lower bound;
//   mxu       _sweep_kernel_sub's MXU coarse pass :521-564 (f32 operands;
//             here tf32 tensor-core operands): the same place, a gate on
//             the tensor cores;
//   mxu_bf16  the same with bf16 operands (:549-551).
// Each arm is an instance of sweep_exact_kernel<ARM, K>, ARM its index in
// ops/dense_candidates.py's SWEEP_ARMS and K the top-K width. One nvcc of
// this file with -DRTT_SWEEP_K=K builds the five arms at that K into one
// library; kernels/build.py builds one library per K of SWEEP_KS and the
// wide library (-DRTT_SWEEP_K=0: sweep_exact_kernel<ARM, 0>, the top-K
// width a run-time argument), all started together. The running top-K is
// topk.cuh's: a RegList<K> in registers, or in the wide instance a
// WideList in a slot-major global scratch.
//
// Bound on this card: the arithmetic of the exactly swept (point, column)
// pairs on the CUDA cores, plus for sub_bf16 its gate's bf16 pairs on the
// same cores; the bytes (hit blocks from L2, points, [N, K] outputs) are
// small beside it, and so are the tensor-core gate's products (72.6 M
// pairs x 16 operations at sf's full size, ~2 us at the tf32 rate). The
// design answers what held the first port of these arms back (one CTA
// per chunk staging each hit block synchronously behind CTA barriers, the
// column side recomputed per pair, one dependent chain per thread; for
// the gated arms more barriers per block, the gate's column side or
// operands converted per block in every CTA, and the gate's whole
// 32 x 128 minimum taken even where its first pairs pass):
//
// 1. The column side once per column. seg_sweep (build_seg_pack, numpy
//    f32, one rounding per operation in _block_geometry's order) holds per
//    column (ax, ay, abx, aby), (denom, edge bits), (off0, len). A hit
//    block is one contiguous 16 KB; a pair reads 24 bytes of its column
//    as broadcast loads and does only the point-side chain.
// 2. Asynchronous staging in a ring, no CTA barrier in the loop. One lane
//    of a producer warp walks the CTA's chunks and their hit lists and
//    fills a ring of kDepth stages with cp.async.bulk, each stage tracked
//    by a full mbarrier (the copies' bytes) and an empty one (one arrival
//    per consumer warp). Each consumer warp waits only on the stage it
//    needs and releases it when done -- at once if it voted for no slice
//    -- so a warp runs up to kDepth blocks ahead of the slowest one and
//    the copies overlap the sweep. The ring runs on across chunks, so the
//    mbarrier parity is that of the CTA's item count.
// 3. Chunks balanced across SMs. A persistent grid (the occupancy times
//    the SM count) takes chunks from an atomic counter, heaviest first: in
//    _chunk_order's order (a stable sort by descending hit count), which
//    chunk_order_kernel computes on the card just before, in the same
//    call, with the counter's zero. A chunk's output rows are its own, so
//    the order changes no result.
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
// 5. The gate's operands fed from registers and rounded once. seg_coarse
//    (build_seg_pack, numpy) holds seg_feat's eight coefficient rows per
//    column already rounded to each arm's operand type (tf32 by cvt.rna's
//    round-to-nearest-ties-away, bf16 to nearest even) and laid out so a
//    lane's B fragment of an m16n8k8 is one 8-byte (tf32: k = t, t+4) or
//    4-byte (bf16: k = 2t, 2t+1) shared load, and the slices' centres (the
//    rows SF_CX/SF_CY at each slice's first column, which the JAX kernel
//    reads and never recomputes) beside them; an arm's piece of a block is
//    one contiguous copy into the stage. The A fragments need no shared
//    tile: a lane takes the recentred, clamped (qx, qy) of its fragment
//    rows' points (rows mt*16 + g and + 8) by __shfl_sync and computes
//    their features (qx^2, qy^2, qx qy, qx, qy, 1, 0, 0) with the same f32
//    operations, so the same values, converted once per slice. The n-tile
//    loop is outside the m-tile loop, so each B fragment is loaded once
//    and feeds both m-tiles. Warp-level mma.sync, not wgmma: the gate is a
//    decision per warp (32 points), and a warpgroup product would tie four
//    warps together again, undoing 2; the products are microseconds of the
//    tensor cores' time in any case.
// 6. The gate stops at the first admitting group. It asks whether min
//    over the 32 x 128 pair values (products d2m, or the bf16 filter's
//    d2c) <= thr, which holds exactly when some value is <= thr: the least
//    element of a finite set of reals is <= thr iff one of them is. A NaN
//    compares false in both forms (fminf drops it from the minimum; the
//    test of it fails), so it admits neither. After every group of
//    columns (kGroup n-tiles, or kBf16Group columns) the warp asks
//    __any_sync whether a lane holds a value <= thr and stops at the
//    first yes: the same predicate over the same values, so the same
//    decision (bits 8-11 of the gate log record the slices whose gate
//    passed in the first group). The loop is warp-uniform (a voted slice
//    is), so every lane reaches every __any_sync. kGroup = 4 (32 columns,
//    8 mma): on sf nearly every voted gate passes in its first group, and
//    groups of 1, 2 or 8 n-tiles ran no faster in a development run on
//    the card.
// 7. The bf16 filter's column side rounded once, its pairs two at a time.
//    seg_coarse's CO_FLT words (build_seg_pack, numpy) hold per column
//    the endpoint recentred on the slice centre (axl, ayl), the
//    differences abx, aby and den = max(abx^2 + aby^2, bf16(1e-12)), each
//    rounded once to bf16, columns 2p and 2p + 1 in the halves of one
//    word per field, so four words (8 columns) of a field are one
//    broadcast 16-byte load. The JAX kernel first clamps the endpoints
//    into the slice box dilated by ~radius; a real column's endpoints lie
//    in that box (the host checks it at radius 0), so its table entry
//    holds at every radius. A padding column's zero endpoints do clamp,
//    to a point of the radius: the table counts each slice's real
//    columns, and from there on the kernel puts in the clamp of (0, 0),
//    computed once per slice (a padding column still enters the minimum,
//    as in the plain gate). The point side is the f32 recentre and clamp
//    of the JAX kernel, converted once per slice. The pair chain runs on
//    __nv_bfloat162, two columns per instruction, with the _rn forms (one
//    rounding each, never contracted) in the plain version's order. t
//    takes 4.'s shortcut, which holds in bf16 as well (den > 0, rounding
//    is monotone, and __hdiv is f32 division rounded to bf16, a correctly
//    rounded quotient): __hgt2(num, 0) is t wherever num <= 0 or num >=
//    den. Where some pair of a lane's 8-column step has neither (or a
//    NaN num), the lane divides both halves of each word with __hdiv and
//    clamps, the first port's operations, and a mask keeps each quotient
//    only where its pair needs it: straight-line code, where a branch
//    per column diverged. (An approximate reciprocal instead of __hdiv
//    is not exact: a development run on the card found bf16 pairs where
//    it differs.) A lane keeps the running minimum of its d2c (__hmin2,
//    which drops a NaN as fminf does) and tests it once a group, the
//    predicate of 6.
//
// Ring depth and occupancy per arm: a stage holds the block's seg_sweep
// columns (16,384 B) and slice quads (64 B), plus for mxu the tf32 rows and
// centres (16,416 B), for mxu_bf16 the centres and bf16 rows (8,224 B) and
// for sub_bf16 the filter's column side (5,136 B). kDepth is 4 for block,
// sub, mxu_bf16 and sub_bf16 and 3 for mxu: at most about 99 KB for the
// gated arms, so two CTAs fit on an SM by shared memory (four tf32 stages
// would be ~131 KB, one CTA). In a development run on the card these
// depths beat 2 and 4 stages for mxu and 3 and 5 for mxu_bf16: a depth
// that leaves one CTA per SM was clearly slower, and two tf32 stages
// starved the warps. For sub_bf16 a development run on the card measured
// depths 3-5 and gate groups of 8-64 columns (PERF.md): 4 stages and
// groups of 8 were kept. chip_smoke.py prints each arm's depth, gate
// group, shared memory, CTAs per SM and grid.
//
// The top-K width K sizes each consumer thread's running list (3 K
// registers) and its output store (16-byte stores where K is a multiple of
// 4, else 8-byte ones). Registers grow with K: at K = 16 every arm takes
// 108-122 and one CTA fits an SM; at K = 4 and 6 the exact arms take 66-72
// and three fit. ptxas reports small spills (16-40 bytes) in some arms at
// K = 4, 6 and 12 and none at K = 8 or 16; chip_smoke.py prints the
// figures and PERF.md keeps them.
//
// The wide instance (K = 0 here) serves every K past the largest register
// width, where the list does not fit the registers: its list lives in a
// scratch [3][K][npad] that the wrapper allocates (topk.cuh's WideList),
// with the K-th slot's (d^2, edge) in registers as the admission bound, so
// an in-radius pair that cannot enter costs no memory access; a pair that
// can scans the point's filled slots (coalesced across the warp) and moves
// its entry up. The chunk's rows are written from the scratch at its last
// item, one value at a time (any K). Everything else -- the ring, the
// producer, the votes, the gates, sweep_cols -- is the register
// instances'. Its cost is the scratch's traffic, which the bound does not
// count; a list in shared memory is queued in ROADMAP queue 2.
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
// (_dense_plain); the candidates equal it bit for bit in every arm. The
// gates only skip slices where no value of their lower bound on every
// point-to-segment distance comes within the JAX kernel's conservative
// margin. The bf16 filter's decisions equal the plain gate's
// (_coarse_bf16_gate) exactly; the tensor-core gates' differ from the
// plain f32 product (_coarse_mxu_gate) only where the tensor cores'
// summation order moves the minimum across the threshold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "topk.cuh"

#ifndef RTT_SWEEP_K
#error "build with -DRTT_SWEEP_K=<top-K width> (kernels/build.py does)"
#endif

namespace {

using rtt::kBig;

constexpr int kK = RTT_SWEEP_K;    // the top-K width of this library
constexpr int kWide = 0;           // K of the wide instance (K at run time)
static_assert(kK == kWide || (kK >= 1 && kK <= 16),
              "a register list holds 1-16 slots; past that the wide "
              "instance (RTT_SWEEP_K=0) serves");

constexpr int kP = 256;            // points per chunk (the pre-pass's unit)
constexpr int kSblk = 512;         // columns per block
constexpr int kSub = 128;          // columns per culling slice
constexpr int kNsub = kSblk / kSub;
constexpr int kMaxDevices = 16;
constexpr unsigned kAll = 0xffffffffu;

constexpr int kBatch = 4;          // columns per step of a warp's sweep
constexpr int kGroup = 4;          // n-tiles (8 columns each) per gate test
constexpr int kBf16Group = 8;      // columns per gate test of the bf16 filter
constexpr int kCons = kP / 32;     // consumer warps, one point per thread
constexpr int kThreads = 32 * (kCons + 1);  // and the producer warp
constexpr int kOrderThreads = 256;
static_assert(kBf16Group % 8 == 0 && kSub % kBf16Group == 0,
              "the filter tests whole 8-column steps of a slice");

// arm codes (ops/dense_candidates.py SWEEP_ARMS order)
constexpr int kBlock = 0, kSubArm = 1, kSubBf16 = 2, kMxu = 3, kMxuBf16 = 4;

template <int ARM>
constexpr bool kGated = ARM >= kSubBf16;

// columns per early-exit test of an arm's gate (0: no gate); rtt_sweep_
// exact_shape reports it, so that chip_smoke.py counts the gate's pairs
template <int ARM>
constexpr int kGateCols =
    ARM == kSubBf16 ? kBf16Group : kGated<ARM> ? 8 * kGroup : 0;

// seg_coarse, one row of kCoWords i32 words per block (CO_* in
// ops/dense_candidates.py): column c's tf32 rows at words 8c..8c+7 in k
// order 0,4,1,5,2,6,3,7; the 4 slices' centres (cx, cy) at kCoCtr; column
// c's bf16 rows at kCoBf16 + 4c..+3, word t holding k = 2t (low half) and
// 2t + 1; at kCoFlt the 4 slices' real column counts, then the bf16
// filter's fields (ax, ay, abx, aby, den), field f of columns 2p, 2p + 1
// (low, high half) at kCoFlt + kFlCols + f * kFlPairs + p. The mxu arm
// stages words [0, kCoBf16), mxu_bf16 [kCoCtr, kCoFlt), sub_bf16
// [kCoFlt, kCoWords): each one contiguous piece.
constexpr int kCoCtr = 8 * kSblk;
constexpr int kCoBf16 = kCoCtr + 2 * kNsub;
constexpr int kCoFlt = kCoBf16 + 4 * kSblk;
constexpr int kFlCols = kNsub;
constexpr int kFlPairs = kSblk / 2;
constexpr int kCoWords = kCoFlt + kFlCols + 5 * kFlPairs;

// one hit block in a stage: per column (ax, ay, abx, aby), (denom, edge
// bits), (off0, len); then the block's 4 slice quads (xmin, ymin, xmax,
// ymax); then, for a gated arm, its piece of the block's seg_coarse row
constexpr unsigned kColBytes = sizeof(float4) * 2 * kSblk;
constexpr unsigned kQuadBytes = sizeof(float4) * kNsub;

template <int ARM>
struct Ring {
  static constexpr int kCoFirst =                  // table words staged
      ARM == kMxu ? 0 : ARM == kSubBf16 ? kCoFlt : kCoCtr;
  static constexpr int kCoEnd =
      ARM == kMxu ? kCoBf16 : ARM == kMxuBf16 ? kCoFlt : kCoWords;
  static constexpr unsigned kCoBytes =
      kGated<ARM> ? 4u * (kCoEnd - kCoFirst) : 0u;
  static constexpr unsigned kStage = kColBytes + kQuadBytes + kCoBytes;
  static constexpr int kDepth =
      ARM == kMxu ? 3 : 4;
  // dynamic shared memory: the stages, one item word (chunk, slot, block,
  // nhits) per stage, the full and the empty mbarriers
  static constexpr int kItemOff = kDepth * int(kStage);
  static constexpr int kBarOff = kItemOff + kDepth * int(sizeof(int4));
  static constexpr int kSmem = kBarOff + 2 * kDepth * int(sizeof(uint64_t));
  static_assert(kStage % 16 == 0 && kCoBytes % 16 == 0 &&
                (4 * kCoFirst) % 16 == 0 && (4 * kCoWords) % 16 == 0,
                "bulk copies need 16-byte sizes and addresses");
};

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
template <class List>
__device__ __forceinline__ void sweep_cols(
    const float4* col, int c0, int c1, float px, float py, float r2,
    List& list) {
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
          list.offer(d2[u], e, ol.x + t[u] * ol.y);
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits(int x) {
  return static_cast<uint32_t>(x);
}

// One point's K output values at `out` (row p of an [n, K] array): 16-byte
// stores where K is a multiple of 4 (the row then starts 16-byte aligned),
// 8-byte stores where K is even, else one value at a time.
template <int K, typename T>
__device__ __forceinline__ void store_row(T* out, const T (&v)[K]) {
  if constexpr (K % 4 == 0) {
    uint4* o = reinterpret_cast<uint4*>(out);
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      o[i] = make_uint4(bits(v[4 * i]), bits(v[4 * i + 1]),
                        bits(v[4 * i + 2]), bits(v[4 * i + 3]));
    }
  } else if constexpr (K % 2 == 0) {
    uint2* o = reinterpret_cast<uint2*>(out);
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      o[i] = make_uint2(bits(v[2 * i]), bits(v[2 * i + 1]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) out[i] = v[i];
  }
}

// The chunk's last item: point p's row of the outputs from its list.
template <int K>
__device__ __forceinline__ void store_list(const rtt::RegList<K>& l, long p,
                                           int* out_edge, float* out_off,
                                           float* out_dist, int squared) {
  float d[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    d[i] = l.bd[i] < kBig ? (squared ? l.bd[i] : sqrtf(fmaxf(l.bd[i], 0.f)))
                          : kBig;
  }
  store_row<K>(out_edge + p * K, l.be);
  store_row<K>(out_off + p * K, l.bo);
  store_row<K>(out_dist + p * K, d);
}

__device__ __forceinline__ void store_list(const rtt::WideList& l, long p,
                                           int* out_edge, float* out_off,
                                           float* out_dist, int squared) {
  const long row = p * l.k;
  for (int i = 0; i < l.k; ++i) {
    float d = kBig, o = 0.f;
    int e = -1;
    if (i < l.n) {
      d = l.d[i * l.s];
      e = l.e[i * l.s];
      o = l.o[i * l.s];
    }
    out_edge[row + i] = e;
    out_off[row + i] = o;
    out_dist[row + i] =
        d < kBig ? (squared ? d : sqrtf(fmaxf(d, 0.f))) : kBig;
  }
}

template <int K>
struct ListOf { using type = rtt::RegList<K>; };
template <>
struct ListOf<kWide> { using type = rtt::WideList; };

__device__ __forceinline__ float clampf(float v, float e) {
  return fminf(fmaxf(v, -e), e);       // jnp.clip(v, -e, e)
}

// The point features of (x, y) in SF_* order, x^2, y^2, x y, x, y, 1, 0,
// 0, that lane t's A fragment holds: tf32 k = t and t + 4 (lo, hi), bf16
// k = 2t and 2t + 1. One product each, the same f32 operation as the
// plain version's (a product commutes bit for bit).
template <bool BF16>
__device__ __forceinline__ float2 features(int t, float x, float y) {
  if constexpr (BF16) {
    const float lo = t == 0 ? x * x : t == 1 ? x * y : t == 2 ? y : 0.f;
    const float hi = t == 0 ? y * y : t == 1 ? x : t == 2 ? 1.f : 0.f;
    return make_float2(lo, hi);
  } else {
    const float u = t == 1 ? y : x, v = t == 0 ? x : y;
    return make_float2(t == 3 ? x : u * v,
                       t == 0 ? y : t == 1 ? 1.f : 0.f);
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// two bf16 operands in one register, the lower k index in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// The tensor-core gate of voted slice `sl` for this warp (the JAX kernel's
// :534-562): the points recentred on the slice centre and clamped into the
// slice box dilated by ~radius, features [32, 8] x the slice's coarse rows
// [8, 128] as 2 (m16) x 16 (n8) mma.sync.m16n8k8 products, f32
// accumulation; every product is a pair's point-to-line d^2. Fragment
// layouts (PTX ISA, "Matrix Fragments for mma.m16n8k8", g = lane / 4 the
// row / column, t = lane % 4): tf32 A a0..a3 at (g, t), (g+8, t),
// (g, t+4), (g+8, t+4) and B b0, b1 at k = t, t+4; bf16 A a0, a1 at rows
// g, g+8 holding k = 2t, 2t+1 and B at k = 2t, 2t+1; C c0..c3 at rows g,
// g, g+8, g+8. Returns the n-tile group after which some product was
// <= thr = r^2 + scale^2 / 16 + 0.5 (the slice passes), or -1 (culled).
template <int ARM>
__device__ __forceinline__ int mma_gate(const uint32_t* co, float4 qd,
                                        int sl, float px, float py,
                                        float r2, float mx, int lane) {
  constexpr bool kBf16 = ARM == kMxuBf16;
  constexpr int kFirst = Ring<ARM>::kCoFirst;
  const int g = lane >> 2, t = lane & 3;
  const float2 ctr =
      reinterpret_cast<const float2*>(co + (kCoCtr - kFirst))[sl];
  const float ex = (qd.z - qd.x) * 0.5f + mx;
  const float ey = (qd.w - qd.y) * 0.5f + mx;
  const float scale = fmaxf(ex, ey);
  const float thr = r2 + scale * scale * 0.0625f + 0.5f;
  const float qx = clampf(px - ctr.x, ex);
  const float qy = clampf(py - ctr.y, ey);
  uint32_t a[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {            // rows mt*16 + g, + 8
      const int src = mt * 16 + h * 8 + g;
      const float2 f = features<kBf16>(t, __shfl_sync(kAll, qx, src),
                                       __shfl_sync(kAll, qy, src));
      if constexpr (kBf16) {
        a[mt][h] = bf16x2(f.x, f.y);
      } else {
        a[mt][h] = tf32(f.x);
        a[mt][h + 2] = tf32(f.y);
      }
    }
  }
  for (int n0 = 0; n0 < kSub / 8; n0 += kGroup) {
    bool hit = false;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int c = sl * kSub + (n0 + j) * 8 + g;    // B fragment's column
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float d0, d1, d2, d3;
        if constexpr (kBf16) {
          const uint32_t b = co[kCoBf16 - kFirst + 4 * c + t];
          asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%7,%7,%7};\n"
              : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
              : "r"(a[mt][0]), "r"(a[mt][1]), "r"(b), "f"(0.f));
        } else {
          const uint2 b = *reinterpret_cast<const uint2*>(co + 8 * c + 2 * t);
          asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
              : "=f"(d0), "=f"(d1), "=f"(d2), "=f"(d3)
              : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]),
                "r"(b.x), "r"(b.y), "f"(0.f));
        }
        hit |= d0 <= thr || d1 <= thr || d2 <= thr || d3 <= thr;
      }
    }
    if (__any_sync(kAll, hit)) return n0 / kGroup;
  }
  return -1;
}

__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t w) {
  return *reinterpret_cast<const __nv_bfloat162*>(&w);
}

__device__ __forceinline__ uint32_t bits2(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the bf16 rounding of x in both halves of a word
__device__ __forceinline__ uint32_t bf16_both(float x) {
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  return h | (h << 16);
}

// The bf16 filter's gate of voted slice `sl` for this warp (the JAX
// kernel's :579-612, the plain _bf16_coarse_d2): the point recentred on
// the slice centre and clamped into the slice box dilated by ~radius (f32,
// then bf16), against the slice's staged column side `fl` (the CO_FLT
// words, note 7), a pair's d2c = |p - a - t ab|^2 with t = clamp(num /
// den, 0, 1), every operation one bf16 rounding; pass: some d2c <= thr =
// (r + 0.0625 scale + 0.5)^2. Four words (8 columns) a step; a lane keeps
// the running minimum of its d2c (__hmin2 drops a NaN, as fminf does) and
// tests it once a group. Returns the group of kBf16Group columns after
// which some d2c <= thr (the slice passes), or -1 (culled).
__device__ __forceinline__ int bf16_gate(const uint32_t* fl, float4 qd,
                                         int sl, float px, float py,
                                         float radius, float mx) {
  constexpr int U = 4;                        // words (column pairs) a step
  constexpr int kWords = kBf16Group / 2;      // words a group
  const float cx = (qd.x + qd.z) * 0.5f;
  const float cy = (qd.y + qd.w) * 0.5f;
  const float ex = (qd.z - qd.x) * 0.5f + mx;
  const float ey = (qd.w - qd.y) * 0.5f + mx;
  const float scale = fmaxf(ex, ey);
  const float rl = radius + scale * 0.0625f + 0.5f;
  const float thr = rl * rl;
  const __nv_bfloat162 p2 = bf2(bf16_both(clampf(px - cx, ex)));
  const __nv_bfloat162 q2 = bf2(bf16_both(clampf(py - cy, ey)));
  const __nv_bfloat162 zero2 = bf2(0u), one2 = bf2(0x3f803f80u);
  // from column nreal of the slice on, padding: zero endpoints, clamped
  const int nreal = static_cast<int>(fl[sl]);
  const uint32_t pad_x = bf16_both(clampf(0.f - cx, ex));
  const uint32_t pad_y = bf16_both(clampf(0.f - cy, ey));
  const uint32_t* col = fl + kFlCols + sl * (kSub / 2);
  __nv_bfloat162 low = bf2(0x7f807f80u);     // +inf
  for (int w0 = 0; w0 < kSub / 2; w0 += kWords) {
#pragma unroll
    for (int w = w0; w < w0 + kWords; w += U) {
      uint32_t f[5][U];                       // ax ay abx aby den
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(col + i * kFlPairs + w);
        f[i][0] = v.x;
        f[i][1] = v.y;
        f[i][2] = v.z;
        f[i][3] = v.w;
      }
      uint32_t* ax = f[0];
      uint32_t* ay = f[1];
      if (2 * (w + U) > nreal) {              // warp-uniform, one slice only
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = 2 * (w + u);
          const uint32_t m = (c >= nreal ? 0x0000ffffu : 0u) |
                             (c + 1 >= nreal ? 0xffff0000u : 0u);
          ax[u] = (ax[u] & ~m) | (pad_x & m);
          ay[u] = (ay[u] & ~m) | (pad_y & m);
        }
      }
      const uint32_t* abx = f[2];
      const uint32_t* aby = f[3];
      const uint32_t* den = f[4];
      __nv_bfloat162 num[U], t[U];
      uint32_t need[U];
      bool divide = false;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        num[u] = __hadd2_rn(
            __hmul2_rn(__hsub2_rn(p2, bf2(ax[u])), bf2(abx[u])),
            __hmul2_rn(__hsub2_rn(q2, bf2(ay[u])), bf2(aby[u])));
        t[u] = __hgt2(num[u], zero2);        // 1 if num > 0, else 0
        // per half: not num <= 0 and not num >= den (NaN included)
        need[u] = __hgtu2_mask(num[u], zero2) &
                  __hltu2_mask(num[u], bf2(den[u]));
        divide |= need[u] != 0u;
      }
      if (divide) {          // both halves divide; the mask keeps the needed
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const __nv_bfloat162 d = bf2(den[u]);
          const __nv_bfloat162 q = __hmin2(__hmax2(__halves2bfloat162(
              __hdiv(__low2bfloat16(num[u]), __low2bfloat16(d)),
              __hdiv(__high2bfloat16(num[u]), __high2bfloat16(d))), zero2),
              one2);
          t[u] = bf2((bits2(t[u]) & ~need[u]) | (bits2(q) & need[u]));
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const __nv_bfloat162 dx = __hsub2_rn(
            p2, __hadd2_rn(bf2(ax[u]), __hmul2_rn(t[u], bf2(abx[u]))));
        const __nv_bfloat162 dy = __hsub2_rn(
            q2, __hadd2_rn(bf2(ay[u]), __hmul2_rn(t[u], bf2(aby[u]))));
        low = __hmin2(low, __hadd2_rn(__hmul2_rn(dx, dx),
                                      __hmul2_rn(dy, dy)));
      }
    }
    const bool hit = __low2float(low) <= thr || __high2float(low) <= thr;
    if (__any_sync(kAll, hit)) return w0 / kWords;
  }
  return -1;
}

// The order in which the persistent CTAs take chunks, _chunk_order's: a
// stable sort of the chunks by descending hit count, as ranks. Chunk i
// goes to position #{j : nhits[j] > nhits[i]} + #{j < i : nhits[j] ==
// nhits[i]}, the number of keys (-nhits[j], j) below its own, so distinct
// keys make the ranks a permutation. Also zeroes the chunk counter,
// order[n]. n^2 comparisons: microseconds at the main path's 512 chunks,
// where torch's sort, its cast and the counter's zeros cost the wrapper
// ~0.1 ms of host time per call.
__global__ void __launch_bounds__(kOrderThreads)
chunk_order_kernel(const int* __restrict__ nhits, int n,
                   int* __restrict__ order) {
  __shared__ int tile[kOrderThreads];
  const int i = blockIdx.x * kOrderThreads + threadIdx.x;
  const int mine = i < n ? nhits[i] : 0;
  int rank = 0;
  for (int j0 = 0; j0 < n; j0 += kOrderThreads) {
    __syncthreads();
    if (j0 + threadIdx.x < n) tile[threadIdx.x] = nhits[j0 + threadIdx.x];
    __syncthreads();
    const int m = min(kOrderThreads, n - j0);
    for (int jj = 0; jj < m; ++jj) {
      const int v = tile[jj];
      rank += v > mine || (v == mine && j0 + jj < i);
    }
  }
  if (i < n) order[rank] = i;
  if (i == 0) order[n] = 0;
}

template <int ARM>
__device__ void produce(const int* __restrict__ ids,
                        const int* __restrict__ nhits,
                        const int* __restrict__ order, int* next_chunk,
                        const float4* __restrict__ table,
                        const float4* __restrict__ quads,
                        const int* __restrict__ coarse, int nchunks,
                        int nblocks, unsigned char* stages, int4* item,
                        uint64_t* full, uint64_t* empty, int lane) {
  using R = Ring<ARM>;
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
        const int s = it % R::kDepth;
        mbar_wait(empty + s, ((it / R::kDepth) & 1u) ^ 1u);
        item[s] = make_int4(chunk, j0 + jj, blk, nh);
        if (blk >= 0) {
          unsigned char* st = stages + s * R::kStage;
          mbar_arrive_tx(full + s, kColBytes +
                         (ARM != kBlock ? kQuadBytes : 0u) + R::kCoBytes);
          bulk_load(st, table + static_cast<long>(blk) * 2 * kSblk,
                    kColBytes, full + s);
          if (ARM != kBlock) {
            bulk_load(st + kColBytes, quads + static_cast<long>(blk) * kNsub,
                      kQuadBytes, full + s);
          }
          if (kGated<ARM>) {
            bulk_load(st + kColBytes + kQuadBytes,
                      coarse + static_cast<long>(blk) * kCoWords + R::kCoFirst,
                      R::kCoBytes, full + s);
          }
        } else {
          mbar_arrive(full + s);
        }
      }
    }
    if (chunk < 0) return;
  }
}

template <int ARM, int K>
__global__ void __launch_bounds__(kThreads)
sweep_exact_kernel(const float2* __restrict__ pts,   // [nchunks*P]
                   const int* __restrict__ ids,      // [nchunks, nblocks]
                   const int* __restrict__ nhits,    // [nchunks]
                   const int* __restrict__ order,    // [nchunks]
                   int* next_chunk,                  // [1], zeroed
                   const float4* __restrict__ table, // [spad, 2]
                   const float4* __restrict__ quads, // [nblocks, nsub]
                   const int* __restrict__ coarse,   // [nblocks, kCoWords]
                   int nchunks, int nblocks, float r2, float rc2,
                   float radius,
                   int* __restrict__ out_edge,       // [nchunks*P, K]
                   float* __restrict__ out_off,
                   float* __restrict__ out_dist,
                   int* __restrict__ gate_log,       // [nchunks, 8, nblocks]
                   int squared,                      // out_dist holds d²
                   float* __restrict__ scratch,      // wide: [3, k, nchunks*P]
                   int k) {                          // wide: the top-K width
  using R = Ring<ARM>;
  extern __shared__ __align__(128) unsigned char smem[];
  int4* item = reinterpret_cast<int4*>(smem + R::kItemOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::kBarOff);
  uint64_t* empty = full + R::kDepth;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kDepth; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kCons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == kCons) {
    produce<ARM>(ids, nhits, order, next_chunk, table, quads, coarse,
                 nchunks, nblocks, smem, item, full, empty, lane);
    return;
  }

  const float mx = radius * 1.001f + 0.5f;   // the clamp box's dilation
  float px = 0.f, py = 0.f;
  typename ListOf<K>::type list(scratch, static_cast<long>(nchunks) * kP, k);
  for (uint32_t it = 0;; ++it) {
    const int s = it % R::kDepth;
    mbar_wait(full + s, (it / R::kDepth) & 1u);
    const int4 h = item[s];                 // (chunk, slot, block, nhits)
    if (h.x < 0) break;
    const long p = static_cast<long>(h.x) * kP + warp * 32 + lane;
    if (h.y == 0) {                         // the chunk's first item
      const float2 pt = pts[p];
      px = pt.x;
      py = pt.y;
      list.reset(p);
    }
    if (h.z >= 0) {
      const unsigned char* st = smem + s * R::kStage;
      const float4* col = reinterpret_cast<const float4*>(st);
      if constexpr (ARM == kBlock) {
        sweep_cols(col, 0, kSblk, px, py, r2, list);
      } else {
        const float4* quad = reinterpret_cast<const float4*>(st + kColBytes);
        unsigned vote = 0u;
#pragma unroll
        for (int sl = 0; sl < kNsub; ++sl) {
          const float4 qd = quad[sl];
          bool near = false;
          if (qd.x <= qd.z && qd.y <= qd.w) {      // false for NaN quads
            const float dx = fmaxf(fmaxf(qd.x - px, px - qd.z), 0.f);
            const float dy = fmaxf(fmaxf(qd.y - py, py - qd.w), 0.f);
            near = dx * dx + dy * dy <= rc2;
          }
          if (__any_sync(kAll, near)) vote |= 1u << sl;
        }
        unsigned gated = 0u, first = 0u;
        for (int sl = 0; sl < kNsub; ++sl) {
          if (!((vote >> sl) & 1u)) continue;      // warp-uniform
          if constexpr (kGated<ARM>) {
            const uint32_t* co =
                reinterpret_cast<const uint32_t*>(st + kColBytes + kQuadBytes);
            int grp;
            if constexpr (ARM == kSubBf16) {
              grp = bf16_gate(co, quad[sl], sl, px, py, radius, mx);
            } else {
              grp = mma_gate<ARM>(co, quad[sl], sl, px, py, r2, mx, lane);
            }
            if (grp < 0) continue;
            if (grp == 0) first |= 1u << sl;
          }
          gated |= 1u << sl;
          sweep_cols(col, sl * kSub, sl * kSub + kSub, px, py, r2, list);
        }
        if (gate_log != nullptr && lane == 0) {
          gate_log[(static_cast<long>(h.x) * kCons + warp) * nblocks + h.y] =
              static_cast<int>(vote | (gated << kNsub) |
                               (first << (2 * kNsub)));
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // the stage is free again
    if (h.y + 1 < max(h.w, 1)) continue;
    store_list(list, p, out_edge, out_off, out_dist, squared);
  }
}

// Launch shape of one arm on the current device: threads per CTA,
// dynamic shared memory, resident CTAs per SM, the SM count and the ring
// depth. The shared-memory attribute is set (once per device) before the
// occupancy query and the first launch. Returns a cudaError_t, or -2 / -3.
template <int ARM, int K>
int shape(int* threads, int* smem, int* per_sm, int* sms, int* depth) {
  using R = Ring<ARM>;
  static int cached_per_sm[kMaxDevices] = {};
  static int cached_sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return -2;
  if (cached_per_sm[dev] == 0) {
    auto kern = sweep_exact_kernel<ARM, K>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int n = 0, m = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads,
                                                        R::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n < 1) return -3;
    cached_sms[dev] = m;
    cached_per_sm[dev] = n;
  }
  *threads = kThreads;
  *smem = R::kSmem;
  *per_sm = cached_per_sm[dev];
  *sms = cached_sms[dev];
  *depth = R::kDepth;
  return 0;
}

template <int ARM, int K>
int launch(const float* pts, const int* ids, const int* nhits, int* order,
           const float* table, const float* sub, const int* coarse,
           int nchunks, int nblocks, float r2, float rc2, float radius,
           int* out_edge, float* out_off, float* out_dist, int* gate_log,
           int squared, float* scratch, int k, cudaStream_t st) {
  int threads, smem, per_sm, sms, depth;
  const int rc = shape<ARM, K>(&threads, &smem, &per_sm, &sms, &depth);
  if (rc != 0) return rc;
  chunk_order_kernel<<<(nchunks + kOrderThreads - 1) / kOrderThreads,
                       kOrderThreads, 0, st>>>(nhits, nchunks, order);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = nchunks < per_sm * sms ? nchunks : per_sm * sms;
  sweep_exact_kernel<ARM, K><<<grid, threads, smem, st>>>(
      reinterpret_cast<const float2*>(pts), ids, nhits, order,
      order + nchunks,
      reinterpret_cast<const float4*>(table),
      reinterpret_cast<const float4*>(sub), coarse, nchunks, nblocks, r2,
      rc2, radius, out_edge, out_off, out_dist, gate_log, squared, scratch,
      k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the ring-fed sweep in arm `arm` (0 block, 1 sub, 2 sub_bf16,
// 3 mxu, 4 mxu_bf16) at top-K width `k` (this library's RTT_SWEEP_K, or in
// the wide library any k >= 1; the outputs are [nchunks * 256, k]) on
// `stream`: chunk_order_kernel writes into `order`
// ([nchunks + 1] i32 scratch) the chunks heaviest first and a zeroed
// counter, which the sweep's CTAs then take chunks from (the counter ends
// at nchunks + the grid: one failed take per CTA); `table` is seg_sweep
// [spad, 8]; `sub` (the slice quads, [nblocks, 16]) is read by every arm
// but block, `coarse` (seg_coarse [nblocks, kCoWords]) and `radius` by the
// gated arms (sub_bf16, mxu, mxu_bf16); gate_log (may be null; not block)
// receives per (chunk, warp, hit slot) the slice votes (bits 0-3), the
// slices swept exactly (4-7) and those whose gate passed in its first
// group of columns (8-11). `squared` != 0 stores each candidate's squared
// distance in out_dist instead of its square root (kBig still marks an
// empty slot): the segment-sharded search merges shards on it, so its
// order is the sweep's own. `scratch` (the wide library's list, f32
// [3, k, nchunks * 256]) is read by the wide instance only; the register
// libraries take null. Returns the launch's cudaError_t (0 = ok), -1 for
// an unknown arm, -2 / -3 for a device index or an occupancy out of
// range, -4 for a k that this library was not built for, -5 for the wide
// library without its scratch.
extern "C" int rtt_sweep_exact(const float* pts, const int* ids,
                               const int* nhits, int* order,
                               const float* table, const float* sub,
                               const int* coarse, int arm, int k,
                               int nchunks, int nblocks, float r2, float rc2,
                               float radius, int* out_edge, float* out_off,
                               float* out_dist, int* gate_log, int squared,
                               float* scratch, void* stream) {
  if (kK == kWide ? k < 1 : k != kK) return -4;
  if (kK == kWide && scratch == nullptr) return -5;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RTT_LAUNCH(A)                                                       \
  launch<A, kK>(pts, ids, nhits, order, table, sub, coarse, nchunks, nblocks,  \
            r2, rc2, radius, out_edge, out_off, out_dist, gate_log, squared, \
            scratch, k, st)
  switch (arm) {
    case kBlock: return RTT_LAUNCH(kBlock);
    case kSubArm: return RTT_LAUNCH(kSubArm);
    case kSubBf16: return RTT_LAUNCH(kSubBf16);
    case kMxu: return RTT_LAUNCH(kMxu);
    case kMxuBf16: return RTT_LAUNCH(kMxuBf16);
    default: return -1;
  }
#undef RTT_LAUNCH
}

// The launch shape of arm `arm` at top-K width `k` on the current device
// (see shape()): the grid of a launch is min(nchunks, per_sm * sms).
// `group`: the columns per early-exit test of its gate (kGateCols). -4 for
// a k that this library was not built for (the wide library's shape is
// the same at every k >= 0).
extern "C" int rtt_sweep_exact_shape(int arm, int k, int* threads, int* smem,
                                     int* per_sm, int* sms, int* depth,
                                     int* group) {
  if (kK == kWide ? k < 0 : k != kK) return -4;
#define RTT_SHAPE(A) \
  (*group = kGateCols<A>, shape<A, kK>(threads, smem, per_sm, sms, depth))
  switch (arm) {
    case kBlock: return RTT_SHAPE(kBlock);
    case kSubArm: return RTT_SHAPE(kSubArm);
    case kSubBf16: return RTT_SHAPE(kSubBf16);
    case kMxu: return RTT_SHAPE(kMxu);
    case kMxuBf16: return RTT_SHAPE(kMxuBf16);
    default: return -1;
  }
#undef RTT_SHAPE
}
