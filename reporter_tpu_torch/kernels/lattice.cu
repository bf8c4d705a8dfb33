// The single-trace ranked-path lattice for Hopper (sm_90a): the keep
// mask, the list-Viterbi forward pass and the R-path backtrack behind
// SegmentMatcher.match_topk, one launch each.
//
// Replaces three lax.scan programs of reporter_tpu/ops/hmm.py, not Pallas
// kernels: interpolation_keep_mask (:268-287), the forward scans
// _forward_lattice (:290-339, one path a state) and the list step of
// viterbi_kbest_paths (:519-558, R paths a state), with the transition
// blocks they read, and the vmapped back_one reverse scans (:454-476,
// :566-590). XLA compiles each scan into an on-device loop; the port's
// plain versions (ops/hmm.py _keep_mask_batched, _lattice_prep followed by
// _forward_list_plain, _backtrack_plain) step them from the host. Each
// kernel is its plain version's arithmetic, one rounding per operation in
// its order (the intrinsics below, route.cuh, and -fmad=false), with the
// plain version's tie orders, so all three are bit-equal to it.
//
// What bounds them on this card: latency, not bytes or operations. The
// steps of a trace are sequential and one trace is one call, so one CTA
// walks T steps; a step's work (at most K columns of an R-deep merge) is
// small. The bytes (the candidates and reach rows in, the levels [T, K *
// R] out) are megabytes at most.
//
// keep mask: a CTA a trace: each valid point's next kept point if it is
//   kept (the first later valid point far enough from it), a warp's
//   ballot a window, then the chain from the first kept point marked by
//   pointer doubling, in tiles of 2048 points in shared memory (the proof
//   that this is the plain scan's set is at the kernel).
//
// forward: one CTA (ops/hmm.py::lattice_plan owns its shape: the chunk C,
//   the producer and merge warps, the shared bytes, which the C entry
//   checks against this layout; nothing in it grows with T). It reads the
//   trace's candidates, points, keep mask and the reach tables, not
//   transition blocks:
//   - The producer warps fill a chunk of C steps into one of two shared
//     buffers while the merge warps walk the other's steps (named
//     barriers: a buffer full, a buffer free). A chunk is viterbi.cu's
//     stages 1-3: the candidates (edge, offset, emission, validity, each
//     edge's reach row and length) and points staged, each row's
//     looked-up slots as a list and a 64-bit mask; one warp's control
//     sequence, a lane a step (C <= 32: active = keep and a valid
//     candidate, the last active step before by a ballot, gc from that
//     point, whether one came before, the step's first looked-up pair by
//     a prefix sum);
//     then the transition block of every step that looks up (active, an
//     active point before, gc <= breakage), only its looked-up pairs (both
//     slots valid with an edge) in the order t, i, j, kInterleave binary
//     searches of the sorted reach rows in flight a thread. A pair not
//     looked up is BIG, read through the rows' masks: what
//     _lattice_prep's block holds there.
//   - The merge warps: a thread a column c. Per active step, column c's R
//     smallest of score[cp, r] + trans[cp, c], ties by the flat state cp *
//     R + r (torch.sort(stable=True), lax.top_k). Each carried row
//     score[cp, :] ascends (best-first sums plus one emission, a restart
//     [em, BIG, ...] or the BIG start; adding a constant in f32 keeps the
//     order), so the selection is a K-way merge of K sorted rows: R picks,
//     each the first minimal row head. At R = 1 that is one first-argmin
//     pass (the plain Viterbi). At R > 1 a loser tree over the K row heads
//     (K padded to a power of two with leaves that lose every tie): a head
//     is the 64-bit key (f32 bits << 32 | cp << 6 | r), which orders as
//     (value, cp) since the costs are >= +0 and finite or BIG, and one row
//     has one head at a time; a pick replays the winner's leaf-to-root
//     path: its ceil(log2 K) nodes loaded at once, then the comparisons.
//     The loops carry no branch around their shared loads (indices
//     clamped, values selected), and the forward is one kernel a tree
//     depth (0 for R = 1), each a contiguous path of code. Picks
//     stop at the first value >= BIG (the rest write BIG, -1). The columns'
//     first picks OR-ed at a barrier give `broken`; each thread writes its
//     column's carry row and, at R > 1, its backpointers into shared rows
//     of odd pitch (at R = 1 straight out, the columns side by side); after
//     the step's barrier the level is copied out coalesced, and its own
//     first-argmin state (the first minimal row head) comes from two warp
//     reductions. An inactive step writes the carry and identity
//     backpointers out; no barrier.
//   - Past K = 64 the wide instance (LOG = kWide) runs the same producer
//     steps (ceil(K / 64) mask words, u16 lists) and its own merge: 256
//     merge threads; a column merges only its looked-up previous rows (a
//     row not looked up adds BIG to every value, and picks >= BIG write
//     BIG and -1 whatever their row), so a tree has np leaves up to a
//     power of two, not K; each looked-up column's first pass (its
//     smallest head; at R = 1 its pick) on G lanes, the looked-up columns'
//     trees built g at a time in a region of shared memory (as many as it
//     holds at this step's leaves), each pick's path loaded at once. What
//     each pick reads stays in shared memory where it fits
//     (ops/hmm.py::lattice_plan's placement, in this order): the blocks
//     at R > 1 (a pick reads its row's entry in a dependent chain; at R =
//     1 each entry is read once, in independent loads, so the blocks stay
//     in the global scratch at the chunk that keeps the most lookups in
//     flight), the carried rows, the trees; what does not fit (the blocks
//     and rows at K = R = 128 and past) goes to the global scratch.
//     Beside the carried rows the level's backpointers too (kPlaceLevel,
//     R > 1): the picks fill both, and after the step's closing barrier
//     the level is copied out coalesced, as in the shared instances; a
//     pick stored straight to its column's row of the level is a store
//     that scatters over a warp's 32 rows, and those stores held up every
//     memory access of the CTA (PERF.md). Elsewhere (R = 1, whose level
//     row is one value a column, or rows in the scratch) the level is
//     written as it is picked.
//
// backtrack: CTAs of a thread a path (up to 31 walker warps a CTA) in
//   walker warps and one producer warp, which streams the levels (backpointer rows and the
//   own, started and active flags) tail-first into a ring of NS slots of G
//   levels in shared memory (ops/hmm.py::backtrack_plan), with
//   cp.async.bulk copies that complete on an mbarrier (a block near the
//   end of the trace whose bytes do not align: ordinary loads). Each
//   walker follows the level above's backpointer, re-seeding from the
//   level's own argmin at a chain terminal (-1 at inactive levels), a
//   shared-memory read a level; its choices are staged in shared memory
//   and written out 32 levels at a time, coalesced. Where two slots of four
//   levels do not fit a CTA (some 7,000 states a level), each path reads
//   its levels in place instead (lattice_backtrack_global_kernel).

#include <atomic>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "route.cuh"

// scripts/lattice_profile.py redefines these three to count the forward's
// phases in cycles; here they are nothing
#define RTT_PROFILE_START
#define RTT_MARK(k)
#define RTT_PROFILE_END

namespace {

constexpr int kMaxK = 64;            // the forward's shared instances
constexpr int kMaxThreads = 384;     // the forward CTA: producers + merge
constexpr int kWideMerge = 256;      // the wide forward's merge threads
constexpr int kWideThreads = 256 + kWideMerge;
constexpr int kWide = -1;            // the wide forward's LOG
constexpr int kMaxSmem = 232448;     // a CTA's shared memory on sm_90
constexpr int kInterleave = 8;       // binary searches in flight a thread
constexpr int kMaxWalkers = 31;      // a backtrack CTA's walker warps
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kSpent = ~0ull;  // a spent row's head, a pad

// a step's flags from the control sequence
constexpr int kStepActive = 1;
constexpr int kStepLook = 2;         // active, prev_any, gc <= breakage

// named barriers (0 is __syncthreads')
constexpr int kBarProducers = 1;
constexpr int kBarMerge = 2;
constexpr int kBarFull = 3;          // + the buffer: its chunk is ready
constexpr int kBarFree = 5;          // + the buffer: its chunk is consumed

// ---- the keep mask -------------------------------------------------------

// The plain version keeps point t where it is valid and, once a point has
// been kept, lies at least interp from the last kept point (its d2 =
// dx*dx + dy*dy, dx = x_t - x_last, against f32(interp)^2, one rounding
// an operation); last_pt starts at p[0] and any_kept at false.
//
// The same set, computed in parallel. Let next[t] be the first j > t with
// vp[j] and d2(p_j, p_t) >= d2_min (d2 in that order), or none.
// - While any_kept is false, keep_t = vp[t] (the initial last_pt = p[0]
//   is never compared: any_kept guards it). So the first kept point is
//   the first valid one, f.
// - Once t is kept, last_pt = p_t until the next keep. A later u keeps
//   iff vp[u] and d2(p_u, p_t) >= d2_min, so the next kept point is the
//   first such u: next[t].
// By induction the kept points are f, next[f], next[next[f]], ...: the
// chain from f along next, and nothing else.
//
// The kernel takes a trace a CTA, in tiles of kKeepTile points staged in
// shared memory with coalesced loads. In a tile, next is sought within
// the tile (none past it); the tile's first kept point is the first valid
// point at d2 >= d2_min from the carried last kept point (any valid point
// before any was kept); the chain from it is marked by pointer doubling
// (each round a marked u marks jump[u], then jump = jump o jump: after
// round r every chain point within 2^(r+1) steps is marked, so
// ceil(log2 n) rounds mark it all; marks only follow the chain, so the
// rounds' races only mark chain points sooner). The tile's last kept
// point carries into the next tile, where the chain goes on exactly as
// the plain scan would, since a kept point's successor is the first point
// far enough from it, wherever it lies.
//
// next[t] is a warp's search: its lanes test 32 points at once and a
// ballot takes the first, window after window. A moving trace finds it
// in the first window; a vehicle standing still (every point within
// interp) searches to the tile's end, which bounds the worst case at
// kKeepTile^2 / 32 tests a tile, spread over the CTA's warps.

constexpr int kKeepTile = 2048;      // points a tile in shared memory
constexpr int kKeepMaxThreads = 1024;

__global__ void __launch_bounds__(kKeepMaxThreads)
    lattice_keep_kernel(const float* __restrict__ pts,
                        const unsigned char* __restrict__ vp, int T,
                        float d2_min, unsigned char* __restrict__ keep) {
  __shared__ float s_x[kKeepTile], s_y[kKeepTile];
  __shared__ int s_jump[2][kKeepTile];
  __shared__ unsigned char s_v[kKeepTile], s_mark[kKeepTile];
  __shared__ int s_first, s_last;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t b = blockIdx.x;
  const float* p = pts + b * T * 2;
  const unsigned char* v = vp + b * T;
  unsigned char* out = keep + b * T;
  // the carried last kept point (every thread's copy) and whether any
  float lx = 0.0f, ly = 0.0f;
  bool any_kept = false;
  for (int t0 = 0; t0 < T; t0 += kKeepTile) {
    const int n = min(kKeepTile, T - t0);
    for (int i = tid; i < n; i += nt) {
      s_x[i] = p[2 * (t0 + i)];
      s_y[i] = p[2 * (t0 + i) + 1];
      s_v[i] = v[t0 + i];
      s_mark[i] = 0;
    }
    if (tid == 0) {
      s_first = n;
      s_last = -1;
    }
    __syncthreads();
    // the tile's first kept point
    for (int i = tid; i < n; i += nt) {
      bool k = s_v[i] != 0;
      if (k && any_kept) {
        const float dx = __fsub_rn(s_x[i], lx), dy = __fsub_rn(s_y[i], ly);
        k = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) >= d2_min;
      }
      if (k) atomicMin(&s_first, i);
    }
    // next[i] within the tile (n: none), a warp a point
    for (int i = warp; i < n; i += nwarps) {
      int found = n;
      if (s_v[i]) {
        const float xi = s_x[i], yi = s_y[i];
        for (int j0 = i + 1; j0 < n; j0 += 32) {
          const int j = j0 + lane;
          bool ok = false;
          if (j < n && s_v[j]) {
            const float dx = __fsub_rn(s_x[j], xi);
            const float dy = __fsub_rn(s_y[j], yi);
            ok = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) >= d2_min;
          }
          const unsigned m = __ballot_sync(kFull, ok);
          if (m) {
            found = j0 + __ffs(m) - 1;
            break;
          }
        }
      }
      if (lane == 0) s_jump[0][i] = found;
    }
    __syncthreads();
    const int first = s_first;
    if (tid == 0 && first < n) s_mark[first] = 1;
    __syncthreads();
    // the chain from `first`, by pointer doubling
    int cur = 0;
    for (int span = 1; span < n; span *= 2) {
      const int* jmp = s_jump[cur];
      int* nxt = s_jump[cur ^ 1];
      for (int i = tid; i < n; i += nt) {
        const int j = jmp[i];
        if (s_mark[i] && j < n) s_mark[j] = 1;
        nxt[i] = j < n ? jmp[j] : n;
      }
      cur ^= 1;
      __syncthreads();
    }
    for (int i = tid; i < n; i += nt) {
      out[t0 + i] = s_mark[i];
      if (s_mark[i]) atomicMax(&s_last, i);
    }
    __syncthreads();
    if (s_last >= 0) {
      lx = s_x[s_last];
      ly = s_y[s_last];
      any_kept = true;
    }
    __syncthreads();           // the tile's arrays read: the next may stage
  }
}

// ---- shared helpers --------------------------------------------------------

__host__ __device__ inline int take(int& at, int n) {
  const int o = at;
  at += (n + 15) & ~15;
  return o;
}

__host__ __device__ inline int pow2_at_least(int k) {
  int n = 1;
  while (n < k) n *= 2;
  return n;
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// a barrier of n threads that ORs their predicates
__device__ __forceinline__ bool bar_or(int id, int n, bool v) {
  int r;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.s32 p, %1, 0;\n\t"
      "bar.red.or.pred q, %2, %3, p;\n\t"
      "selp.s32 %0, 1, 0, q;\n\t}"
      : "=r"(r)
      : "r"(v ? 1 : 0), "r"(id), "r"(n)
      : "memory");
  return r != 0;
}

// ---- the forward pass ----------------------------------------------------

// One chunk buffer's arrays, in bytes from its base, each 16 aligned: the
// chunk's transition blocks [C, K, K], its candidate rows [(C + 1), K]
// (row 0 the carry: the last active point before the chunk), each row's
// looked-up mask, the steps' points, gc, previous row, first pair, flags,
// keep and any-valid bytes, and two words (the chunk's last active step,
// its pairs).
struct Buf {
  int trans, e, o, em, len, row, v, list, mask;
  int x, y, gc, prev, off, flags, keep, any, misc, bytes;
};

// the wide forward's placement bits (the plan's): what stays in shared
// memory, the rest in the global scratch
constexpr int kPlaceBlocks = 1;      // the chunks' transition blocks
constexpr int kPlaceRows = 2;        // the carried rows
constexpr int kPlaceTrees = 4;       // the merge's loser trees
constexpr int kPlaceBest = 8;        // each column's first-pass result
constexpr int kPlaceLevel = 16;      // the level's backpointers (R > 1)

__host__ __device__ inline Buf make_buf(int K, int C, bool blocks_here) {
  Buf B{};
  int at = 0;
  const int rows = (C + 1) * K;
  const bool wide = K > kMaxK;   // a u16 list, mask words
  B.trans = blocks_here ? take(at, 4 * C * K * K) : -1;
  B.e = take(at, 4 * rows);
  B.o = take(at, 4 * rows);
  B.em = take(at, 4 * rows);
  B.len = take(at, 4 * rows);
  B.row = take(at, 4 * rows);
  B.v = take(at, rows);
  B.list = take(at, (wide ? 2 : 1) * rows);
  B.mask = take(at, 8 * ((K + 63) / 64) * (C + 1));
  B.x = take(at, 4 * C);
  B.y = take(at, 4 * C);
  B.gc = take(at, 4 * C);
  B.prev = take(at, 4 * C);
  B.off = take(at, 4 * C);
  B.flags = take(at, C);
  B.keep = take(at, C);
  B.any = take(at, C);
  B.misc = take(at, 16);
  B.bytes = at;
  return B;
}

// The forward CTA's shared memory (ops/hmm.py::lattice_smem_bytes makes
// the same sum, which the launch checks): the two chunk buffers, the
// carried scores [K, RP] twice (row c at c * RP, RP = R | 1: odd, so a
// warp's columns at one rank hit distinct banks), at R > 1 the level's
// backpointers [K, RP] and the loser trees (u64 [N][W]: node n of column c
// at n * W + c, N = K up to a power of two, W = K up to a multiple of 16,
// so a warp's lanes hit distinct banks whatever nodes they read), and the
// own reduction's words (two steps' worth). The wide instance (K > kMaxK)
// keeps here the buffers (their blocks where `place` has kPlaceBlocks),
// the carried rows [K, RP] twice where it has kPlaceRows, the level's
// backpointers [K, RP] where it has kPlaceLevel (with the rows: the level
// is then copied out coalesced from them), each column's
// first-pass best and argmin [K] where it has kPlaceBest, the reduction's
// words for its eight merge warps, and last, where it has kPlaceTrees,
// the trees' region of
// `tree_bytes` (N - 1 loser nodes a column, N the looked-up previous rows
// up to a power of two); the rest is in its global scratch (WideScratch).
struct Layout {
  Buf buf;
  int buf0, buf1, score0, score1, bp, tree, red, best, arg, bytes;
};

__host__ __device__ inline int tree_pitch(int K) { return (K + 15) & ~15; }

__host__ __device__ inline Layout make_layout(int K, int R, int C,
                                              int place, int tree_bytes) {
  Layout L{};
  const bool wide = K > kMaxK;
  L.buf = make_buf(K, C, !wide || (place & kPlaceBlocks));
  int at = 0;
  const int RP = R | 1;
  L.buf0 = take(at, L.buf.bytes);
  L.buf1 = take(at, L.buf.bytes);
  if (wide) {
    const bool rows = place & kPlaceRows;
    L.score0 = rows ? take(at, 4 * K * RP) : -1;
    L.score1 = rows ? take(at, 4 * K * RP) : -1;
    L.bp = place & kPlaceLevel ? take(at, 4 * K * RP) : -1;
    L.best = place & kPlaceBest ? take(at, 4 * K) : -1;
    L.arg = place & kPlaceBest ? take(at, 4 * K) : -1;
    L.red = take(at, 4 * 2 * 2 * (kWideMerge / 32));
    L.tree = place & kPlaceTrees ? take(at, tree_bytes) : -1;
    L.bytes = at;
    return L;
  }
  L.score0 = take(at, 4 * K * RP);
  L.score1 = take(at, 4 * K * RP);
  L.bp = R > 1 ? take(at, 4 * K * RP) : at;
  L.tree = R > 1 ? take(at, 8 * pow2_at_least(K) * tree_pitch(K)) : at;
  L.red = take(at, 32);
  L.bytes = at;
  return L;
}

// The wide forward's global scratch, in bytes from its base, each array
// 16 aligned (ops/hmm.py::lattice_scratch_bytes makes the same sum): what
// the placement leaves out of shared memory, of the two buffers' blocks
// f32 [2][C, K, K], the carried scores [K, RP] twice, each column's
// first-pass best and argmin [K] and, at R > 1, the trees' region
// (`tree_bytes`).
struct WideScratch {
  size_t trans, score0, score1, best, arg, tree, bytes;
};

__host__ __device__ inline size_t take_at(size_t& at, size_t n) {
  const size_t o = at;
  at += (n + 15) & ~static_cast<size_t>(15);
  return o;
}

__host__ __device__ inline WideScratch make_wide_scratch(int K, int R, int C,
                                                         int place,
                                                         int tree_bytes) {
  WideScratch S{};
  size_t at = 0;
  const size_t rows = static_cast<size_t>(K) * (R | 1) * 4;
  const bool blocks = place & kPlaceBlocks, here = place & kPlaceRows;
  S.trans = take_at(at, blocks ? 0 : 2ull * C * K * K * 4);
  S.score0 = take_at(at, here ? 0 : rows);
  S.score1 = take_at(at, here ? 0 : rows);
  S.best = take_at(at, place & kPlaceBest ? 0 : 4ull * K);
  S.arg = take_at(at, place & kPlaceBest ? 0 : 4ull * K);
  S.tree = take_at(at, R > 1 && !(place & kPlaceTrees) ? tree_bytes : 0);
  S.bytes = at;
  return S;
}

struct Chunk {
  float* trans;
  int* e;
  float* o;
  float* em;
  float* len;
  int* row;
  unsigned char* v;
  unsigned char* list;        // u8 slots, u16 in the wide instance
  unsigned long long* mask;   // ceil(K / 64) words a row
  float* x;
  float* y;
  float* gc;
  int* prev;
  int* off;
  unsigned char* flags;
  unsigned char* keep;
  unsigned char* any;
  int* misc;
};

__device__ __forceinline__ Chunk chunk_at(unsigned char* base, const Buf& B,
                                          float* trans) {
  Chunk c;
  c.trans = trans ? trans : reinterpret_cast<float*>(base + B.trans);
  c.e = reinterpret_cast<int*>(base + B.e);
  c.o = reinterpret_cast<float*>(base + B.o);
  c.em = reinterpret_cast<float*>(base + B.em);
  c.len = reinterpret_cast<float*>(base + B.len);
  c.row = reinterpret_cast<int*>(base + B.row);
  c.v = base + B.v;
  c.list = base + B.list;
  c.mask = reinterpret_cast<unsigned long long*>(base + B.mask);
  c.x = reinterpret_cast<float*>(base + B.x);
  c.y = reinterpret_cast<float*>(base + B.y);
  c.gc = reinterpret_cast<float*>(base + B.gc);
  c.prev = reinterpret_cast<int*>(base + B.prev);
  c.off = reinterpret_cast<int*>(base + B.off);
  c.flags = base + B.flags;
  c.keep = base + B.keep;
  c.any = base + B.any;
  c.misc = reinterpret_cast<int*>(base + B.misc);
  return c;
}

struct FwdParams {
  const int* ce;               // i32 [T, K] candidate edges (-1 empty)
  const float* co;             // f32 [T, K] offsets along them
  const float* cd;             // f32 [T, K] distances to the point
  const unsigned char* cv;     // bool [T, K]
  const float* pts;            // f32 [T, 2]
  const unsigned char* keep;   // bool [T], the keep mask
  const float* edge_len;       // f32 [E]
  const int* reach_row;        // i32 [E]
  const int* reach_to;         // i32 [rows, M], ascending, -1 padded
  const float* reach_dist;     // f32 [rows, M]
  int T, K, R, M, top;         // top: the largest power of two <= M
  int C, P, MW;                // chunk, producer and merge threads
  float em_denom;              // f32(2 sigma_z^2), computed in double
  float beta, factor, breakage, slack;
  float* scores;               // f32 [T, K * R]
  int* backptrs;               // i32 [T, K * R]
  unsigned char* started;      // bool [T]
  int* own;                    // i32 [T]
  unsigned char* active;       // bool [T]
  unsigned char* scratch;      // the wide instance's (WideScratch)
  int place, tree_bytes;       // the wide instance's placement, its trees'
};

// a row head's key: the value's bits (costs are >= +0, so they order as
// unsigned), then the row cp and its rank r
__device__ __forceinline__ unsigned long long head_key(float v, int cp,
                                                       int r) {
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
         static_cast<unsigned>((cp << 6) | r);
}

// The merge's loops are written without branches around their shared
// loads: a load is made whatever the row (its index clamped to the
// column's rows), then selected, so the loads of several rows, or of a
// path's nodes, go out at once rather than a latency each.

// the transition into this thread's column from row cp < 64: the chunk's
// block where the pair was looked up, else BIG (row min(cp, K - 1) read)
__device__ __forceinline__ float trans_of(const float* tr, int K,
                                          unsigned long long seen, int cp) {
  const float v = tr[min(cp, K - 1) * K];
  return ((seen >> cp) & 1ull) ? v : kBig;
}

// the loser tree of the leaves [lo, lo + N) under heap node `node`: the
// losers stored, the winner returned. Leaves at or past K lose every tie.
template <int N>
__device__ __forceinline__ unsigned long long tree_build(
    const float* cur, const float* tr, unsigned long long seen, int K,
    int RP, int lo, int node, unsigned long long* tree, int W) {
  if constexpr (N <= 8) {
    unsigned long long k[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int cp = lo + u;
      const unsigned long long h = head_key(
          __fadd_rn(cur[min(cp, K - 1) * RP], trans_of(tr, K, seen, cp)), cp,
          0);
      k[u] = cp < K ? h : kSpent;
    }
#pragma unroll
    for (int w = 1; w < N; w *= 2) {
#pragma unroll
      for (int u = 0; u < N; u += 2 * w) {
        // the match of k[u] and k[u + w] at heap node (node * N + u) / 2w
        const int at = (node * N + u) / (2 * w);
        const unsigned long long a = k[u], b = k[u + w];
        tree[at * W] = a < b ? b : a;
        k[u] = a < b ? a : b;
      }
    }
    return k[0];
  } else {
    const unsigned long long a =
        tree_build<N / 2>(cur, tr, seen, K, RP, lo, 2 * node, tree, W);
    const unsigned long long b = tree_build<N / 2>(cur, tr, seen, K, RP,
                                                   lo + N / 2, 2 * node + 1,
                                                   tree, W);
    tree[node * W] = a < b ? b : a;
    return a < b ? a : b;
  }
}

// one pick of the column's merge: the winner x's value and state, then
// its row advanced and its leaf-to-root path replayed (every node of the
// path loaded first, then the comparisons; the stores predicated). → the
// pick's (value + em, state), or (BIG, -1) once the winner is >= BIG
// (`done`: the tree is left as it is).
template <int LOG>
__device__ __forceinline__ void tree_pick(unsigned long long& x, bool& done,
                                          int r, const float* cur,
                                          const float* tr,
                                          unsigned long long seen, int K,
                                          int R, float em,
                                          unsigned long long* tree, int W,
                                          float& val, int& bp) {
  const float v = __uint_as_float(static_cast<unsigned>(x >> 32));
  const bool live = !done && v < kBig;
  done = !live;
  const unsigned low = static_cast<unsigned>(x);
  const int cp = min(static_cast<int>(low >> 6), K - 1);
  const int rr = static_cast<int>(low & 63);
  val = live ? __fadd_rn(v, em) : kBig;
  bp = live ? cp * R + rr : -1;
  if (r + 1 >= R) return;      // the same r in every lane
  const int leaf = (1 << LOG) + cp;
  unsigned long long y[LOG];
#pragma unroll
  for (int l = 0; l < LOG; ++l) y[l] = tree[(leaf >> (l + 1)) * W];
  const float nv = cur[cp * (R | 1) + min(rr + 1, R - 1)];
  const unsigned long long next =
      head_key(__fadd_rn(nv, trans_of(tr, K, seen, cp)), cp, rr + 1);
  unsigned long long key = rr + 1 < R ? next : kSpent;
#pragma unroll
  for (int l = 0; l < LOG; ++l) {
    const bool swap = y[l] < key;
    if (live && swap) tree[(leaf >> (l + 1)) * W] = key;
    key = swap ? y[l] : key;
  }
  x = live ? key : x;
}

// the column's R picks into its carry row and level backpointers (shared,
// rows of pitch R | 1). → the pick r = 0's value.
template <int LOG>
__device__ __forceinline__ float column_picks(
    unsigned long long x, const float* cur, const float* tr,
    unsigned long long seen, int K, int R, float em,
    unsigned long long* tree, int W, float* nxt, int* bp) {
  bool done = false;
  float first = kBig;
  for (int r = 0; r < R; ++r) {
    float v;
    int b;
    tree_pick<LOG>(x, done, r, cur, tr, seen, K, R, em, tree, W, v, b);
    if (r == 0) first = v;
    nxt[r] = v;
    bp[r] = b;
  }
  return first;
}

// ---- the wide instance's merge (K > kMaxK): the same picks as the
// shared instances', written for any K, over a column's looked-up previous
// rows alone (np of them). A row not looked up with the column adds BIG to
// every value of its row, and a pick >= BIG writes BIG and -1 whichever
// row it came from, so leaving those rows out changes no pick below BIG
// and no tie between them. A row head's key holds, in the low word, the
// row's leaf ii (its place among the looked-up rows, which ascend, so ii
// orders as the row cp = plist[ii] does) in the upper 16 bits and its rank
// in the lower 16 (R <= K, and the shared memory keeps K under 2,509); a
// column's loser tree has N = np up to a power of two leaves, its N - 1
// loser nodes kept (node n of the thread's tree at n * W), its leaves
// recomputed from the row heads. Each tree depth LOG has its own code
// (wide_column<LOG>), one contiguous path: the build, to LOG =
// kWideUnroll, a recursion whose leaves' loads all go out at once (the
// shared instances' tree_build), past it a loop; a pick's LOG path nodes
// loaded at once, then compared, as in tree_pick.

constexpr int kWideLog = 12;         // a tree's depth: 2^12 >= 2,508 rows
constexpr int kWideUnroll = 7;       // the builds unrolled: to 128 leaves
constexpr int kFirst = 4;            // a first-pass lane's loads at once

// (v, i) becomes (ov, oi) where that pair is lexicographically smaller
__device__ __forceinline__ void keep_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ unsigned long long wide_key(float v, int ii,
                                                       int r) {
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
         (static_cast<unsigned>(ii) << 16) | static_cast<unsigned>(r);
}

// the column's leaf ii: its row's head (rank 0), or a spent pad past np
__device__ __forceinline__ unsigned long long wide_leaf(
    const float* cur, const float* tc, const unsigned short* plist, int np,
    int K, int RP, int ii) {
  const int cp = plist[min(ii, np - 1)];
  const unsigned long long h =
      wide_key(__fadd_rn(cur[cp * RP], tc[cp * K]), ii, 0);
  return ii < np ? h : kSpent;
}

// the loser tree of the leaves [lo, lo + N) under heap node `node`, the
// leaves' keys in registers: the losers stored, the winner returned
template <int N>
__device__ __forceinline__ unsigned long long wide_tree_build(
    const float* cur, const float* tc, const unsigned short* plist, int np,
    int K, int RP, int lo, int node, unsigned long long* tree, int W) {
  if constexpr (N <= 8) {
    unsigned long long k[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      k[u] = wide_leaf(cur, tc, plist, np, K, RP, lo + u);
    }
#pragma unroll
    for (int w = 1; w < N; w *= 2) {
#pragma unroll
      for (int u = 0; u < N; u += 2 * w) {
        const int at = (node * N + u) / (2 * w);
        const unsigned long long a = k[u], b = k[u + w];
        tree[at * W] = a < b ? b : a;
        k[u] = a < b ? a : b;
      }
    }
    return k[0];
  } else {
    const unsigned long long a = wide_tree_build<N / 2>(
        cur, tc, plist, np, K, RP, lo, 2 * node, tree, W);
    const unsigned long long b = wide_tree_build<N / 2>(
        cur, tc, plist, np, K, RP, lo + N / 2, 2 * node + 1, tree, W);
    tree[node * W] = a < b ? b : a;
    return a < b ? a : b;
  }
}

// the same past kWideUnroll: each node's winner bottom-up, then its loser
// top-down (children still hold winners)
__device__ unsigned long long wide_tree_loop(
    const float* cur, const float* tc, const unsigned short* plist, int np,
    int K, int RP, int N, unsigned long long* tree, int W) {
  auto at = [&](int n) -> unsigned long long {
    return n >= N ? wide_leaf(cur, tc, plist, np, K, RP, n - N)
                  : tree[n * W];
  };
  for (int n = N - 1; n >= 1; --n) {
    const unsigned long long a = at(2 * n), b = at(2 * n + 1);
    tree[n * W] = a < b ? a : b;
  }
  const unsigned long long win = tree[W];
  for (int n = 1; n < N; ++n) {
    const unsigned long long a = at(2 * n), b = at(2 * n + 1);
    tree[n * W] = a < b ? b : a;
  }
  return win;
}

// one looked-up column at tree depth LOG: its tree built, then its R
// picks into its carry row and the level's row (values plus em into `os`
// unless it is null, where the carry row is the level's; states into
// `ob`), each pick's leaf-to-root path loaded at once, then compared, the
// stores predicated. → the pick r = 0's value.
template <int LOG>
__device__ __forceinline__ float wide_column(
    const float* cur, const float* tc, const unsigned short* plist, int np,
    int K, int R, float em, unsigned long long* tree, int W, float* crow,
    float* os, int* ob) {
  constexpr int N = 1 << LOG;
  const int RP = R | 1;
  unsigned long long x;
  if constexpr (LOG <= kWideUnroll) {
    x = wide_tree_build<N>(cur, tc, plist, np, K, RP, 0, 1, tree, W);
  } else {
    x = wide_tree_loop(cur, tc, plist, np, K, RP, N, tree, W);
  }
  bool done = false;
  float first = kBig;
  for (int r = 0; r < R; ++r) {
    const float v = __uint_as_float(static_cast<unsigned>(x >> 32));
    const bool live = !done && v < kBig;
    done = !live;
    const unsigned low = static_cast<unsigned>(x);
    const int ii = min(static_cast<int>(low >> 16), np - 1);
    const int rr = static_cast<int>(low & 0xffffu);
    const int cp = plist[ii];
    const float val = live ? __fadd_rn(v, em) : kBig;
    if (r == 0) first = val;
    crow[r] = val;
    if (os) os[r] = val;
    ob[r] = live ? cp * R + rr : -1;
    if (r + 1 >= R || !live) continue;
    const int leaf = N + ii;
    unsigned long long y[LOG > 0 ? LOG : 1];
#pragma unroll
    for (int l = 0; l < LOG; ++l) y[l] = tree[(leaf >> (l + 1)) * W];
    const float nv = cur[cp * RP + min(rr + 1, R - 1)];
    const float tv = tc[cp * K];
    unsigned long long key =
        rr + 1 < R ? wide_key(__fadd_rn(nv, tv), ii, rr + 1) : kSpent;
#pragma unroll
    for (int l = 0; l < LOG; ++l) {
      const bool swap = y[l] < key;
      if (swap) tree[(leaf >> (l + 1)) * W] = key;
      key = swap ? y[l] : key;
    }
    x = key;
  }
  return first;
}

// wide_column at the depth of N = np up to a power of two
__device__ float wide_column_at(int depth, const float* cur, const float* tc,
                                const unsigned short* plist, int np, int K,
                                int R, float em, unsigned long long* tree,
                                int W, float* crow, float* os, int* ob) {
#define RTT_WIDE_AT(d)                                                   \
  case d:                                                                \
    return wide_column<d>(cur, tc, plist, np, K, R, em, tree, W, crow, os, \
                          ob);
  switch (depth) {
    RTT_WIDE_AT(0) RTT_WIDE_AT(1) RTT_WIDE_AT(2) RTT_WIDE_AT(3)
    RTT_WIDE_AT(4) RTT_WIDE_AT(5) RTT_WIDE_AT(6) RTT_WIDE_AT(7)
    RTT_WIDE_AT(8) RTT_WIDE_AT(9) RTT_WIDE_AT(10) RTT_WIDE_AT(11)
    default:
      return wide_column<kWideLog>(cur, tc, plist, np, K, R, em, tree, W,
                                   crow, os, ob);
  }
#undef RTT_WIDE_AT
}

// a level [K, R] out of shared rows of pitch RP (R | 1) into out_s and
// out_b, coalesced: thread i takes elements 4i, 4i + 1, ... in steps of
// 4n (vectors of four where R is a multiple of 4: then one row holds all
// four); backpointers from b_rows, or the identity where it is null
__device__ __forceinline__ void copy_level(const float* rows,
                                           const int* b_rows, int K, int R,
                                           int RP, float* out_s, int* out_b,
                                           int i, int n) {
  const int KR = K * R;
  if ((R & 3) == 0) {
    int x = 4 * i, c = x / R, r = x - c * R;
    const int step = 4 * n, dc = step / R, dr = step - dc * R;
    for (; x < KR; x += step) {
      const int at = c * RP + r;
      const float4 v =
          make_float4(rows[at], rows[at + 1], rows[at + 2], rows[at + 3]);
      const int4 b = b_rows ? make_int4(b_rows[at], b_rows[at + 1],
                                        b_rows[at + 2], b_rows[at + 3])
                            : make_int4(x, x + 1, x + 2, x + 3);
      *reinterpret_cast<float4*>(out_s + x) = v;
      *reinterpret_cast<int4*>(out_b + x) = b;
      c += dc;
      r += dr;
      if (r >= R) {
        r -= R;
        ++c;
      }
    }
  } else {
    int x = i, c = x / R, r = x - c * R;
    const int dc = n / R, dr = n - dc * R;
    for (; x < KR; x += n) {
      const int at = c * RP + r;
      out_s[x] = rows[at];
      out_b[x] = b_rows ? b_rows[at] : x;
      c += dc;
      r += dr;
      if (r >= R) {
        r -= R;
        ++c;
      }
    }
  }
}

// LOG: 0 for R = 1 (the first-argmin pass), else ceil(log2 K) for R > 1
// (the loser tree of 2^LOG leaves): one kernel each, so a step's code is
// the one path's, contiguous. kWide (-1): the wide instance, any K past
// kMaxK and any R.
template <int LOG>
__global__ void __launch_bounds__(LOG == kWide ? kWideThreads : kMaxThreads,
                                  1)
    lattice_forward_kernel(const FwdParams p) {
  constexpr bool kIsWide = LOG == kWide;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = p.K, R = p.R, C = p.C, T = p.T, M = p.M, MW = p.MW;
  const int P = p.P;
  const int KR = K * R, KK = K * K;
  const int Wm = kIsWide ? (K + 63) >> 6 : 1;   // mask words a row
  const int tid = threadIdx.x, lane = tid & 31;
  const bool is_producer = tid >= MW;
  const int ptid = tid - MW;   // a producer's index
  const int mtid = tid;        // a merge thread's: its column
  const int nchunks = (T + C - 1) / C;
  const Layout L = make_layout(K, R, C, p.place, p.tree_bytes);
  const WideScratch WS = make_wide_scratch(K, R, C, p.place, p.tree_bytes);
  auto chunk_of = [&](int b) {
    float* trans = kIsWide && !(p.place & kPlaceBlocks)
                       ? reinterpret_cast<float*>(p.scratch + WS.trans) +
                             static_cast<size_t>(b) * C * KK
                       : nullptr;
    return chunk_at(smem + (b ? L.buf1 : L.buf0), L.buf, trans);
  };
  // a row's slot i of its list, and its looked-up count
  auto list_at = [&](const Chunk& B, int i) -> int {
    if constexpr (kIsWide) {
      return reinterpret_cast<const unsigned short*>(B.list)[i];
    } else {
      return B.list[i];
    }
  };
  auto row_count = [&](const Chunk& B, int r) {
    int c = 0;
    for (int w = 0; w < Wm; ++w) c += __popcll(B.mask[r * Wm + w]);
    return c;
  };
  RTT_PROFILE_START

  if (is_producer) {
    // ---- the producer warps: chunk n's rows, control sequence and
    // transition blocks into buffer n & 1, a chunk ahead of the merge
    const int pwarp = ptid >> 5, npw = P >> 5;
    // the first producer warp's carried scalars: the previous active
    // point and whether there is one (the same in every lane)
    float px = 0.0f, py = 0.0f;
    bool prev_any = false;
    if (pwarp == 0) {
      px = p.pts[0];
      py = p.pts[1];
    }
    for (int b = 0; b < 2; ++b) {
      unsigned char* any = chunk_of(b).any;
      for (int s = ptid; s < C; s += P) any[s] = 0;
    }
    bar_sync(kBarProducers, P);
    for (int n = 0; n < nchunks; ++n) {
      const int b = n & 1, t0 = n * C, cn = min(C, T - t0);
      const Chunk B = chunk_of(b);
      if (n >= 2) bar_sync(kBarFree + b, P + MW);
      RTT_MARK(0)
      // row 0: the carry, the last active point's candidates before the
      // chunk (the previous chunk's last active row, else its own row 0)
      if (n == 0) {
        for (int k = ptid; k < K; k += P) {
          B.e[k] = -1;
          B.o[k] = 0.0f;
          B.v[k] = 0;
          B.row[k] = 0;
          B.len[k] = 0.0f;
        }
      } else {
        const Chunk O = chunk_of(b ^ 1);
        const int src = (O.misc[0] + 1) * K;
        for (int k = ptid; k < K; k += P) {
          B.e[k] = O.e[src + k];
          B.o[k] = O.o[src + k];
          B.v[k] = O.v[src + k];
          B.row[k] = O.row[src + k];
          B.len[k] = O.len[src + k];
        }
      }
      // rows 1..cn: the chunk's candidates
      for (int c = ptid; c < cn * K; c += P) {
        const size_t g = static_cast<size_t>(t0) * K + c;
        const int e = __ldg(p.ce + g);
        const bool v = __ldg(p.cv + g) != 0;
        const float d = __ldg(p.cd + g);
        const int at = K + c;
        B.e[at] = e;
        B.o[at] = __ldg(p.co + g);
        B.v[at] = v;
        B.em[at] = v ? __fdiv_rn(__fmul_rn(d, d), p.em_denom) : kBig;
        B.row[at] = e >= 0 ? __ldg(p.reach_row + e) : 0;
        B.len[at] = e >= 0 ? __ldg(p.edge_len + e) : 0.0f;
        if (v) B.any[c / K] = 1;
      }
      for (int s = ptid; s < cn; s += P) {
        B.x[s] = __ldg(p.pts + 2 * (t0 + s));
        B.y[s] = __ldg(p.pts + 2 * (t0 + s) + 1);
        B.keep[s] = __ldg(p.keep + t0 + s);
      }
      bar_sync(kBarProducers, P);
      RTT_MARK(1)
      // the rows' looked-up slots (valid, an edge), a row a warp
      for (int r = pwarp; r <= cn; r += npw) {
        unsigned long long mask = 0ull;
        int count = 0;
        for (int k0 = 0; k0 < K; k0 += 32) {
          const int k = k0 + lane;
          const bool ok = k < K && B.v[r * K + k] && B.e[r * K + k] >= 0;
          const unsigned m = __ballot_sync(kFull, ok);
          if (ok) {
            const int at = r * K + count + __popc(m & ((1u << lane) - 1u));
            if constexpr (kIsWide) {
              reinterpret_cast<unsigned short*>(B.list)[at] =
                  static_cast<unsigned short>(k);
            } else {
              B.list[at] = static_cast<unsigned char>(k);
            }
          }
          count += __popc(m);
          mask |= static_cast<unsigned long long>(m) << (k0 & 63);
          // a word whole at its upper half, or at the row's end
          if ((k0 & 63) == 32 || k0 + 32 >= K) {
            if (lane == 0) B.mask[r * Wm + (k0 >> 6)] = mask;
            mask = 0ull;
          }
        }
      }
      bar_sync(kBarProducers, P);
      RTT_MARK(2)
      // the control sequence (the first producer warp, a lane a step):
      // active, the last active step before (a ballot), gc from that
      // point in the plain operation order, prev_any, the previous row and
      // each step's first looked-up pair (a warp prefix sum)
      if (pwarp == 0) {
        const int s = lane;
        const bool in = s < cn;
        const bool act = in && B.keep[s] && B.any[s];
        if (in) B.any[s] = 0;
        const unsigned am = __ballot_sync(kFull, act);
        const unsigned before = am & ((1u << s) - 1u);
        const int prev_s = before ? 31 - __clz(before) : -1;
        const float x = in ? B.x[s] : 0.0f, y = in ? B.y[s] : 0.0f;
        const float qx = __shfl_sync(kFull, x, prev_s < 0 ? 0 : prev_s);
        const float qy = __shfl_sync(kFull, y, prev_s < 0 ? 0 : prev_s);
        const float fx = prev_s < 0 ? px : qx, fy = prev_s < 0 ? py : qy;
        const float gx = __fsub_rn(x, fx), gy = __fsub_rn(y, fy);
        const float gc =
            __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
        const bool look = act && (prev_s >= 0 || prev_any) &&
                          gc <= p.breakage;
        const int prow = prev_s + 1;
        const int mine =
            look ? row_count(B, prow) * row_count(B, s + 1) : 0;
        int incl = mine;
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        if (in) {
          B.gc[s] = gc;
          B.prev[s] = prow;
          B.off[s] = incl - mine;
          B.flags[s] = (act ? kStepActive : 0) | (look ? kStepLook : 0);
          p.active[t0 + s] = act ? 1 : 0;
        }
        const int last = am ? 31 - __clz(am) : -1;
        if (last >= 0) {
          px = __shfl_sync(kFull, x, last);
          py = __shfl_sync(kFull, y, last);
          prev_any = true;
        }
        if (lane == 31) {
          B.misc[0] = last;
          B.misc[1] = incl;
        }
      }
      bar_sync(kBarProducers, P);
      RTT_MARK(3)
      // the chunk's transition blocks: the looked-up pairs in the order
      // step, previous slot, next slot, kInterleave searches a thread
      const int npairs = B.misc[1];
      for (int f0 = ptid; f0 < npairs; f0 += kInterleave * P) {
        const int* to[kInterleave];
        unsigned key[kInterleave];
        int hit[kInterleave], at[kInterleave];
        int pi[kInterleave], cj[kInterleave];
        bool ok[kInterleave];
#pragma unroll
        for (int u = 0; u < kInterleave; ++u) {
          const int f = f0 + u * P;
          ok[u] = f < npairs;
          to[u] = p.reach_to;
          key[u] = 0u;
          at[u] = pi[u] = cj[u] = 0;
          if (ok[u]) {
            // the step: the last whose first pair is at or before f, by
            // halving steps over the chunk's C <= 32 steps
            int lo = 0;
#pragma unroll
            for (int step = 16; step > 0; step >>= 1) {
              const int at = lo + step;
              const int o = B.off[min(at, cn - 1)];
              lo = at < cn && o <= f ? at : lo;
            }
            const int loc = f - B.off[lo];
            const int nc = row_count(B, lo + 1);
            const int ii = loc / nc, jj = loc - ii * nc;
            const int i = list_at(B, B.prev[lo] * K + ii);
            const int jn = list_at(B, (lo + 1) * K + jj);
            pi[u] = B.prev[lo] * K + i;
            cj[u] = (lo + 1) * K + jn;
            at[u] = lo * KK + i * K + jn;
            to[u] = p.reach_to + static_cast<size_t>(B.row[pi[u]]) * M;
            key[u] = static_cast<unsigned>(B.e[cj[u]]);
          }
        }
        rtt_route::search_rows<kInterleave, true>(to, key, ok, M, p.top,
                                                  hit);
#pragma unroll
        for (int u = 0; u < kInterleave; ++u) {
          if (!ok[u]) continue;
          const float gap =
              hit[u] >= 0
                  ? fminf(kBig,
                          __ldg(p.reach_dist +
                                static_cast<size_t>(B.row[pi[u]]) * M +
                                hit[u]))
                  : kBig;
          B.trans[at[u]] = rtt_route::transition_cost(
              B.e[pi[u]], B.len[pi[u]], B.o[pi[u]], B.e[cj[u]], B.o[cj[u]],
              gap, B.gc[at[u] / KK], p.beta, p.factor, p.slack);
        }
      }
      RTT_MARK(4)
      bar_arrive(kBarFull + b, P + MW);
    }
    RTT_PROFILE_END
    return;
  }

  if constexpr (kIsWide) {
    // ---- the wide instance's merge warps: the steps in order. Per active
    // step, first each looked-up column's smallest head (at R = 1 its
    // first argmin, the pick itself), G lanes a column over the looked-up
    // previous rows, the pair (value, row) reduced lexicographically; the
    // OR of their connections at a barrier gives `broken`. Then every
    // column not served by a tree (a restart, a column not looked up, R =
    // 1's pick) is written by the threads in turn, and at R > 1 each
    // looked-up column's R picks by its thread's loser tree, g columns at
    // once (as many trees of this step's N leaves as the region holds),
    // each thread's tree slot reused for its next column. A column's
    // carry row and the level's row are written as they are picked; the
    // level's own state from the heads, reduced at the step's barrier.
    const int warp = mtid >> 5, nmw = MW >> 5;
    const int RP = R | 1;
    constexpr int kRed = 2 * (kWideMerge / 32);   // a parity's words
    const bool rows_here = p.place & kPlaceRows;
    float* score0 = reinterpret_cast<float*>(
        rows_here ? smem + L.score0 : p.scratch + WS.score0);
    float* score1 = reinterpret_cast<float*>(
        rows_here ? smem + L.score1 : p.scratch + WS.score1);
    unsigned long long* trees = reinterpret_cast<unsigned long long*>(
        p.place & kPlaceTrees ? smem + L.tree : p.scratch + WS.tree);
    const int tree_nodes = p.tree_bytes / 8;
    const bool best_here = p.place & kPlaceBest;
    // the level's backpointers in shared rows (then copied out coalesced
    // with the carry rows), else each pick written straight out
    const bool level_here = p.place & kPlaceLevel;
    int* bpbuf =
        level_here ? reinterpret_cast<int*>(smem + L.bp) : nullptr;
    float* s_best = reinterpret_cast<float*>(
        best_here ? smem + L.best : p.scratch + WS.best);
    int* s_arg = reinterpret_cast<int*>(best_here ? smem + L.arg
                                                  : p.scratch + WS.arg);
    unsigned* red = reinterpret_cast<unsigned*>(smem + L.red);
    for (int s = mtid; s < K * RP; s += MW) score0[s] = kBig;
    bar_sync(kBarMerge, MW);
    int cur_b = 0;
    int own_cur = -1;
    for (int n = 0; n < nchunks; ++n) {
      const int b = n & 1, t0 = n * C, cn = min(C, T - t0);
      const Chunk B = chunk_of(b);
      const unsigned short* list =
          reinterpret_cast<const unsigned short*>(B.list);
      bar_sync(kBarFull + b, P + MW);
      RTT_MARK(5)
      for (int s = 0; s < cn; ++s) {
        const int t = t0 + s;
        const int fl = B.flags[s];
        const float* cur = cur_b ? score1 : score0;
        float* nxt = cur_b ? score0 : score1;
        float* out_s = p.scores + static_cast<size_t>(t) * KR;
        int* out_b = p.backptrs + static_cast<size_t>(t) * KR;
        if (!(fl & kStepActive)) {
          copy_level(cur, nullptr, K, R, RP, out_s, out_b, mtid, MW);
          if (mtid == 0) {
            p.started[t] = 0;
            p.own[t] = own_cur;
          }
          RTT_MARK(10)
          continue;
        }
        const bool look = (fl & kStepLook) != 0;
        const int prow = B.prev[s];
        const unsigned short* plist = list + prow * K;
        const unsigned short* clist = list + (s + 1) * K;
        const unsigned long long* jm = B.mask + (s + 1) * Wm;
        const int np = look ? row_count(B, prow) : 0;
        const int nc = np > 0 ? row_count(B, s + 1) : 0;
        const float* trs = B.trans + static_cast<size_t>(s) * KK;
        bool conn = false;
        {
          int G = 1;
          while (G < 32 && nc * G * 2 <= MW) G *= 2;
          const int sub = mtid % G;
          for (int jj0 = 0; jj0 < nc; jj0 += MW / G) {
            const int jj = jj0 + mtid / G;
            float best = CUDART_INF_F;
            int arg = K;
            const int c = jj < nc ? clist[jj] : 0;
            if (jj < nc) {
              // kFirst rows' loads at once (rows clamped, values selected)
              for (int i0 = sub; i0 < np; i0 += kFirst * G) {
                int cps[kFirst];
                float hv[kFirst], tv[kFirst];
#pragma unroll
                for (int u = 0; u < kFirst; ++u) {
                  cps[u] = plist[min(i0 + u * G, np - 1)];
                }
#pragma unroll
                for (int u = 0; u < kFirst; ++u) {
                  hv[u] = cur[static_cast<size_t>(cps[u]) * RP];
                  tv[u] = trs[static_cast<size_t>(cps[u]) * K + c];
                }
#pragma unroll
                for (int u = 0; u < kFirst; ++u) {
                  const float v = __fadd_rn(hv[u], tv[u]);
                  const bool better = i0 + u * G < np && v < best;
                  best = better ? v : best;
                  arg = better ? cps[u] : arg;
                }
              }
            }
            for (int o = G >> 1; o > 0; o >>= 1) {
              keep_min(best, arg, __shfl_xor_sync(kFull, best, o),
                       __shfl_xor_sync(kFull, arg, o));
            }
            if (jj < nc && sub == 0) {
              s_best[c] = best;
              s_arg[c] = arg;
              conn = conn || best < kBig;
            }
          }
        }
        RTT_MARK(6)
        // broken: no column connected, or the step does not look up (no
        // active point before, or past the breakage distance). The
        // barrier also holds the last level's copy out before this one.
        const bool broken = !bar_or(kBarMerge, MW, conn);
        RTT_MARK(7)
        unsigned hb = 0xffffffffu, hc = 0xffffffffu;
        for (int c = mtid; c < K; c += MW) {
          const bool lk = np > 0 && ((jm[c >> 6] >> (c & 63)) & 1ull);
          if (R > 1 && lk && !broken) continue;       // a tree's column
          const float em = B.em[(s + 1) * K + c];
          float* crow = nxt + static_cast<size_t>(c) * RP;
          float* os = level_here ? crow : out_s + c * R;
          int* ob = level_here ? bpbuf + c * RP : out_b + c * R;
          float head = kBig;
          int bp = -1;
          if (broken) {
            head = em;
          } else if (lk) {     // R = 1: the first pass's pick
            const float best = s_best[c];
            head = best < kBig ? __fadd_rn(best, em) : kBig;
            bp = best < kBig ? s_arg[c] : -1;
          }
          crow[0] = head;
          os[0] = head;
          ob[0] = bp;
          for (int r = 1; r < R; ++r) {
            crow[r] = kBig;
            os[r] = kBig;
            ob[r] = -1;
          }
          if (__float_as_uint(head) < hb) {
            hb = __float_as_uint(head);
            hc = c;
          }
        }
        if (R > 1 && !broken && nc > 0) {
          const int N = pow2_at_least(np);
          int depth = 0;
          while ((1 << depth) < N) ++depth;
          // g trees at a time, node n of thread i's at n * W + i (W a
          // multiple of 16 where the region holds it: a warp's lanes then
          // read distinct banks whatever nodes they read)
          const int g = min(min(nc, MW), tree_nodes / N);
          const int W = ((g + 15) & ~15) * N <= tree_nodes ? (g + 15) & ~15
                                                           : g;
          unsigned long long* tree = trees + mtid;
          for (int jj = mtid; jj < nc && mtid < g; jj += g) {
            const int c = clist[jj];
            const float em = B.em[(s + 1) * K + c];
            const float head = wide_column_at(
                depth, cur, trs + c, plist, np, K, R, em, tree, W,
                nxt + static_cast<size_t>(c) * RP,
                level_here ? nullptr : out_s + c * R,
                level_here ? bpbuf + c * RP : out_b + c * R);
            if (__float_as_uint(head) < hb ||
                (__float_as_uint(head) == hb &&
                 static_cast<unsigned>(c) < hc)) {
              hb = __float_as_uint(head);
              hc = c;
            }
          }
        }
        RTT_MARK(8)
        // the level's own state: the first minimal head over the columns
        const unsigned wm = __reduce_min_sync(kFull, hb);
        const unsigned wi = __reduce_min_sync(kFull, hb == wm ? hc : kFull);
        if (lane == 0) {
          red[cur_b * kRed + warp * 2] = wm;
          red[cur_b * kRed + warp * 2 + 1] = wi;
        }
        bar_sync(kBarMerge, MW);
        RTT_MARK(9)
        if (level_here) {
          // the level, coalesced: the carry's rows and the backpointers
          copy_level(nxt, bpbuf, K, R, RP, out_s, out_b, mtid, MW);
        }
        if (mtid == 0) {
          unsigned bm = kFull, bi = kFull;
          for (int w = 0; w < nmw; ++w) {
            const unsigned om = red[cur_b * kRed + w * 2];
            const unsigned oi = red[cur_b * kRed + w * 2 + 1];
            if (om < bm || (om == bm && oi < bi)) {
              bm = om;
              bi = oi;
            }
          }
          own_cur = __uint_as_float(bm) < kBig ? static_cast<int>(bi) * R : -1;
          p.own[t] = own_cur;
          p.started[t] = broken ? 1 : 0;
        }
        cur_b ^= 1;
        RTT_MARK(10)
      }
      if (n + 2 < nchunks) bar_arrive(kBarFree + b, P + MW);
    }
    RTT_PROFILE_END
  } else {
    // ---- the merge warps: the steps in order, a thread a column
    const int c = mtid, warp = mtid >> 5, nmw = MW >> 5;
    const bool col = c < K;
    const int RP = R | 1;
    float* score0 = reinterpret_cast<float*>(smem + L.score0);
    float* score1 = reinterpret_cast<float*>(smem + L.score1);
    int* bpbuf = reinterpret_cast<int*>(smem + L.bp);
    unsigned long long* tree =
        reinterpret_cast<unsigned long long*>(smem + L.tree) + c;
    unsigned* red = reinterpret_cast<unsigned*>(smem + L.red);
    const int W = tree_pitch(K);
    for (int s = mtid; s < K * RP; s += MW) score0[s] = kBig;
    auto merge_sync = [&]() {
      if (MW == 32) {
        __syncwarp();
      } else {
        bar_sync(kBarMerge, MW);
      }
    };
    merge_sync();
    int cur_b = 0;
    int own_cur = -1;            // the carry's own state (the first thread's)
    for (int n = 0; n < nchunks; ++n) {
      const int b = n & 1, t0 = n * C, cn = min(C, T - t0);
      const Chunk B = chunk_of(b);
      bar_sync(kBarFull + b, P + MW);
      RTT_MARK(5)
      for (int s = 0; s < cn; ++s) {
        const int t = t0 + s;
        const int fl = B.flags[s];
        const float* cur = cur_b ? score1 : score0;
        float* nxt = cur_b ? score0 : score1;
        float* out_s = p.scores + static_cast<size_t>(t) * KR;
        int* out_b = p.backptrs + static_cast<size_t>(t) * KR;
        if (!(fl & kStepActive)) {
          // an inactive point passes the carry through: the level is the
          // carry with identity backpointers, written coalesced
          copy_level(cur, nullptr, K, R, RP, out_s, out_b, mtid, MW);
          if (mtid == 0) {
            p.started[t] = 0;
            p.own[t] = own_cur;
          }
          continue;
        }
        const bool look = (fl & kStepLook) != 0;
        const float em = col ? B.em[(s + 1) * K + c] : 0.0f;
        // the previous slots looked up with this column's slot
        const unsigned long long seen =
            look && col && ((B.mask[s + 1] >> c) & 1ull) ? B.mask[B.prev[s]]
                                                          : 0ull;
        const float* tr = B.trans + s * KK + c;
        float best = CUDART_INF_F;
        int arg = 0;
        unsigned long long win = kSpent;
        if constexpr (LOG == 0) {
          if (look && col) {
            // the first minimal row, eight rows' loads at once
            for (int cp0 = 0; cp0 < K; cp0 += 8) {
              float hv[8], tv[8];
  #pragma unroll
              for (int u = 0; u < 8; ++u) {
                hv[u] = cur[min(cp0 + u, K - 1)];
                tv[u] = trans_of(tr, K, seen, cp0 + u);
              }
  #pragma unroll
              for (int u = 0; u < 8; ++u) {
                const int cp = cp0 + u;
                const float v = __fadd_rn(hv[u], tv[u]);
                const bool better = cp < K && v < best;
                best = better ? v : best;
                arg = better ? cp : arg;
              }
            }
          }
        }
        if constexpr (LOG > 0) {
          if (look && col) {
            win = tree_build<(1 << LOG)>(cur, tr, seen, K, RP, 0, 1, tree, W);
            best = __uint_as_float(static_cast<unsigned>(win >> 32));
          }
        }
        const bool conn = best < kBig;
        RTT_MARK(6)
        // broken: no column connected, or the step does not look up (no
        // active point before, or past the breakage distance). Either way a
        // barrier here: the last level's copy out is done before this one
        // is written.
        bool any = false;
        if (look) {
          any = MW == 32 ? __any_sync(kFull, conn)
                         : bar_or(kBarMerge, MW, conn);
        } else {
          merge_sync();
        }
        const bool broken = !any;
        RTT_MARK(7)
        // the new carry and the level: restart [em, BIG, ...], or the picks
        // plus the emission where connected
        float head = CUDART_INF_F;
        if (col) {
          float* crow = nxt + c * RP;
          if constexpr (LOG == 0) {
            int bp;
            if (broken) {
              head = em;
              bp = -1;
            } else {
              head = conn ? __fadd_rn(best, em) : kBig;
              bp = conn ? arg : -1;
            }
            crow[0] = head;
            out_s[c] = head;
            out_b[c] = bp;
          } else {
            int* brow = bpbuf + c * RP;
            if (broken) {
              for (int r = 0; r < R; ++r) {
                crow[r] = r == 0 ? em : kBig;
                brow[r] = -1;
              }
              head = em;
            } else {
              head = column_picks<LOG>(win, cur, tr, seen, K, R, em, tree, W,
                                       crow, brow);
            }
          }
        }
        // the level's own state: the first minimal row head (rows ascend),
        // by the warp's minimum of the heads' bits, then of the columns that
        // hold it; warps combined through shared words of this step's parity
        const unsigned hb = col ? __float_as_uint(head) : 0xffffffffu;
        const unsigned wm = __reduce_min_sync(kFull, hb);
        const unsigned wi =
            __reduce_min_sync(kFull, hb == wm ? c : 0xffffffffu);
        if (nmw > 1 && lane == 0) {
          red[cur_b * 4 + warp * 2] = wm;
          red[cur_b * 4 + warp * 2 + 1] = wi;
        }
        RTT_MARK(8)
        merge_sync();
        RTT_MARK(9)
        if constexpr (LOG > 0) {
          // the level, coalesced: the carry's rows and the backpointers
          copy_level(nxt, bpbuf, K, R, RP, out_s, out_b, mtid, MW);
        }
        if (mtid == 0) {
          unsigned bm = wm, bi = wi;
          for (int w = 1; w < nmw; ++w) {
            const unsigned om = red[cur_b * 4 + w * 2];
            if (om < bm) {
              bm = om;
              bi = red[cur_b * 4 + w * 2 + 1];
            }
          }
          own_cur = __uint_as_float(bm) < kBig ? static_cast<int>(bi) * R : -1;
          p.own[t] = own_cur;
          p.started[t] = broken ? 1 : 0;
        }
        cur_b ^= 1;
        RTT_MARK(10)
      }
      if (n + 2 < nchunks) bar_arrive(kBarFree + b, P + MW);
    }
    RTT_PROFILE_END
  }
}

// ---- the backtrack -------------------------------------------------------

// The backtrack CTA's shared memory (ops/hmm.py::backtrack_smem_bytes makes
// the same sum): NS slots of G levels (backpointer rows [G, S], own [G],
// and the started and active bytes of the 16-aligned span around the G
// levels), a full and a free mbarrier a slot, and the walkers' staged
// choices [walkers][33] (32 levels, padded).
struct BtLayout {
  int bp, own, st, ac, slot, full, free, out, bytes;
};

__host__ __device__ inline BtLayout make_bt_layout(int S, int P, int G,
                                                   int NS) {
  BtLayout L{};
  int at = 0;
  L.bp = take(at, 4 * G * S);
  L.own = take(at, 4 * G);
  L.st = take(at, G + 32);
  L.ac = take(at, G + 32);
  L.slot = at;
  at = NS * L.slot;
  L.full = take(at, 8 * NS);
  L.free = take(at, 8 * NS);
  L.out = take(at, 4 * 33 * 32 * ((P + 31) / 32));
  L.bytes = at;
  return L;
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (16-aligned, a multiple of 16) from global src to shared dst,
// completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

struct BtParams {
  const int* backptrs;         // i32 [T, S]
  const unsigned char* started;
  const unsigned char* active;
  const int* own;              // i32 [T]
  const int* seed;             // i32 [P]
  int T, S, P, G, NS;
  int* out;                    // i32 [P, T]
};

// a CTA of at most 1,024 threads: the producer warp and kMaxWalkers
// walker warps (the plan launches as many walkers as cover P, up to that)
__global__ void __launch_bounds__(32 * (kMaxWalkers + 1), 1)
    lattice_backtrack_kernel(const BtParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = p.T, S = p.S, G = p.G, NS = p.NS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int walkers = (blockDim.x >> 5) - 1;     // walker warps
  const int q0 = blockIdx.x * walkers * 32;      // the CTA's first path
  const BtLayout L = make_bt_layout(S, 32 * walkers, G, NS);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + L.full);
  unsigned long long* free_ =
      reinterpret_cast<unsigned long long*>(smem + L.free);
  const int J = (T + G - 1) / G;                  // blocks, streamed J-1..0
  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + i, 32);
      mbar_init(free_ + i, walkers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // ---- the producer warp: block j (levels [jG, jG + G)) into slot
    // (J - 1 - j) % NS once the walkers have freed it
    for (int seq = 0; seq < J; ++seq) {
      const int j = J - 1 - seq, slot = seq % NS;
      if (seq >= NS) mbar_wait(free_ + slot, ((seq / NS) - 1) & 1);
      unsigned char* base = smem + static_cast<size_t>(slot) * L.slot;
      const int lo = j * G, hi = min(T, lo + G), n = hi - lo;
      const int lo8 = lo & ~15, hi8 = (hi + 15) & ~15;
      if (hi8 <= T && ((n * S) & 3) == 0 && (n & 3) == 0) {
        const unsigned bp_bytes = 4u * n * S, own_bytes = 4u * n;
        const unsigned fl_bytes = hi8 - lo8;
        if (lane == 0) {
          mbar_arrive_tx(full + slot, bp_bytes + own_bytes + 2 * fl_bytes);
          bulk_copy(base + L.bp, p.backptrs + static_cast<size_t>(lo) * S,
                    bp_bytes, full + slot);
          bulk_copy(base + L.own, p.own + lo, own_bytes, full + slot);
          bulk_copy(base + L.st, p.started + lo8, fl_bytes, full + slot);
          bulk_copy(base + L.ac, p.active + lo8, fl_bytes, full + slot);
        } else {
          mbar_arrive(full + slot);
        }
      } else {
        // a block whose bytes do not align (near the end): loads
        int* bp = reinterpret_cast<int*>(base + L.bp);
        const int* src = p.backptrs + static_cast<size_t>(lo) * S;
        for (int x = lane; x < n * S; x += 32) bp[x] = src[x];
        for (int x = lane; x < n; x += 32) {
          reinterpret_cast<int*>(base + L.own)[x] = p.own[lo + x];
          base[L.st + lo - lo8 + x] = p.started[lo + x];
          base[L.ac + lo - lo8 + x] = p.active[lo + x];
        }
        // ordered before later bulk copies into the slot
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(full + slot);
      }
    }
    return;
  }

  // ---- the walkers: a thread a path, T levels down, block by block.
  // Per level one dependent shared read (the row above at the path's
  // state); the level's own state and flags are read apart from it.
  const int q = q0 + tid - 32;
  const bool walks = q < p.P;
  int* stage = reinterpret_cast<int*>(smem + L.out) + (warp - 1) * 32 * 33;
  int nxt = walks ? p.seed[q] : -1;  // the state the row above points at
  bool nxt_started = false;
  const int* above = nullptr;        // the row above (none at T - 1)
  for (int seq = 0; seq < J; ++seq) {
    const int slot = seq % NS, lo = (J - 1 - seq) * G;
    const int hi = min(T, lo + G), lo8 = lo & ~15;
    mbar_wait(full + slot, (seq / NS) & 1);
    const unsigned char* blk = smem + static_cast<size_t>(slot) * L.slot;
    const int* bp = reinterpret_cast<const int*>(blk + L.bp);
    const int* own = reinterpret_cast<const int*>(blk + L.own) - lo;
    const unsigned char* st = blk + L.st - lo8;
    const unsigned char* ac = blk + L.ac - lo8;
    for (int t = hi - 1; t >= lo; --t) {
      int own_t;
      asm volatile("ld.shared.s32 %0, [%1];"
                   : "=r"(own_t)
                   : "r"(smem_u32(own + t)));
      const bool st_t = st[t] != 0, ac_t = ac[t] != 0;
      int prop = nxt;
      if (above) {
        const int v = above[max(nxt, 0)];
        prop = nxt >= 0 ? v : -1;
      }
      // a chain terminal re-seeds from the level's own argmin
      const int choice = (nxt_started || nxt < 0) ? own_t : prop;
      stage[(q & 31) * 33 + (t & 31)] = ac_t ? choice : -1;
      nxt = choice;
      nxt_started = st_t;
      above = bp + (t - lo) * S;
      if (t == hi - 1 && seq > 0) {
        // the block above (its row hi just read) is done: free its slot
        __syncwarp();
        if (lane == 0) mbar_arrive(free_ + (seq - 1) % NS);
      }
      if ((t & 31) == 0) {
        // levels [t, t + 32) of the warp's paths, a path a row, coalesced
        __syncwarp();
        const int base_q = q0 + (warp - 1) * 32;
        for (int r = 0; r < 32; ++r) {
          const int qq = base_q + r;
          if (qq < p.P && t + lane < T) {
            p.out[static_cast<size_t>(qq) * T + t + lane] =
                stage[r * 33 + lane];
          }
        }
        __syncwarp();
      }
    }
  }
}

// The backtrack where a level is too wide for the ring's slots (two of
// four levels past the CTA's shared memory): a thread a path, each level's
// flags, own state and the one backpointer its path follows read in place
// from global memory (a dependent L2 read a level), the choices written
// straight out. The same steps as the ring's walkers, in the same order.
__global__ void __launch_bounds__(1024)
    lattice_backtrack_global_kernel(const BtParams p) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p.P) return;
  const int T = p.T, S = p.S;
  int nxt = p.seed[q];
  bool nxt_started = false;
  for (int t = T - 1; t >= 0; --t) {
    int prop = nxt;
    if (t + 1 < T) {
      const int v =
          p.backptrs[static_cast<size_t>(t + 1) * S + max(nxt, 0)];
      prop = nxt >= 0 ? v : -1;
    }
    const int choice = (nxt_started || nxt < 0) ? p.own[t] : prop;
    p.out[static_cast<size_t>(q) * T + t] = p.active[t] ? choice : -1;
    nxt = choice;
    nxt_started = p.started[t] != 0;
  }
}

// more than 48 KB of dynamic shared memory needs the attribute, set once
// per device
template <typename F>
int allow_smem(F* kernel, std::atomic<unsigned long long>& set) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  const unsigned long long bit = 1ull << dev;
  if (!(set.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set.fetch_or(bit);
  }
  return 0;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<unsigned long long>(ptr) & 15ull) == 0;
}

// one forward launch of the LOG instance (its shared-memory attribute set
// once per device)
template <int LOG>
int launch_forward(const FwdParams& p, int smem_bytes, void* stream) {
  static std::atomic<unsigned long long> attribute_set{0};
  const int rc = allow_smem(lattice_forward_kernel<LOG>, attribute_set);
  if (rc != 0) return rc;
  lattice_forward_kernel<LOG><<<1, p.P + p.MW, smem_bytes,
                                static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the forward's one ceiling on K is the shared memory: false where an
// array alone outgrows it (a buffer's candidate rows' flags; the wide
// instance's blocks, carried rows or trees where `place` keeps them
// there), checked in 64 bits before make_layout's 32-bit offsets could
// wrap. The wide instance's trees (R > 1) take a region of `tree_bytes`,
// a multiple of 16 that holds at least one column's tree at K leaves
// (N - 1 < pow2(K) nodes); R = 1 and the shared instances take none. Its
// level's backpointers stay in shared memory only at R > 1 beside the
// carried rows.
bool forward_fits(int K, int R, int C, int place, int tree_bytes) {
  if ((C + 1ll) * K > kMaxSmem) return false;
  if (K <= kMaxK) return place == 0 && tree_bytes == 0;
  if (place < 0 || place > 31 || tree_bytes < 0 || tree_bytes % 16) {
    return false;
  }
  if (((place & kPlaceBlocks) && 8ll * C * K * K > kMaxSmem) ||
      ((place & kPlaceRows) && 8ll * K * (R | 1) > kMaxSmem) ||
      ((place & kPlaceLevel) && 4ll * K * (R | 1) > kMaxSmem) ||
      ((place & kPlaceTrees) && tree_bytes > kMaxSmem)) {
    return false;
  }
  if ((place & kPlaceLevel) && (R == 1 || !(place & kPlaceRows))) {
    return false;
  }
  return R > 1 ? tree_bytes >= 8ll * pow2_at_least(K)
               : tree_bytes == 0 && !(place & kPlaceTrees);
}

}  // namespace

// The keep mask of B traces (pts f32 [B, T, 2], vp u8 [B, T]) into keep u8
// [B, T]; d2_min is f32(interp)^2. Returns cudaGetLastError() after the
// launch, or -1 for a shape it does not take.
extern "C" int rtt_lattice_keep(const float* pts, const unsigned char* vp,
                                int B, int T, float d2_min,
                                unsigned char* keep, void* stream) {
  if (B < 1 || T < 1) return -1;
  // a thread a point of the first tile, whole warps
  const int threads = min(kKeepMaxThreads, (min(T, kKeepTile) + 31) / 32 * 32);
  lattice_keep_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, vp, T, d2_min, keep);
  return static_cast<int>(cudaGetLastError());
}

// The forward kernel's shared bytes at (K, R) and chunk C (at most 32: a
// lane a step of the control sequence), the wide instance's placement
// `place` and trees' region `tree_bytes` (0 and 0 at K <= kMaxK), -1 for a
// shape it does not take (ops/hmm.py::lattice_smem_bytes is held to it on
// the card).
extern "C" int rtt_lattice_forward_smem(int K, int R, int C, int place,
                                        int tree_bytes) {
  if (K < 1 || R < 1 || R > K || C < 1 || C > 32 ||
      !forward_fits(K, R, C, place, tree_bytes)) {
    return -1;
  }
  return make_layout(K, R, C, place, tree_bytes).bytes;
}

// The wide forward's global scratch bytes (K > kMaxK; -1 for another
// shape, or past 2^31 - 1 bytes): what ops/hmm.py::lattice_scratch_bytes is
// held to on the card.
extern "C" int rtt_lattice_forward_scratch(int K, int R, int C, int place,
                                           int tree_bytes) {
  if (K <= kMaxK || R < 1 || R > K || C < 1 || C > 32 ||
      !forward_fits(K, R, C, place, tree_bytes)) {
    return -1;
  }
  const size_t n = make_wide_scratch(K, R, C, place, tree_bytes).bytes;
  return n > 0x7fffffffu ? -1 : static_cast<int>(n);
}

// The forward pass of one trace from its candidates (ce i32, co f32, cd
// f32, cv u8 [T, K]), points f32 [T, 2], keep mask u8 [T] and reach tables
// (edge_len f32 [E], reach_row i32 [E], reach_to i32 and reach_dist f32
// [rows, M]) → scores f32 [T, K * R], backptrs i32 [T, K * R], started u8
// [T], own i32 [T], active u8 [T]: one CTA of `producers` + `merge`
// threads with `smem_bytes` of shared memory (the layout's at chunk C, or
// -1); past kMaxK the wide instance, 256 producers and kWideMerge merge
// threads, what `place` keeps in shared memory and its trees' region of
// `tree_bytes` (R > 1), the rest in `scratch` (make_wide_scratch's bytes,
// null where there are none; null at K <= kMaxK, where `place` and
// `tree_bytes` are 0). The floats are f32(2 sigma_z^2) and the matcher's
// constants.
// Returns cudaGetLastError() after the launch, or -1 for a shape or plan
// it does not take.
extern "C" int rtt_lattice_forward(
    const int* ce, const float* co, const float* cd, const unsigned char* cv,
    const float* pts, const unsigned char* keep, const float* edge_len,
    const int* reach_row, const int* reach_to, const float* reach_dist,
    int T, int K, int R, int M, int chunk, int producers, int merge,
    int place, int tree_bytes, int smem_bytes, float em_denom, float beta,
    float factor,
    float breakage, float slack, unsigned char* scratch, float* scores,
    int* backptrs, unsigned char* started, int* own, unsigned char* active,
    void* stream) {
  if (T < 1 || K < 1 || R < 1 || R > K || M < 1 || chunk < 1 ||
      chunk > 32 || !forward_fits(K, R, chunk, place, tree_bytes)) {
    return -1;
  }
  const bool wide = K > kMaxK;
  const int columns = 32 * ((K + 31) / 32);
  if (wide ? merge != kWideMerge || producers != 256 ||
                 (make_wide_scratch(K, R, chunk, place, tree_bytes).bytes >
                  0) != (scratch != nullptr)
           : merge != columns || producers < 32 || producers % 32 ||
                 producers + merge > kMaxThreads) {
    return -1;
  }
  if (smem_bytes != make_layout(K, R, chunk, place, tree_bytes).bytes ||
      smem_bytes > kMaxSmem) {
    return -1;
  }
  // the level's vector writes: 16-aligned outputs
  if (!aligned16(scores) || !aligned16(backptrs) || !aligned16(scratch)) {
    return -1;
  }
  int top = 1;
  while (top <= M / 2) top *= 2;
  FwdParams p{ce,       co,        cd,       cv,         pts,
              keep,     edge_len,  reach_row, reach_to,  reach_dist,
              T,        K,         R,        M,          top,
              chunk,    producers, merge,    em_denom,   beta,
              factor,   breakage,  slack,    scores,     backptrs,
              started,  own,       active,   scratch,    place,
              tree_bytes};
  if (wide) return launch_forward<kWide>(p, smem_bytes, stream);
  int lg = 0;
  while (R > 1 && (1 << lg) < K) ++lg;
  switch (lg) {
    case 0: return launch_forward<0>(p, smem_bytes, stream);
    case 1: return launch_forward<1>(p, smem_bytes, stream);
    case 2: return launch_forward<2>(p, smem_bytes, stream);
    case 3: return launch_forward<3>(p, smem_bytes, stream);
    case 4: return launch_forward<4>(p, smem_bytes, stream);
    case 5: return launch_forward<5>(p, smem_bytes, stream);
    default: return launch_forward<6>(p, smem_bytes, stream);
  }
}

// The backtrack's shared bytes for S states a level, P paths a CTA (at
// most kMaxWalkers warps), slots of G levels and NS slots, -1 for a shape
// it does not take (ops/hmm.py::backtrack_smem_bytes is held to it on the
// card).
extern "C" int rtt_lattice_backtrack_smem(int S, int P, int G, int NS) {
  if (S < 1 || P < 1 || P > 32 * kMaxWalkers || G < 4 || G % 4 || NS < 2) {
    return -1;
  }
  return make_bt_layout(S, P, G, NS).bytes;
}

// The backtrack of P paths through T levels of S states: backptrs i32 [T,
// S], started, active u8 [T], own i32 [T], seed i32 [P] (each in [-1, S))
// → out i32 [P, T]. The ring (G >= 4, NS >= 2): CTAs of a producer warp
// and threads / 32 - 1 walker warps (at most kMaxWalkers), as many as
// cover P, a ring of NS
// slots of G levels in `smem_bytes` (the layout's, or -1); the four level
// arrays 16-aligned. The levels read in place (G = NS = 0, smem_bytes 0):
// CTAs of `threads` threads, a path each. Returns cudaGetLastError()
// after the launch, or -1 for a shape or plan it does not take.
extern "C" int rtt_lattice_backtrack(const int* backptrs,
                                     const unsigned char* started,
                                     const unsigned char* active,
                                     const int* own, const int* seed, int T,
                                     int S, int P, int G, int NS,
                                     int threads, int smem_bytes, int* out,
                                     void* stream) {
  if (T < 1 || S < 1 || P < 1 || threads < 32 || threads % 32 ||
      threads > 1024) {
    return -1;
  }
  BtParams p{backptrs, started, active, own, seed, T, S, P, G, NS, out};
  if (G == 0 && NS == 0) {
    if (smem_bytes != 0) return -1;
    lattice_backtrack_global_kernel<<<(P + threads - 1) / threads, threads,
                                      0, static_cast<cudaStream_t>(stream)>>>(
        p);
    return static_cast<int>(cudaGetLastError());
  }
  const int walkers = threads / 32 - 1;
  if (walkers < 1 || walkers > kMaxWalkers || G < 4 || G % 4 || NS < 2) {
    return -1;
  }
  if (smem_bytes != make_bt_layout(S, 32 * walkers, G, NS).bytes ||
      smem_bytes > kMaxSmem) {
    return -1;
  }
  if (!aligned16(backptrs) || !aligned16(started) || !aligned16(active) ||
      !aligned16(own)) {
    return -1;
  }
  const int grid = (P + 32 * walkers - 1) / (32 * walkers);
  static std::atomic<unsigned long long> attribute_set{0};
  const int rc = allow_smem(lattice_backtrack_kernel, attribute_set);
  if (rc != 0) return rc;
  lattice_backtrack_kernel<<<grid, threads, smem_bytes,
                             static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
