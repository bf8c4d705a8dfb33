// The batched HMM Viterbi decode for Hopper (sm_90a): for each trace of a
// batch, the keep mask, the emission costs, the forward pass over the
// candidate lattice, the backtrack, the gather of the chosen candidates'
// (edge, offset) and the interpolation fill, in one launch.
//
// Replaces reporter_tpu/ops/hmm.py:112-265, viterbi_decode_batched: four
// lax.scan loops (the keep mask :93-109, the forward pass :208, the
// backtrack :230, the interpolation fill :254), not a Pallas kernel. XLA
// compiles each scan into an on-device loop; the port's plain version
// (ops/hmm.py::_viterbi_plain) steps them from the host, some 13,000
// small launches per wire entry. This kernel is that plain version's
// arithmetic, one rounding per operation in its order (the intrinsics
// below, and -fmad=false), so it is bit-equal to it in all five outputs.
//
// What bounds it on this card: latency, not operations or bytes. The work
// of a step is the [K, K] transition block, each entry a lookup of the
// previous candidate's reach row (M target edge ids, 128 by default) for
// the next candidate's edge; the bytes are small (the candidates and
// points once, the reach rows from L2). The steps of a trace are
// sequential, so what can run in parallel is the batch and the lookups;
// a trace's time is its steps' chains of dependent L2 probes and
// barriers (scripts/viterbi_profile.py times each phase).
//
// The design rests on two facts:
//
// - The transition block of step t depends only on the candidates of t,
//   those of the previous active point p(t) and the distance gc(t)
//   between the two points. p(t), active, keep and gc follow from the
//   points, valid_pt and the candidates' validity alone, never from the
//   scores. So the lookups of a whole chunk of steps can be in flight at
//   once; only the K-wide min-plus step per t (score + trans, the first
//   argmin over i, the connected / broken rules) walks the steps.
// - Every reach row holds strictly ascending target edge ids with the -1
//   padding at the end (tiles/reach.py, native/reach.cc; host_tables in
//   tiles/tileset.py refuses a row that does not). Read as unsigned, -1
//   sorts past every real id, so a lookup is a binary search of
//   ceil(log2(M + 1)) probes (8 at M = 128), not a scan of M entries. A
//   row holds an id at most once, so the hit's distance is the plain
//   version's masked minimum bit for bit. The kernel does not check the
//   order: reading the tables here would cost what the search saves.
//
// The kernel, per trace (a group of `tpt` threads, 64 or 128; CTAs of
// 128 threads, so two traces share one up to K = 32, each group with its
// own named barrier, bar.sync id, tpt), chunk by chunk of C steps
// (ops/hmm.py::viterbi_plan owns the launch shape: tpt, the recurrence's
// threads, C, where the levels live and the shared bytes, which the C
// entry checks against this layout):
//
// 1. Staging: the chunk's candidates (edge, offset, emission, validity,
//    each edge's reach row and length), points and valid_pt go to shared
//    memory with coalesced loads, rows 1..C of the candidate arrays; row
//    0 holds the carry, the candidates of the last active point before
//    the chunk. Then each row's looked-up slots (valid, with an edge), in
//    order and as a 64-bit mask, a row a warp by ballots.
// 2. The control sequence: one thread walks the chunk's steps for keep
//    (the last kept point), active, gc from the previous active point
//    (__fsub_rn, __fmul_rn, __fadd_rn, __fsqrt_rn in the plain order),
//    prev_any and p(t), and writes a record per step with the offset of
//    its first looked-up pair.
// 3. The transition blocks: only the pairs (t, i, j) that are looked up
//    (a step that looks up: active, an active point before, gc <=
//    breakage; both slots valid with an edge) are enumerated, in the
//    order t, i, j (so a warp's lanes mostly search one row), and spread
//    over the group's threads, kInterleave independent binary searches
//    of the rows in global memory a thread at a time. Empty and invalid
//    slots make this a fraction of the K^2 grid (on the sf fleet's first
//    wire slice 40% at K = 8, 12% at K = 64: chip_smoke.py's
//    lattice_pairs). The route, the detour guard and the cost follow as
//    in the plain version (route.cuh's search_rows and transition_cost,
//    shared with lattice.cu); the block [C, K,
//    K] lands in shared memory, and a pair not looked up reads as BIG
//    through the rows' masks.
// 4. The recurrence, per step, on the first rt threads (one warp up to
//    K = 16, else two lanes a column): for each column j the first
//    minimal i of score[i] + trans (G lanes a column, the pair (value,
//    index) reduced lexicographically, which equals the plain first
//    argmin), then connected, broken, the new scores, the backpointers
//    and the level's own first argmin. Two barriers a step (__syncwarp
//    for one warp).
// 5. The levels: a backpointer byte per slot (0xff for -1) and a 16-bit
//    word per level (own argmin + 1, keep, active, started); an inactive
//    level writes its word alone (the backtrack reads its identity from
//    the active bit). They stay in shared memory where the plan says
//    they fit, else in the global scratch the wrapper allocates (u16
//    [B, T] words, then u8 [B, T, K]), staged back into the chunk's
//    space block by block for the backtrack.
// 6. The backtrack: one thread, serial over T, from shared memory; its
//    choices i8 [T] in shared memory beside shared levels, else straight
//    into out_choice, so with global levels nothing in shared memory
//    grows with T and any T >= 1 launches. The gather and the
//    interpolation fill: the same thread's warp, 32 levels at a time, the
//    last matched level by a ballot, the five [B, T] outputs written
//    coalesced.

//
// Those are viterbi_decode_kernel, instance 0, K <= 64 (kMaxK: a row's
// looked-up slots one 64-bit mask word, u8 slots and backpointers). Past
// it, viterbi_decode_wide_kernel<I> (instance I = 1: u8 backpointers to K =
// 254, beside the 0xff "none"; instance 2: u16) runs the same stages,
// one trace a CTA of kWideThreads, redesigned for what a wide list costs:
// - a chunk of C steps is sized by the candidate rows' bytes, not by K^2
//   (ops/hmm.py::viterbi_plan), so a chunk's lookups, kWideInterleave
//   binary searches in flight a thread, cover many steps at once;
// - the looked-up pairs' costs are kept compact, f32 [P] in the order
//   step, previous slot, next slot, not as [K, K] blocks: P is the pass's
//   pair budget, and a chunk whose pairs pass it is looked up in passes of
//   P, the steps done as their pairs complete (a step whose pairs straddle
//   two passes keeps each column's first minimum so far, s_bv / s_bi);
// - the recurrence reads only the looked-up pairs: each looked-up column
//   of the step takes G lanes (as many as the CTA's threads cover, up to
//   32) over the previous row's looked-up slots, the pair (value, slot)
//   reduced lexicographically. A slot not looked up adds BIG to a score
//   >= 0, never below a connected best, so the first argmin is the plain
//   version's over all K; an unconnected column's value is BIG either way;
// - a level word is u32 (own + 1 in the low 16 bits), a choice i32, the
//   levels in shared memory where the plan's budget keeps four CTAs an
//   SM, else in the global scratch; a CTA's shared memory is some 40-56 KB
//   to K = 128, so several traces share an SM and hide each other's waits.

#include <atomic>
#include <type_traits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "route.cuh"

namespace {

constexpr int kMaxK = 64;
constexpr int kMaxThreads = 128;     // a CTA's threads, every group's
constexpr int kMaxSmem = 232448;     // a CTA's shared memory on sm_90
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kInterleave = 4;       // binary searches in flight a thread
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

// the level word: the level's own first argmin + 1 in the low byte
constexpr unsigned kKeepBit = 1u << 8;
constexpr unsigned kActiveBit = 1u << 9;
constexpr unsigned kStartedBit = 1u << 10;
constexpr unsigned char kNoPointer = 0xff;

// a step's record from the control sequence
constexpr int kStepActive = 1;
constexpr int kStepKeep = 2;
constexpr int kStepPrevAny = 4;
constexpr int kStepLook = 8;         // active, prev_any, gc <= breakage

// A trace group's shared memory, in bytes from its base, each array 16
// aligned (ops/hmm.py::viterbi_smem_bytes makes the same sum, which the
// launch checks). [0, stage) is the chunk, which the backtrack reuses to
// stage global levels. With the levels global nothing grows with T: the
// choices go straight to out_choice.
struct Layout {
  int trans, o, em, len, e, row, v, list, mask, stage;
  int score, x, y, gc, prev, off, red_v, red_i, conn, misc, flags, vp, any;
  int choice, word, bp, bytes;
};

__host__ __device__ inline int take(int& at, int n) {
  const int o = at;
  at += (n + 15) & ~15;
  return o;
}

__host__ __device__ inline Layout make_layout(int K, int C, int T,
                                              bool levels_here) {
  Layout L{};
  int at = 0;
  const int rows = (C + 1) * K;
  L.trans = take(at, 4 * C * K * K);
  L.o = take(at, 4 * rows);
  L.em = take(at, 4 * rows);
  L.len = take(at, 4 * rows);
  L.e = take(at, 4 * rows);
  L.row = take(at, 4 * rows);
  L.v = take(at, rows);
  L.list = take(at, rows);
  L.mask = take(at, 8 * (C + 1));
  L.stage = at;
  L.score = take(at, 4 * K);
  L.x = take(at, 4 * C);
  L.y = take(at, 4 * C);
  L.gc = take(at, 4 * C);
  L.prev = take(at, 4 * C);
  L.off = take(at, 4 * C);
  L.red_v = take(at, 4 * kMaxWarps);
  L.red_i = take(at, 4 * kMaxWarps);
  L.conn = take(at, 4 * kMaxWarps);
  L.misc = take(at, 4 * kMaxWarps);
  L.flags = take(at, C);
  L.vp = take(at, C);
  L.any = take(at, C);
  L.choice = levels_here ? take(at, T) : -1;
  L.word = levels_here ? take(at, 2 * T) : -1;
  L.bp = levels_here ? take(at, T * K) : -1;
  L.bytes = at;
  return L;
}

// levels the backtrack stages at once from the global scratch: words
// [lo, hi) and backpointers [lo, hi] in the chunk's space
__host__ __device__ inline int stage_levels(const Layout& L, int K) {
  return (L.stage - 16 - K) / (K + 2);
}

struct Params {
  const int* ce;               // i32 [B, T, K] candidate edges (-1 empty)
  const float* co;             // f32 [B, T, K] offsets along them
  const float* cd;             // f32 [B, T, K] distances to the point
  const unsigned char* cv;     // bool [B, T, K]
  const float* pts;            // f32 [B, T, 2]
  const unsigned char* vp;     // bool [B, T]
  const float* edge_len;       // f32 [E]
  const int* reach_row;        // i32 [E]
  const int* reach_to;         // i32 [R, M], ascending, -1 padded
  const float* reach_dist;     // f32 [R, M]
  int B, T, K, M, top;         // top: the largest power of two <= M
  int C, tpc, tpt, levels_here;
  int rt, G;                   // the recurrence's threads, lanes a column
  float em_denom;              // f32(2 sigma_z^2), computed in double
  float beta, factor, breakage, slack;
  int use_keep;                // interpolation_distance > 0
  float d2_min;                // f32(interpolation_distance)^2
  unsigned char* scratch;      // u16 [B, T] then u8 [B, T, K], or null
  int* out_choice;             // i32 [B, T]
  int* out_edge;               // i32 [B, T]
  float* out_offset;           // f32 [B, T]
  unsigned char* out_start;    // bool [B, T]
  unsigned char* out_matched;  // bool [B, T]
};

// the barrier of one trace's threads: a warp, or a named barrier of its
// warps (id 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int id, int n) {
  if (n == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void keep_first_min(float& v, int& i, float ov,
                                               int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// four CTAs an SM: at most 128 registers a thread
__global__ void __launch_bounds__(kMaxThreads, 4)
viterbi_decode_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = p.K, C = p.C, T = p.T, M = p.M, tpt = p.tpt, G = p.G;
  const int rt = p.rt;         // the recurrence's threads: the first rt
  const int grp = threadIdx.x / tpt;
  const int tid = threadIdx.x % tpt;
  const int b = blockIdx.x * p.tpc + grp;
  if (b >= p.B) return;        // a group past the batch: no barrier waits
  const int bar = grp + 1;
  const int lane = tid % 32, warp = tid / 32, nw = tpt / 32;
  const int rw = rt / 32, rbar = bar + p.tpc;   // the recurrence's warps
  const size_t row0 = static_cast<size_t>(b) * T;

  const Layout L = make_layout(K, C, T, p.levels_here != 0);
  unsigned char* base = smem + static_cast<size_t>(grp) * L.bytes;
  float* s_trans = reinterpret_cast<float*>(base + L.trans);
  float* c_o = reinterpret_cast<float*>(base + L.o);
  float* c_em = reinterpret_cast<float*>(base + L.em);
  float* c_len = reinterpret_cast<float*>(base + L.len);
  int* c_e = reinterpret_cast<int*>(base + L.e);
  int* c_row = reinterpret_cast<int*>(base + L.row);
  unsigned char* c_v = base + L.v;
  // each row's looked-up slots (valid, an edge): in order, and as a mask
  unsigned char* c_list = base + L.list;
  unsigned long long* c_mask =
      reinterpret_cast<unsigned long long*>(base + L.mask);
  float* s_score = reinterpret_cast<float*>(base + L.score);
  float* s_x = reinterpret_cast<float*>(base + L.x);
  float* s_y = reinterpret_cast<float*>(base + L.y);
  float* s_gc = reinterpret_cast<float*>(base + L.gc);
  int* s_prev = reinterpret_cast<int*>(base + L.prev);
  int* s_off = reinterpret_cast<int*>(base + L.off);
  float* s_red_v = reinterpret_cast<float*>(base + L.red_v);
  int* s_red_i = reinterpret_cast<int*>(base + L.red_i);
  int* s_conn = reinterpret_cast<int*>(base + L.conn);
  int* s_misc = reinterpret_cast<int*>(base + L.misc);
  unsigned char* s_flags = base + L.flags;
  unsigned char* s_vp = base + L.vp;
  unsigned char* s_any = base + L.any;
  // the backtrack's choices: in shared memory beside the levels, else
  // straight in the output, which the fill reads back
  signed char* s_choice =
      p.levels_here ? reinterpret_cast<signed char*>(base + L.choice)
                    : nullptr;
  unsigned short* lv_word;
  unsigned char* lv_bp;
  if (p.levels_here) {
    lv_word = reinterpret_cast<unsigned short*>(base + L.word);
    lv_bp = base + L.bp;
  } else {
    lv_word = reinterpret_cast<unsigned short*>(p.scratch) + row0;
    lv_bp = p.scratch + static_cast<size_t>(p.B) * T * 2 + row0 * K;
  }

  // the carry row 0: no previous candidate yet
  for (int k = tid; k < K; k += tpt) {
    s_score[k] = kBig;
    c_e[k] = -1;
    c_o[k] = 0.0f;
    c_v[k] = 0;
    c_row[k] = 0;
    c_len[k] = 0.0f;
  }
  for (int s = tid; s < C; s += tpt) s_any[s] = 0;
  // thread 0's sequential scalars: the previous active point, the last
  // kept point, whether there is either, and the scores' first argmin
  float px = 0.0f, py = 0.0f, lx = 0.0f, ly = 0.0f;
  bool prev_any = false, any_kept = false;
  int own = -1;
  if (tid == 0) {
    px = lx = p.pts[2 * row0];
    py = ly = p.pts[2 * row0 + 1];
  }
  group_sync(bar, tpt);

  const int KK = K * K;
  const int j = tid / G;       // the recurrence's column
  const int sub = tid % G;     // its slice of the previous candidates
  for (int t0 = 0; t0 < T; t0 += C) {
    const int n = min(C, T - t0);
    const size_t r0 = row0 + t0;
    // ---- 1. staging: the chunk's candidates into rows 1..n
#pragma unroll 4
    for (int c = tid; c < n * K; c += tpt) {
      const size_t g = r0 * K + c;
      const int e = __ldg(p.ce + g);
      const bool v = __ldg(p.cv + g) != 0;
      const float d = __ldg(p.cd + g);
      const int at = K + c;
      c_e[at] = e;
      c_o[at] = __ldg(p.co + g);
      c_v[at] = v;
      c_em[at] = v ? __fdiv_rn(__fmul_rn(d, d), p.em_denom) : kBig;
      c_row[at] = e >= 0 ? __ldg(p.reach_row + e) : 0;
      c_len[at] = e >= 0 ? __ldg(p.edge_len + e) : 0.0f;
      if (v) s_any[c / K] = 1;
    }
    for (int s = tid; s < n; s += tpt) {
      s_x[s] = __ldg(p.pts + 2 * (r0 + s));
      s_y[s] = __ldg(p.pts + 2 * (r0 + s) + 1);
      s_vp[s] = __ldg(p.vp + r0 + s);
    }
    group_sync(bar, tpt);
    // the rows' looked-up slots (row 0 the carry), a row a warp at once
    for (int r = warp; r <= n; r += nw) {
      unsigned long long mask = 0ull;
      int count = 0;
      for (int k0 = 0; k0 < K; k0 += 32) {
        const int k = k0 + lane;
        const bool ok = k < K && c_v[r * K + k] && c_e[r * K + k] >= 0;
        const unsigned m = __ballot_sync(kFull, ok);
        if (ok) {
          c_list[r * K + count + __popc(m & ((1u << lane) - 1u))] =
              static_cast<unsigned char>(k);
        }
        count += __popc(m);
        mask |= static_cast<unsigned long long>(m) << k0;
      }
      if (lane == 0) c_mask[r] = mask;
    }
    group_sync(bar, tpt);

    // ---- 2. the control sequence (thread 0)
    if (tid == 0) {
      int last = -1;           // the last active step of the chunk so far
      int pairs = 0;           // the looked-up pairs of the steps before
      for (int s = 0; s < n; ++s) {
        const float x = s_x[s], y = s_y[s];
        const bool v = s_vp[s] != 0;
        bool keep = v;
        if (p.use_keep) {
          const float dx = __fsub_rn(x, lx), dy = __fsub_rn(y, ly);
          const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          keep = v && (!any_kept || d2 >= p.d2_min);
          if (keep) {
            lx = x;
            ly = y;
          }
          any_kept = any_kept || keep;
        }
        const bool act = keep && s_any[s];
        s_any[s] = 0;
        const float gx = __fsub_rn(x, px), gy = __fsub_rn(y, py);
        const float gc =
            __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
        const bool look = act && prev_any && gc <= p.breakage;
        s_gc[s] = gc;
        s_prev[s] = last + 1;  // the row of the previous active point
        s_off[s] = pairs;
        if (look) {
          pairs += __popcll(c_mask[last + 1]) * __popcll(c_mask[s + 1]);
        }
        s_flags[s] = (act ? kStepActive : 0) | (keep ? kStepKeep : 0) |
                     (prev_any ? kStepPrevAny : 0) | (look ? kStepLook : 0);
        if (act) {
          px = x;
          py = y;
          prev_any = true;
          last = s;
        }
      }
      s_misc[0] = last;
      s_misc[1] = pairs;
    }
    group_sync(bar, tpt);

    // ---- 3. the chunk's transition blocks: the looked-up pairs (a
    // valid slot with an edge at both ends, a step that looks up) in the
    // order step, previous slot, next slot, kInterleave searches a thread
    // at once; consecutive threads mostly search one row. A pair not
    // looked up is BIG, which the recurrence reads from the rows' masks.
    const int npairs = s_misc[1];
    for (int f0 = tid; f0 < npairs; f0 += kInterleave * tpt) {
      const int* to[kInterleave];
      unsigned key[kInterleave];
      int hit[kInterleave], at[kInterleave];
      int pi[kInterleave], cj[kInterleave];
      bool ok[kInterleave];
#pragma unroll
      for (int u = 0; u < kInterleave; ++u) {
        const int f = f0 + u * tpt;
        ok[u] = f < npairs;
        to[u] = p.reach_to;
        key[u] = 0u;
        at[u] = pi[u] = cj[u] = 0;
        if (ok[u]) {
          // the step: the last whose first pair is at or before f
          int lo = 0, hi = n - 1;
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (s_off[mid] <= f) {
              lo = mid;
            } else {
              hi = mid - 1;
            }
          }
          const int loc = f - s_off[lo];
          const int nc = __popcll(c_mask[lo + 1]);
          const int ii = loc / nc, jj = loc - ii * nc;
          const int i = c_list[s_prev[lo] * K + ii];
          const int jn = c_list[(lo + 1) * K + jj];
          pi[u] = s_prev[lo] * K + i;
          cj[u] = (lo + 1) * K + jn;
          at[u] = lo * KK + i * K + jn;
          to[u] = p.reach_to + static_cast<size_t>(c_row[pi[u]]) * M;
          key[u] = static_cast<unsigned>(c_e[cj[u]]);
        }
      }
      rtt_route::search_rows<kInterleave>(to, key, ok, M, p.top, hit);
#pragma unroll
      for (int u = 0; u < kInterleave; ++u) {
        if (!ok[u]) continue;
        const float gap =
            hit[u] >= 0
                ? fminf(kBig, __ldg(p.reach_dist +
                                    static_cast<size_t>(c_row[pi[u]]) * M +
                                    hit[u]))
                : kBig;
        const float trans = rtt_route::transition_cost(
            c_e[pi[u]], c_len[pi[u]], c_o[pi[u]], c_e[cj[u]], c_o[cj[u]],
            gap, s_gc[at[u] / KK], p.beta, p.factor, p.slack);
        s_trans[at[u]] = trans;
      }
    }
    group_sync(bar, tpt);

    // ---- 4. the recurrence, step by step, on the first rt threads (one
    // warp up to K = 16); the others go on to the carry
    for (int s = 0; s < n && tid < rt; ++s) {
      const int t = t0 + s;
      const int fl = s_flags[s];
      if (!(fl & kStepActive)) {
        // an inactive point passes the carry through: identity
        // backpointers, read from the word's active bit
        if (tid == 0) {
          lv_word[t] = static_cast<unsigned short>(
              (own + 1) | (fl & kStepKeep ? kKeepBit : 0u));
        }
        continue;
      }
      // the previous slots looked up with this column's slot (none
      // where the step does not look up or the slot is not looked up)
      const unsigned long long seen =
          (fl & kStepLook) && j < K && ((c_mask[s + 1] >> j) & 1ull)
              ? c_mask[s_prev[s]]
              : 0ull;
      const float* tr = s_trans + s * KK;
      float best = CUDART_INF_F;
      int arg = K;
      if (j < K) {
        for (int i = sub; i < K; i += G) {
          const float via = __fadd_rn(
              s_score[i], ((seen >> i) & 1ull) ? tr[i * K + j] : kBig);
          if (via < best) {    // the first minimal i of this slice
            best = via;
            arg = i;
          }
        }
      }
      for (int off = G >> 1; off > 0; off >>= 1) {
        keep_first_min(best, arg, __shfl_xor_sync(kFull, best, off),
                       __shfl_xor_sync(kFull, arg, off));
      }
      const bool connected = j < K && best < kBig;
      bool any_connected = __any_sync(kFull, connected);
      if (rw > 1) {
        if (lane == 0) s_conn[warp] = any_connected;
        group_sync(rbar, rt);
        any_connected = false;
        for (int w = 0; w < rw; ++w) any_connected |= s_conn[w] != 0;
      } else {
        __syncwarp();
      }
      const bool broken = !any_connected || !(fl & kStepPrevAny);
      float sc = CUDART_INF_F;
      int si = K;
      if (j < K) {
        const float em = c_em[(s + 1) * K + j];
        sc = broken ? em : (connected ? __fadd_rn(best, em) : kBig);
        si = j;
        if (sub == 0) {
          s_score[j] = sc;
          lv_bp[static_cast<size_t>(t) * K + j] =
              (broken || !connected) ? kNoPointer
                                     : static_cast<unsigned char>(arg);
        }
      }
      // the level's own first argmin over the new scores: across the
      // warp's columns, then across warps
      for (int off = 16; off >= G; off >>= 1) {
        keep_first_min(sc, si, __shfl_xor_sync(kFull, sc, off),
                       __shfl_xor_sync(kFull, si, off));
      }
      if (rw > 1 && lane == 0) {
        s_red_v[warp] = sc;
        s_red_i[warp] = si;
      }
      group_sync(rbar, rt);
      if (tid == 0) {
        for (int w = 1; w < rw; ++w) keep_first_min(sc, si, s_red_v[w],
                                                   s_red_i[w]);
        own = sc < kBig ? si : -1;
        lv_word[t] = static_cast<unsigned short>(
            (own + 1) | kActiveBit | (fl & kStepKeep ? kKeepBit : 0u) |
            (broken ? kStartedBit : 0u));
      }
    }

    // ---- the last active point's candidates become the carry row
    const int last = s_misc[0];
    if (last >= 0) {
      for (int k = tid; k < K; k += tpt) {
        const int a = (last + 1) * K + k;
        c_e[k] = c_e[a];
        c_o[k] = c_o[a];
        c_v[k] = c_v[a];
        c_row[k] = c_row[a];
        c_len[k] = c_len[a];
      }
    }
    group_sync(bar, tpt);
  }

  // ---- 5. the backtrack: the slot chosen one level above, through the
  // identity of inactive levels; a level is a chain terminal where the
  // level above started a chain (or there is none above). Levels in the
  // global scratch are staged back into the chunk's space, block by block
  // from the end.
  const int span = p.levels_here ? T : stage_levels(L, K);
  unsigned short* st_word = reinterpret_cast<unsigned short*>(base);
  unsigned char* st_bp = base + ((2 * span + 15) & ~15);
  int nxt = -1;
  bool nxt_started = true, nxt_active = false;
  for (int hi = T; hi > 0; hi -= span) {
    const int lo = max(0, hi - span);
    const unsigned short* w_at = lv_word + lo;
    const unsigned char* bp_at = lv_bp + static_cast<size_t>(lo) * K;
    if (!p.levels_here) {
      const int nb = (min(hi + 1, T) - lo) * K;
      for (int x = tid; x < hi - lo; x += tpt) st_word[x] = lv_word[lo + x];
      for (int x = tid; x < nb; x += tpt) st_bp[x] = bp_at[x];
      group_sync(bar, tpt);
      w_at = st_word;
      bp_at = st_bp;
    }
    if (tid == 0) {
      for (int t = hi - 1; t >= lo; --t) {
        const unsigned w = w_at[t - lo];
        const int own_t = static_cast<int>(w & 0xffu) - 1;
        int prop = -1;
        if (nxt >= 0 && t + 1 < T) {
          if (nxt_active) {
            const unsigned char bp = bp_at[(t + 1 - lo) * K + nxt];
            prop = bp == kNoPointer ? -1 : bp;
          } else {
            prop = nxt;
          }
        }
        const int choice = (nxt_started || nxt < 0) ? own_t : prop;
        const int c = (w & kActiveBit) ? choice : -1;
        if (p.levels_here) {
          s_choice[t] = static_cast<signed char>(c);
        } else {
          p.out_choice[row0 + t] = c;
        }
        nxt = choice;
        nxt_started = (w & kStartedBit) != 0;
        nxt_active = (w & kActiveBit) != 0;
      }
    }
    group_sync(bar, tpt);
  }

  // ---- 6. the chosen candidates, then the interpolation fill: a valid
  // point that did not vote takes the last matched point's (edge, offset)
  if (warp != 0) return;
  int pe = -1;
  float po = 0.0f;
  bool pok = false;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    const bool in = t < T;
    const size_t r = row0 + t;
    int c = -1;
    unsigned w = 0;
    bool v = false;
    if (in) {
      c = p.levels_here ? s_choice[t] : p.out_choice[r];
      w = lv_word[t];
      v = __ldg(p.vp + r) != 0;
    }
    const bool m = c >= 0;
    int e = -1;
    float o = 0.0f;
    if (m) {
      e = __ldg(p.ce + r * K + c);
      // the plain version's masked sum over K: adding +0 as it does
      o = __fadd_rn(__ldg(p.co + r * K + c), 0.0f);
    }
    const unsigned mm = __ballot_sync(kFull, m);
    const unsigned before = mm & ((1u << lane) - 1u);
    const int src = before ? 31 - __clz(before) : 0;
    const int be = __shfl_sync(kFull, e, src);
    const float bo = __shfl_sync(kFull, o, src);
    const bool use = v && !(w & kKeepBit) && (before || pok) && !m;
    if (in) {
      p.out_choice[r] = c;
      p.out_edge[r] = use ? (before ? be : pe) : e;
      p.out_offset[r] = use ? (before ? bo : po) : o;
      p.out_matched[r] = m || use;
      p.out_start[r] = (w & kStartedBit) != 0;
    }
    if (mm) {
      const int l = 31 - __clz(mm);
      pe = __shfl_sync(kFull, e, l);
      po = __shfl_sync(kFull, o, l);
      pok = true;
    }
  }
}

// the plan's checks: → the layout, or bytes -1 for a plan the kernel
// does not take (its shared bytes not this layout's, among others)
Layout checked_layout(int T, int K, int M, int tpt, int tpc, int rt,
                      int columns, int chunk, int levels_here,
                      int smem_bytes) {
  Layout bad{};
  bad.bytes = -1;
  if (T < 1 || K < 1 || K > kMaxK || M < 1 || chunk < 1) return bad;
  if (tpt < 32 || tpt % 32 != 0 || tpc < 1 || tpt * tpc > kMaxThreads) {
    return bad;
  }
  // whole warps of G lanes a column, every column covered, G <= 32
  if (rt < 32 || rt % 32 != 0 || rt > tpt || rt % columns != 0 ||
      rt / columns > 32) {
    return bad;
  }
  const Layout L = make_layout(K, chunk, T, levels_here != 0);
  if (static_cast<long long>(L.bytes) * tpc != smem_bytes ||
      smem_bytes > kMaxSmem) {
    return bad;
  }
  if (!levels_here && stage_levels(L, K) < 1) return bad;
  return L;
}


// ---- the wide kernel (K > kMaxK) -------------------------------------------

constexpr int kWideThreads = 128;    // a wide CTA: one trace
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideInterleave = 8;   // binary searches in flight a thread
constexpr int kWideOwnBits = 16;     // the level word's own argmin + 1
constexpr unsigned kWideKeepBit = 1u << kWideOwnBits;
constexpr unsigned kWideActiveBit = kWideKeepBit << 1;
constexpr unsigned kWideStartedBit = kWideKeepBit << 2;

// the wide kernel's backpointer: u8 while a slot fits beside the 0xff
// "none" (K <= 254), else u16
__host__ __device__ inline int wide_bp_bytes(int K) { return K < 255 ? 1 : 2; }

// A wide trace's shared memory, in bytes from the CTA's base, each array
// 16 aligned (ops/hmm.py::viterbi_wide_smem_bytes makes the same sum,
// which the launch checks). [0, stage) is the chunk: the pass's looked-up
// pairs' costs f32 [P] in the order step, previous slot, next slot, then
// the candidate rows [(C + 1), K] (row 0 the carry) with their looked-up
// slots as a u16 list and ceil(K / 64) mask words a row; the backtrack
// reuses it to stage global levels. Then the scores, each column's best
// and first argmin (over the passes of a step), each row's looked-up
// count, the step records, the reductions' words and, where the levels
// stay here, the choices i32 [T], words u32 [T] and backpointers [T, K].
struct WideLayout {
  int pv, o, em, len, e, row, v, list, mask, stage;
  int score, bv, bi, cnt, x, y, gc, prev, off, red_v, red_i, misc;
  int flags, vp, any, choice, word, bp, bytes;
};

// the layout (bytes -1 past 2^31 - 1, where an int offset would wrap)
__host__ __device__ inline WideLayout make_wide_layout(int K, int C, int T,
                                                       int P,
                                                       bool levels_here) {
  WideLayout L{};
  long long at = 0;
  const long long rows = (C + 1ll) * K;
  const int bp = wide_bp_bytes(K);
  auto take = [&](long long n) {
    const long long o = at;
    at += (n + 15) & ~15ll;
    return static_cast<int>(o);
  };
  L.pv = take(4ll * P);
  L.o = take(4 * rows);
  L.em = take(4 * rows);
  L.len = take(4 * rows);
  L.e = take(4 * rows);
  L.row = take(4 * rows);
  L.v = take(rows);
  L.list = take(2 * rows);
  L.mask = take(8ll * ((K + 63) / 64) * (C + 1));
  L.stage = static_cast<int>(at);
  L.score = take(4ll * K);
  L.bv = take(4ll * K);
  L.bi = take(4ll * K);
  L.cnt = take(4ll * (C + 1));
  L.x = take(4ll * C);
  L.y = take(4ll * C);
  L.gc = take(4ll * C);
  L.prev = take(4ll * C);
  L.off = take(4ll * C);
  L.red_v = take(4 * kWideWarps);
  L.red_i = take(4 * kWideWarps);
  L.misc = take(4 * kWideWarps);
  L.flags = take(C);
  L.vp = take(C);
  L.any = take(C);
  L.choice = levels_here ? take(4ll * T) : -1;
  L.word = levels_here ? take(4ll * T) : -1;
  L.bp = levels_here ? take(1ll * bp * T * K) : -1;
  L.bytes = at > 0x7fffffffll ? -1 : static_cast<int>(at);
  return L;
}

// levels the backtrack stages at once from the global scratch: words
// [lo, hi) and backpointers [lo, hi] in the chunk's space
__host__ __device__ inline int wide_stage_levels(const WideLayout& L, int K) {
  const int bp = wide_bp_bytes(K);
  return (L.stage - 16 - bp * K) / (bp * K + 4);
}

__device__ __forceinline__ bool mask_bit(const unsigned long long* m,
                                         int i) {
  return (m[i >> 6] >> (i & 63)) & 1ull;
}

struct WideParams {
  const int* ce;               // i32 [B, T, K] candidate edges (-1 empty)
  const float* co;             // f32 [B, T, K] offsets along them
  const float* cd;             // f32 [B, T, K] distances to the point
  const unsigned char* cv;     // bool [B, T, K]
  const float* pts;            // f32 [B, T, 2]
  const unsigned char* vp;     // bool [B, T]
  const float* edge_len;       // f32 [E]
  const int* reach_row;        // i32 [E]
  const int* reach_to;         // i32 [R, M], ascending, -1 padded
  const float* reach_dist;     // f32 [R, M]
  int B, T, K, M, top;         // top: the largest power of two <= M
  int C, P, levels_here;       // chunk, pair budget a pass
  float em_denom;              // f32(2 sigma_z^2), computed in double
  float beta, factor, breakage, slack;
  int use_keep;                // interpolation_distance > 0
  float d2_min;                // f32(interpolation_distance)^2
  unsigned char* scratch;      // u32 [B, T] words, then [B, T, K]
                               // backpointers; or null (levels here)
  int* out_choice;             // i32 [B, T]
  int* out_edge;               // i32 [B, T]
  float* out_offset;           // f32 [B, T]
  unsigned char* out_start;    // bool [B, T]
  unsigned char* out_matched;  // bool [B, T]
};

// One trace a CTA of kWideThreads, four CTAs an SM where the shared
// memory lets them (at most 128 registers a thread). kInst: the instance,
// 1 (u8 backpointers) or 2 (u16).
template <int kInst>
__global__ void __launch_bounds__(kWideThreads, 4)
    viterbi_decode_wide_kernel(const WideParams p) {
  using Bp = std::conditional_t<kInst == 2, unsigned short, unsigned char>;
  constexpr Bp kNone = static_cast<Bp>(~0u);
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = p.K, C = p.C, T = p.T, M = p.M, P = p.P;
  const int W = (K + 63) >> 6;       // mask words a row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nt = kWideThreads;
  const int b = blockIdx.x;
  const size_t row0 = static_cast<size_t>(b) * T;
  const WideLayout L = make_wide_layout(K, C, T, P, p.levels_here != 0);
  unsigned char* base = smem;
  float* s_pv = reinterpret_cast<float*>(base + L.pv);
  float* c_o = reinterpret_cast<float*>(base + L.o);
  float* c_em = reinterpret_cast<float*>(base + L.em);
  float* c_len = reinterpret_cast<float*>(base + L.len);
  int* c_e = reinterpret_cast<int*>(base + L.e);
  int* c_row = reinterpret_cast<int*>(base + L.row);
  unsigned char* c_v = base + L.v;
  unsigned short* c_list = reinterpret_cast<unsigned short*>(base + L.list);
  unsigned long long* c_mask =
      reinterpret_cast<unsigned long long*>(base + L.mask);
  float* s_score = reinterpret_cast<float*>(base + L.score);
  float* s_bv = reinterpret_cast<float*>(base + L.bv);
  int* s_bi = reinterpret_cast<int*>(base + L.bi);
  int* s_cnt = reinterpret_cast<int*>(base + L.cnt);
  float* s_x = reinterpret_cast<float*>(base + L.x);
  float* s_y = reinterpret_cast<float*>(base + L.y);
  float* s_gc = reinterpret_cast<float*>(base + L.gc);
  int* s_prev = reinterpret_cast<int*>(base + L.prev);
  int* s_off = reinterpret_cast<int*>(base + L.off);
  float* s_red_v = reinterpret_cast<float*>(base + L.red_v);
  int* s_red_i = reinterpret_cast<int*>(base + L.red_i);
  int* s_misc = reinterpret_cast<int*>(base + L.misc);
  unsigned char* s_flags = base + L.flags;
  unsigned char* s_vp = base + L.vp;
  unsigned char* s_any = base + L.any;
  int* s_choice =
      p.levels_here ? reinterpret_cast<int*>(base + L.choice) : nullptr;
  unsigned* lv_word;
  Bp* lv_bp;
  if (p.levels_here) {
    lv_word = reinterpret_cast<unsigned*>(base + L.word);
    lv_bp = reinterpret_cast<Bp*>(base + L.bp);
  } else {
    lv_word = reinterpret_cast<unsigned*>(p.scratch) + row0;
    lv_bp = reinterpret_cast<Bp*>(p.scratch + static_cast<size_t>(p.B) * T *
                                                  sizeof(unsigned)) +
            row0 * K;
  }

  // the carry row 0: no previous candidate yet
  for (int k = tid; k < K; k += nt) {
    s_score[k] = kBig;
    c_e[k] = -1;
    c_o[k] = 0.0f;
    c_v[k] = 0;
    c_row[k] = 0;
    c_len[k] = 0.0f;
  }
  for (int s = tid; s < C; s += nt) s_any[s] = 0;
  // thread 0's sequential scalars, as instance 0's
  float px = 0.0f, py = 0.0f, lx = 0.0f, ly = 0.0f;
  bool prev_any = false, any_kept = false;
  int own = -1;
  if (tid == 0) {
    px = lx = p.pts[2 * row0];
    py = ly = p.pts[2 * row0 + 1];
  }
  __syncthreads();

  for (int t0 = 0; t0 < T; t0 += C) {
    const int n = min(C, T - t0);
    const size_t r0 = row0 + t0;
    // ---- 1. staging: the chunk's candidates into rows 1..n
#pragma unroll 4
    for (int c = tid; c < n * K; c += nt) {
      const size_t g = r0 * K + c;
      const int e = __ldg(p.ce + g);
      const bool v = __ldg(p.cv + g) != 0;
      const float d = __ldg(p.cd + g);
      const int at = K + c;
      c_e[at] = e;
      c_o[at] = __ldg(p.co + g);
      c_v[at] = v;
      c_em[at] = v ? __fdiv_rn(__fmul_rn(d, d), p.em_denom) : kBig;
      c_row[at] = e >= 0 ? __ldg(p.reach_row + e) : 0;
      c_len[at] = e >= 0 ? __ldg(p.edge_len + e) : 0.0f;
      if (v) s_any[c / K] = 1;
    }
    for (int s = tid; s < n; s += nt) {
      s_x[s] = __ldg(p.pts + 2 * (r0 + s));
      s_y[s] = __ldg(p.pts + 2 * (r0 + s) + 1);
      s_vp[s] = __ldg(p.vp + r0 + s);
    }
    __syncthreads();
    // the rows' looked-up slots (row 0 the carry), a row a warp at once:
    // the list, the mask words and the count
    for (int r = warp; r <= n; r += kWideWarps) {
      unsigned long long mask = 0ull;
      int count = 0;
      for (int k0 = 0; k0 < K; k0 += 32) {
        const int k = k0 + lane;
        const bool ok = k < K && c_v[r * K + k] && c_e[r * K + k] >= 0;
        const unsigned m = __ballot_sync(kFull, ok);
        if (ok) {
          c_list[r * K + count + __popc(m & ((1u << lane) - 1u))] =
              static_cast<unsigned short>(k);
        }
        count += __popc(m);
        mask |= static_cast<unsigned long long>(m) << (k0 & 63);
        // a word whole at its upper half, or at the row's end
        if ((k0 & 63) == 32 || k0 + 32 >= K) {
          if (lane == 0) c_mask[r * W + (k0 >> 6)] = mask;
          mask = 0ull;
        }
      }
      if (lane == 0) s_cnt[r] = count;
    }
    __syncthreads();

    // ---- 2. the control sequence (thread 0), as instance 0's
    if (tid == 0) {
      int last = -1;           // the last active step of the chunk so far
      int pairs = 0;           // the looked-up pairs of the steps before
      for (int s = 0; s < n; ++s) {
        const float x = s_x[s], y = s_y[s];
        const bool v = s_vp[s] != 0;
        bool keep = v;
        if (p.use_keep) {
          const float dx = __fsub_rn(x, lx), dy = __fsub_rn(y, ly);
          const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          keep = v && (!any_kept || d2 >= p.d2_min);
          if (keep) {
            lx = x;
            ly = y;
          }
          any_kept = any_kept || keep;
        }
        const bool act = keep && s_any[s];
        s_any[s] = 0;
        const float gx = __fsub_rn(x, px), gy = __fsub_rn(y, py);
        const float gc =
            __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
        const bool look = act && prev_any && gc <= p.breakage;
        s_gc[s] = gc;
        s_prev[s] = last + 1;  // the row of the previous active point
        s_off[s] = pairs;
        if (look) pairs += s_cnt[last + 1] * s_cnt[s + 1];
        s_flags[s] = (act ? kStepActive : 0) | (keep ? kStepKeep : 0) |
                     (prev_any ? kStepPrevAny : 0) | (look ? kStepLook : 0);
        if (act) {
          px = x;
          py = y;
          prev_any = true;
          last = s;
        }
      }
      s_misc[0] = last;
      s_misc[1] = pairs;
    }
    __syncthreads();

    // ---- 3 and 4, pass by pass: the looked-up pairs [f_lo, f_hi) of the
    // chunk (at most P), then the steps whose pairs the pass completes. A
    // step whose pairs run past the pass keeps each column's first
    // minimum so far and goes on in the next pass.
    const int npairs = s_misc[1];
    int s_next = 0;            // the first step not yet done
    for (int f_lo = 0;; f_lo += P) {
      const int f_hi = min(npairs, f_lo + P);
      if (f_lo > 0) __syncthreads();     // the last pass's costs read
      for (int f0 = f_lo + tid; f0 < f_hi; f0 += kWideInterleave * nt) {
        const int* to[kWideInterleave];
        unsigned key[kWideInterleave];
        int hit[kWideInterleave], st[kWideInterleave];
        int pi[kWideInterleave], cj[kWideInterleave];
        bool ok[kWideInterleave];
#pragma unroll
        for (int u = 0; u < kWideInterleave; ++u) {
          const int f = f0 + u * nt;
          ok[u] = f < f_hi;
          to[u] = p.reach_to;
          key[u] = 0u;
          st[u] = pi[u] = cj[u] = 0;
          if (ok[u]) {
            // the step: the last whose first pair is at or before f, by
            // halving steps over the chunk's C <= 32 steps
            int lo = 0;
#pragma unroll
            for (int step = 16; step > 0; step >>= 1) {
              const int at = lo + step;
              lo = at < n && s_off[min(at, n - 1)] <= f ? at : lo;
            }
            const int loc = f - s_off[lo];
            const int nc = s_cnt[lo + 1];
            const int ii = loc / nc, jj = loc - ii * nc;
            const int i = c_list[s_prev[lo] * K + ii];
            const int jn = c_list[(lo + 1) * K + jj];
            st[u] = lo;
            pi[u] = s_prev[lo] * K + i;
            cj[u] = (lo + 1) * K + jn;
            to[u] = p.reach_to + static_cast<size_t>(c_row[pi[u]]) * M;
            key[u] = static_cast<unsigned>(c_e[cj[u]]);
          }
        }
        // the probes loaded before any is compared: the faster of
        // route.cuh's two forms here, timed in turns (PERF.md)
        rtt_route::search_rows<kWideInterleave, true>(to, key, ok, M, p.top,
                                                      hit);
#pragma unroll
        for (int u = 0; u < kWideInterleave; ++u) {
          if (!ok[u]) continue;
          const float gap =
              hit[u] >= 0
                  ? fminf(kBig, __ldg(p.reach_dist +
                                      static_cast<size_t>(c_row[pi[u]]) * M +
                                      hit[u]))
                  : kBig;
          s_pv[f0 + u * nt - f_lo] = rtt_route::transition_cost(
              c_e[pi[u]], c_len[pi[u]], c_o[pi[u]], c_e[cj[u]], c_o[cj[u]],
              gap, s_gc[st[u]], p.beta, p.factor, p.slack);
        }
      }
      __syncthreads();

      // the steps, in order, while their pairs are in this pass
      bool more = false;       // a step goes on into the next pass
      while (s_next < n) {
        const int s = s_next, t = t0 + s;
        const int fl = s_flags[s];
        if (!(fl & kStepActive)) {
          // an inactive point passes the carry through: identity
          // backpointers, read from the word's active bit
          if (tid == 0) {
            lv_word[t] = static_cast<unsigned>(own + 1) |
                         (fl & kStepKeep ? kWideKeepBit : 0u);
          }
          ++s_next;
          continue;            // the same flags in every thread
        }
        const bool look = (fl & kStepLook) != 0;
        const int prow = s_prev[s];
        const int np = look ? s_cnt[prow] : 0, nc = s_cnt[s + 1];
        const int off = s_off[s], pend = off + np * nc;
        bool conn = false;
        if (pend > off) {
          if (off >= f_hi) break;          // its pairs start in a later pass
          // each looked-up column jj: G lanes over the previous looked-up
          // slots ii of this pass (ascending within a lane), the pair
          // (value, slot) reduced lexicographically: the first minimal i,
          // as the plain version's argmin over all K (a slot not looked up
          // adds BIG, never below a connected best). Over passes the
          // column's best so far is kept in s_bv / s_bi.
          int G = 1;
          while (G < 32 && nc * G * 2 <= nt) G *= 2;
          const int sub = tid % G;
          const bool first = off >= f_lo, last = pend <= f_hi;
          const int lo_f = max(off, f_lo) - off, hi_f = min(pend, f_hi) - off;
          const unsigned short* plist = c_list + prow * K;
          const float* pv = s_pv + (off - f_lo);
          for (int jj0 = 0; jj0 < nc; jj0 += nt / G) {
            const int jj = jj0 + tid / G;
            float best = CUDART_INF_F;
            int arg = K;
            if (jj < nc) {
              // ii with lo_f <= ii * nc + jj < hi_f
              const int ii_lo = lo_f > jj ? (lo_f - jj + nc - 1) / nc : 0;
              const int ii_hi = hi_f > jj ? (hi_f - jj + nc - 1) / nc : 0;
              for (int ii = ii_lo + sub; ii < ii_hi; ii += G) {
                const int i = plist[ii];
                const float via = __fadd_rn(s_score[i], pv[ii * nc + jj]);
                if (via < best) {
                  best = via;
                  arg = i;
                }
              }
            }
            for (int o = G >> 1; o > 0; o >>= 1) {
              keep_first_min(best, arg, __shfl_xor_sync(kFull, best, o),
                             __shfl_xor_sync(kFull, arg, o));
            }
            if (jj < nc && sub == 0) {
              const int j = c_list[(s + 1) * K + jj];
              if (!first) keep_first_min(best, arg, s_bv[j], s_bi[j]);
              s_bv[j] = best;
              s_bi[j] = arg;
              conn = conn || (last && best < kBig);
            }
          }
          if (!last) {
            more = true;
            break;             // the rest of its pairs in the next pass
          }
        }
        // every column's best read from the scores: the new ones may be
        // written
        const bool broken =
            !__syncthreads_or(conn) || !(fl & kStepPrevAny);
        const unsigned long long* jm = c_mask + (s + 1) * W;
        float sc = CUDART_INF_F;
        int si = K;
        for (int j = tid; j < K; j += nt) {
          const float best = s_bv[j];
          const bool connected = look && mask_bit(jm, j) && best < kBig;
          const float em = c_em[(s + 1) * K + j];
          const float v =
              broken ? em : (connected ? __fadd_rn(best, em) : kBig);
          s_score[j] = v;
          lv_bp[static_cast<size_t>(t) * K + j] =
              (broken || !connected) ? kNone : static_cast<Bp>(s_bi[j]);
          keep_first_min(sc, si, v, j);
        }
        // the level's own first argmin: the warp's, then the CTA's
        for (int o = 16; o > 0; o >>= 1) {
          keep_first_min(sc, si, __shfl_xor_sync(kFull, sc, o),
                         __shfl_xor_sync(kFull, si, o));
        }
        if (lane == 0) {
          s_red_v[warp] = sc;
          s_red_i[warp] = si;
        }
        __syncthreads();
        if (tid == 0) {
          for (int w = 1; w < kWideWarps; ++w) {
            keep_first_min(sc, si, s_red_v[w], s_red_i[w]);
          }
          own = sc < kBig ? si : -1;
          lv_word[t] = static_cast<unsigned>(own + 1) | kWideActiveBit |
                       (fl & kStepKeep ? kWideKeepBit : 0u) |
                       (broken ? kWideStartedBit : 0u);
        }
        ++s_next;
      }
      if (f_hi >= npairs && !more) break;
    }

    // ---- the carry row: the last active point's candidates
    const int last = s_misc[0];
    __syncthreads();           // s_misc read; the chunk's rows read
    if (last >= 0) {
      for (int k = tid; k < K; k += nt) {
        const int a = (last + 1) * K + k;
        c_e[k] = c_e[a];
        c_o[k] = c_o[a];
        c_v[k] = c_v[a];
        c_row[k] = c_row[a];
        c_len[k] = c_len[a];
      }
    }
    __syncthreads();
  }

  // ---- 5. the backtrack, as instance 0's: levels in the global scratch
  // staged back into the chunk's space, block by block from the end
  const int span = p.levels_here ? T : wide_stage_levels(L, K);
  unsigned* st_word = reinterpret_cast<unsigned*>(base);
  Bp* st_bp = reinterpret_cast<Bp*>(base + ((4 * span + 15) & ~15));
  int nxt = -1;
  bool nxt_started = true, nxt_active = false;
  for (int hi = T; hi > 0; hi -= span) {
    const int lo = max(0, hi - span);
    const unsigned* w_at = lv_word + lo;
    const Bp* bp_at = lv_bp + static_cast<size_t>(lo) * K;
    if (!p.levels_here) {
      const int nb = (min(hi + 1, T) - lo) * K;
      for (int x = tid; x < hi - lo; x += nt) st_word[x] = lv_word[lo + x];
      for (int x = tid; x < nb; x += nt) st_bp[x] = bp_at[x];
      __syncthreads();
      w_at = st_word;
      bp_at = st_bp;
    }
    if (tid == 0) {
      for (int t = hi - 1; t >= lo; --t) {
        const unsigned w = w_at[t - lo];
        const int own_t =
            static_cast<int>(w & ((1u << kWideOwnBits) - 1u)) - 1;
        int prop = -1;
        if (nxt >= 0 && t + 1 < T) {
          if (nxt_active) {
            const Bp bp = bp_at[static_cast<size_t>(t + 1 - lo) * K + nxt];
            prop = bp == kNone ? -1 : bp;
          } else {
            prop = nxt;
          }
        }
        const int choice = (nxt_started || nxt < 0) ? own_t : prop;
        const int c = (w & kWideActiveBit) ? choice : -1;
        if (p.levels_here) {
          s_choice[t] = c;
        } else {
          p.out_choice[row0 + t] = c;
        }
        nxt = choice;
        nxt_started = (w & kWideStartedBit) != 0;
        nxt_active = (w & kWideActiveBit) != 0;
      }
    }
    __syncthreads();
  }

  // ---- 6. the chosen candidates, then the interpolation fill, as
  // instance 0's
  if (warp != 0) return;
  int pe = -1;
  float po = 0.0f;
  bool pok = false;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    const bool in = t < T;
    const size_t r = row0 + t;
    int c = -1;
    unsigned w = 0;
    bool v = false;
    if (in) {
      c = p.levels_here ? s_choice[t] : p.out_choice[r];
      w = lv_word[t];
      v = __ldg(p.vp + r) != 0;
    }
    const bool m = c >= 0;
    int e = -1;
    float o = 0.0f;
    if (m) {
      e = __ldg(p.ce + r * K + c);
      // the plain version's masked sum over K: adding +0 as it does
      o = __fadd_rn(__ldg(p.co + r * K + c), 0.0f);
    }
    const unsigned mm = __ballot_sync(kFull, m);
    const unsigned before = mm & ((1u << lane) - 1u);
    const int src = before ? 31 - __clz(before) : 0;
    const int be = __shfl_sync(kFull, e, src);
    const float bo = __shfl_sync(kFull, o, src);
    const bool use = v && !(w & kWideKeepBit) && (before || pok) && !m;
    if (in) {
      p.out_choice[r] = c;
      p.out_edge[r] = use ? (before ? be : pe) : e;
      p.out_offset[r] = use ? (before ? bo : po) : o;
      p.out_matched[r] = m || use;
      p.out_start[r] = (w & kWideStartedBit) != 0;
    }
    if (mm) {
      const int l = 31 - __clz(mm);
      pe = __shfl_sync(kFull, e, l);
      po = __shfl_sync(kFull, o, l);
      pok = true;
    }
  }
}

// the wide plan's checks: → the layout, or bytes -1 for a plan the kernel
// does not take (its shared bytes not this layout's, among others)
WideLayout checked_wide_layout(int T, int K, int M, int chunk, int pairs,
                               int levels_here, int smem_bytes) {
  WideLayout bad{};
  bad.bytes = -1;
  if (T < 1 || K <= kMaxK || M < 1 || chunk < 1 || chunk > 32 || pairs < 1) {
    return bad;
  }
  // the one ceiling on K is the shared memory: an array that alone
  // outgrows it (the candidate rows' flags, the levels' backpointers) is
  // refused here, in 64 bits
  if ((chunk + 1ll) * K > kMaxSmem ||
      (levels_here && 1ll * T * K > kMaxSmem)) {
    return bad;
  }
  const WideLayout L =
      make_wide_layout(K, chunk, T, pairs, levels_here != 0);
  if (L.bytes < 0 || L.bytes != smem_bytes || smem_bytes > kMaxSmem) {
    return bad;
  }
  if (!levels_here && wide_stage_levels(L, K) < 1) return bad;
  return L;
}

// more than 48 KB of dynamic shared memory needs the attribute, set once
// per device and kernel
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

template <int kInst>
int launch_wide(const WideParams& p, int smem_bytes, void* stream) {
  static std::atomic<unsigned long long> attribute_set{0};
  const int rc =
      allow_smem(viterbi_decode_wide_kernel<kInst>, attribute_set);
  if (rc != 0) return rc;
  viterbi_decode_wide_kernel<kInst><<<p.B, kWideThreads, smem_bytes,
                                      static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
// One launch of the decode over B traces on `stream`, as
// ops/hmm.py::viterbi_plan lays it out. `instance` (instance_of(K): the
// launch refuses another): 0, viterbi_decode_kernel, `traces` traces a
// CTA, `threads` threads a trace, the recurrence on the first `rt` of them
// (G = rt / columns lanes a column, columns = K rounded up to a power of
// two), chunks of `chunk` steps, the levels in shared memory
// (levels_here) or in `scratch` (u8, B * T * (K + 2) bytes), `pairs` 0; 1
// and 2, viterbi_decode_wide_kernel (u8 and u16 backpointers), one trace a
// CTA of kWideThreads (`threads` and `rt` kWideThreads, `traces` 1),
// chunks of `chunk` steps looked up in passes of `pairs` pairs, the levels
// in shared memory or in `scratch` (u32 words [B, T], then backpointers
// [B, T, K]). `smem_bytes` of dynamic shared memory a CTA. Returns
// cudaGetLastError() after the launch, or -1 for a plan the kernel does
// not take.
extern "C" int rtt_viterbi_decode(
    const int* ce, const float* co, const float* cd, const unsigned char* cv,
    const float* pts, const unsigned char* vp, const float* edge_len,
    const int* reach_row, const int* reach_to, const float* reach_dist,
    int B, int T, int K, int M, int instance, int threads, int traces,
    int rt, int chunk, int levels_here, int pairs, int smem_bytes,
    float em_denom, float beta, float factor, float breakage, float slack,
    int use_keep, float d2_min, unsigned char* scratch, int* out_choice,
    int* out_edge, float* out_offset, unsigned char* out_start,
    unsigned char* out_matched, void* stream) {
  const int inst = K <= kMaxK ? 0 : (K < 255 ? 1 : 2);
  if (B < 1 || K < 1 || instance != inst) return -1;
  int top = 1;
  while (top <= M / 2) top *= 2;
  if (inst != 0) {
    if (threads != kWideThreads || traces != 1 || rt != kWideThreads) {
      return -1;
    }
    const WideLayout L = checked_wide_layout(T, K, M, chunk, pairs,
                                             levels_here, smem_bytes);
    if (L.bytes < 0 || (!levels_here && scratch == nullptr)) return -1;
    WideParams p{ce,       co,        cd,        cv,       pts,
                 vp,       edge_len,  reach_row, reach_to, reach_dist,
                 B,        T,         K,         M,        top,
                 chunk,    pairs,     levels_here, em_denom, beta,
                 factor,   breakage,  slack,     use_keep, d2_min,
                 scratch,  out_choice, out_edge, out_offset, out_start,
                 out_matched};
    return inst == 1 ? launch_wide<1>(p, smem_bytes, stream)
                     : launch_wide<2>(p, smem_bytes, stream);
  }
  if (pairs != 0) return -1;
  int columns = 1;
  while (columns < K) columns *= 2;
  const Layout L = checked_layout(T, K, M, threads, traces, rt, columns,
                                  chunk, levels_here, smem_bytes);
  if (L.bytes < 0 || (!levels_here && scratch == nullptr)) return -1;
  static std::atomic<unsigned long long> attribute_set{0};
  const int rc = allow_smem(viterbi_decode_kernel, attribute_set);
  if (rc != 0) return rc;
  Params p{ce,        co,        cd,       cv,          pts,
           vp,        edge_len,  reach_row, reach_to,   reach_dist,
           B,         T,         K,        M,           top,
           chunk,     traces,    threads,  levels_here,
           rt,        rt / columns, em_denom, beta,    factor,      breakage,
           slack,     use_keep,  d2_min,   scratch,     out_choice,
           out_edge,  out_offset, out_start, out_matched};
  const int grid = (B + traces - 1) / traces;
  viterbi_decode_kernel<<<grid, threads * traces, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
