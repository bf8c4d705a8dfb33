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
// What bounds it on this card: operations, and their latency. The work of
// a step is the [K, K] transition block, and each entry of it is a lookup
// of the previous candidate's reach row (M entries, 128 by default) for
// the next candidate's edge: B * T * K^2 * M compare-selects at most
// (1.0e9 at K = 8, 6.4e10 at K = 64 on 1024 x 120 points), fewer where a
// slot is empty. The bytes are small: the candidates and points once, the
// reach rows from L1 / L2. The steps of a trace are sequential, so the
// parallel work is the batch and the lookups of one step.
//
// The design:
//
// 1. One CTA per trace, never a thread per trace: at the served K = 8
//    that would be 8 warps of a 1024-trace batch for the whole card. The
//    CTA's threads cover the K columns of the step's block (the next
//    point's candidates j), `group` threads a column (a power of two
//    within a warp), each scanning every group-th entry of the reach row
//    of each previous candidate i, so the lanes of a group read adjacent
//    entries and the groups of a warp read the same ones (a broadcast).
//    The group's partial minima meet by shuffles; the running first
//    argmin over i is kept by every lane of the group alike.
//    ops/hmm.py::viterbi_plan sets threads and group from K.
// 2. The K x K block never exists. A step carries O(K) state in shared
//    memory: the scores, the previous active point's (edge, offset,
//    valid) with its edges' reach rows and lengths (looked up once, when
//    the point becomes the previous one), and the step's candidates and
//    emissions.
// 3. The backpointers and a word per level (its own first argmin, and
//    its keep, active and started bits) go to a global scratch [B, T,
//    K + 1] the wrapper allocates; the backtrack reads them back, so T
//    has no ceiling. The backtrack and the fill are O(T) per trace and
//    run on one thread.
// 4. K is a run-time argument up to kMaxK (64): the shared arrays are
//    sized for it; the wrapper refuses a K past it.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxK = 64;
constexpr int kMaxThreads = 256;
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

// the level word: the level's own first argmin + 1 in the low byte
constexpr int kKeepBit = 1 << 8;
constexpr int kActiveBit = 1 << 9;
constexpr int kStartedBit = 1 << 10;

struct Params {
  const int* ce;               // i32 [B, T, K] candidate edges (-1 empty)
  const float* co;             // f32 [B, T, K] offsets along them
  const float* cd;             // f32 [B, T, K] distances to the point
  const unsigned char* cv;     // bool [B, T, K]
  const float* pts;            // f32 [B, T, 2]
  const unsigned char* vp;     // bool [B, T]
  const float* edge_len;       // f32 [E]
  const int* reach_row;        // i32 [E]
  const int* reach_to;         // i32 [R, M], -1 padded
  const float* reach_dist;     // f32 [R, M]
  int T, K, M, group;
  float em_denom;              // f32(2 sigma_z^2), computed in double
  float beta, factor, breakage, slack;
  int use_keep;                // interpolation_distance > 0
  float d2_min;                // f32(interpolation_distance)^2
  int* scratch;                // i32 [B, T, K + 1]
  int* out_choice;             // i32 [B, T]
  int* out_edge;               // i32 [B, T]
  float* out_offset;           // f32 [B, T]
  unsigned char* out_start;    // bool [B, T]
  unsigned char* out_matched;  // bool [B, T]
};

__global__ void __launch_bounds__(kMaxThreads)
viterbi_decode_kernel(const Params p) {
  const int K = p.K, M = p.M, G = p.group;
  const int tid = threadIdx.x;
  const int j = tid / G;       // this thread's column: candidate j
  const int s = tid % G;       // its slice of each reach row
  const size_t row0 = static_cast<size_t>(blockIdx.x) * p.T;

  // the carry: the scores and the previous active point's candidates
  __shared__ float s_score[kMaxK], s_po[kMaxK], s_plen[kMaxK];
  __shared__ int s_pe[kMaxK], s_prow[kMaxK], s_pv[kMaxK];
  // the step's candidates and emissions
  __shared__ float s_o[kMaxK], s_em[kMaxK];
  __shared__ int s_e[kMaxK], s_v[kMaxK];
  __shared__ float s_gc;
  __shared__ int s_flags;      // 1 active, 2 keep, 4 an active point before
  __shared__ int s_own;        // the scores' first argmin, -1 if all BIG

  for (int k = tid; k < K; k += blockDim.x) {
    s_score[k] = kBig;
    s_pe[k] = -1;
    s_po[k] = 0.0f;
    s_pv[k] = 0;
    s_prow[k] = 0;
    s_plen[k] = 0.0f;
  }
  // thread 0's sequential scalars: the previous active point, the last
  // kept point, and whether there is either
  float px = 0.0f, py = 0.0f, lx = 0.0f, ly = 0.0f;
  bool prev_any = false, any_kept = false;
  if (tid == 0) {
    px = lx = p.pts[2 * row0];
    py = ly = p.pts[2 * row0 + 1];
    s_own = -1;
  }
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    const size_t r = row0 + t;
    int* level = p.scratch + r * (K + 1);
    // ---- the step's inputs: candidates, emissions, keep, gc
    bool vj = false;
    if (tid < K) {
      const size_t c = r * K + tid;
      const float d = p.cd[c];
      vj = p.cv[c] != 0;
      s_e[tid] = p.ce[c];
      s_o[tid] = p.co[c];
      s_v[tid] = vj;
      s_em[tid] = vj ? __fdiv_rn(__fmul_rn(d, d), p.em_denom) : kBig;
    }
    const int any_valid = __syncthreads_or(vj);
    if (tid == 0) {
      const float x = p.pts[2 * r], y = p.pts[2 * r + 1];
      const bool v = p.vp[r] != 0;
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
      const bool act = keep && any_valid;
      const float gx = __fsub_rn(x, px), gy = __fsub_rn(y, py);
      s_gc = __fsqrt_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)));
      s_flags = (act ? 1 : 0) | (keep ? 2 : 0) | (prev_any ? 4 : 0);
      if (act) {
        px = x;
        py = y;
        prev_any = true;
      }
    }
    __syncthreads();
    const int flags = s_flags;
    if (flags & 1) {
      // ---- the [K, K] block by columns: best over i of score + trans
      const float gc = s_gc;
      const bool col = j < K && s_v[j] && s_e[j] >= 0 && gc <= p.breakage;
      const int e2 = col ? s_e[j] : 0;
      const float o2 = col ? s_o[j] : 0.0f;
      // the detour guard's limit: a multiply, then an add
      const float limit = __fadd_rn(__fmul_rn(p.factor, gc), 10.0f);
      float best = CUDART_INF_F;
      int arg = 0;
      for (int i = 0; i < K; ++i) {
        const int e1 = s_pe[i];
        const bool ok = col && s_pv[i] && e1 >= 0;
        float gap = kBig;
        if (ok) {
          const size_t base = static_cast<size_t>(s_prow[i]) * M;
          const int* to = p.reach_to + base;
          const float* dist = p.reach_dist + base;
          for (int m = s; m < M; m += G) {
            if (__ldg(to + m) == e2) gap = fminf(gap, __ldg(dist + m));
          }
        }
        for (int off = G >> 1; off > 0; off >>= 1) {
          gap = fminf(gap, __shfl_xor_sync(kFull, gap, off));
        }
        float trans = kBig;
        if (ok) {
          const float po1 = s_po[i];
          const float cross =
              __fadd_rn(__fadd_rn(__fsub_rn(s_plen[i], po1), gap), o2);
          const bool same = e1 == e2 && o2 >= __fsub_rn(po1, p.slack);
          const float direct = fmaxf(__fsub_rn(o2, po1), 0.0f);
          const float route = same ? fminf(direct, cross) : cross;
          if (route < kBig && route <= limit) {
            trans = __fdiv_rn(fabsf(__fsub_rn(route, gc)), p.beta);
          }
        }
        const float via = __fadd_rn(s_score[i], trans);
        if (via < best) {        // the first minimal i
          best = via;
          arg = i;
        }
      }
      // ---- the step's scores and backpointers
      const bool connected = best < kBig;
      const int any_connected = __syncthreads_or(j < K && s == 0 && connected);
      const bool broken = !any_connected || !(flags & 4);
      if (j < K && s == 0) {
        const float em = s_em[j];
        s_score[j] = broken ? em : (connected ? __fadd_rn(best, em) : kBig);
        level[j] = (broken || !connected) ? -1 : arg;
        const int e = s_e[j];
        s_pe[j] = e;
        s_po[j] = s_o[j];
        s_pv[j] = s_v[j];
        s_prow[j] = e >= 0 ? __ldg(p.reach_row + e) : 0;
        s_plen[j] = e >= 0 ? __ldg(p.edge_len + e) : 0.0f;
      }
      __syncthreads();
      // ---- the level's own first argmin over the new scores (warp 0)
      if (tid < 32) {
        float v = CUDART_INF_F;
        int idx = K;
        for (int k = tid; k < K; k += 32) {
          const float sc = s_score[k];
          if (sc < v) {
            v = sc;
            idx = k;
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(kFull, v, off);
          const int oi = __shfl_xor_sync(kFull, idx, off);
          if (ov < v || (ov == v && oi < idx)) {
            v = ov;
            idx = oi;
          }
        }
        if (tid == 0) {
          s_own = v < kBig ? idx : -1;
          level[K] = (s_own + 1) | kActiveBit | (flags & 2 ? kKeepBit : 0) |
                     (broken ? kStartedBit : 0);
        }
      }
    } else {
      // an inactive point passes the carry through: identity backpointers
      if (tid < K) level[tid] = tid;
      if (tid == 0) level[K] = (s_own + 1) | (flags & 2 ? kKeepBit : 0);
    }
    __syncthreads();
  }

  if (tid != 0) return;
  // ---- the backtrack: the slot chosen one level above, through identity
  // backpointers at inactive levels; a level is a chain terminal where the
  // level above started a chain (or there is none above)
  int nxt = -1;
  bool nxt_started = true;
  for (int t = p.T - 1; t >= 0; --t) {
    const size_t r = row0 + t;
    const int w = p.scratch[r * (K + 1) + K];
    const int own = (w & 0xff) - 1;
    int prop = -1;
    if (nxt >= 0 && t + 1 < p.T) prop = p.scratch[(r + 1) * (K + 1) + nxt];
    const int choice = (nxt_started || nxt < 0) ? own : prop;
    p.out_choice[r] = (w & kActiveBit) ? choice : -1;
    nxt = choice;
    nxt_started = (w & kStartedBit) != 0;
  }
  // ---- the chosen candidates, then the interpolation fill: a valid point
  // that did not vote takes the last matched point's (edge, offset)
  int pe = -1;
  float po = 0.0f;
  bool pok = false;
  for (int t = 0; t < p.T; ++t) {
    const size_t r = row0 + t;
    const int w = p.scratch[r * (K + 1) + K];
    const int c = p.out_choice[r];
    const bool m = c >= 0;
    int e = -1;
    float o = 0.0f;
    if (m) {
      e = p.ce[r * K + c];
      // the plain version's masked sum over K: adding +0 as it does
      o = __fadd_rn(p.co[r * K + c], 0.0f);
    }
    const bool use = p.vp[r] && !(w & kKeepBit) && pok && !m;
    p.out_edge[r] = use ? pe : e;
    p.out_offset[r] = use ? po : o;
    p.out_matched[r] = m || use;
    p.out_start[r] = (w & kStartedBit) != 0;
    if (m) {
      pe = e;
      po = o;
    }
    pok = pok || m;
  }
}

}  // namespace

// One launch of the decode over B traces on `stream`, one CTA of
// `threads` threads a trace, `group` threads a column (a power of two
// that divides 32; threads / group columns, at least K). Returns
// cudaGetLastError() after the launch, or -1 for an argument the kernel
// does not take (K past kMaxK, a plan that does not cover K).
extern "C" int rtt_viterbi_decode(
    const int* ce, const float* co, const float* cd, const unsigned char* cv,
    const float* pts, const unsigned char* vp, const float* edge_len,
    const int* reach_row, const int* reach_to, const float* reach_dist,
    int B, int T, int K, int M, int threads, int group, float em_denom,
    float beta, float factor, float breakage, float slack, int use_keep,
    float d2_min, int* scratch, int* out_choice, int* out_edge,
    float* out_offset, unsigned char* out_start, unsigned char* out_matched,
    void* stream) {
  if (B < 1 || T < 1 || K < 1 || K > kMaxK || M < 1) return -1;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return -1;
  if (group < 1 || group > 32 || (group & (group - 1)) != 0) return -1;
  if (threads / group < K) return -1;
  Params p{ce,       co,        cd,         cv,        pts,        vp,
           edge_len, reach_row, reach_to,   reach_dist, T,         K,
           M,        group,     em_denom,   beta,      factor,     breakage,
           slack,    use_keep,  d2_min,     scratch,   out_choice, out_edge,
           out_offset, out_start, out_matched};
  viterbi_decode_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
