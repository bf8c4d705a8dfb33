// The single-trace ranked-path lattice for Hopper (sm_90a): the keep
// mask, the list-Viterbi forward pass and the R-path backtrack behind
// SegmentMatcher.match_topk, one launch each.
//
// Replaces three lax.scan programs of reporter_tpu/ops/hmm.py, not Pallas
// kernels: interpolation_keep_mask (:268-287), the forward scans
// _forward_lattice (:290-339, one path a state) and the list step of
// viterbi_kbest_paths (:519-558, R paths a state), and the vmapped
// back_one reverse scans (:454-476, :566-590). XLA compiles each scan
// into an on-device loop; the port's plain versions (ops/hmm.py
// _keep_mask_batched, _forward_list_plain, _backtrack_plain) step them
// from the host, some 15 small launches a step of the forward pass alone.
// Each kernel is its plain version's arithmetic, one rounding per
// operation in its order (the intrinsics below, and -fmad=false), with
// the plain version's tie orders, so all three are bit-equal to it.
//
// What bounds them on this card: latency, not bytes or operations. The
// steps of a trace are sequential and one trace is one call, so one CTA
// walks T steps; a step's work (at most K columns of an R-deep merge) is
// small. The bytes (the transition blocks [T, K, K] in, the levels [T,
// K * R] out) are megabytes at most.
//
// keep mask: a thread a trace, T points in order (the last kept point,
//   d2 = dx*dx + dy*dy against f32(interp)^2).
// forward: one CTA of `threads` (ops/hmm.py::lattice_plan, 64-256), the
//   carried scores [K, R] double-buffered in shared memory. The next
//   step's transition block [K, K] and emissions [K] are copied in with
//   cp.async while this step computes. Per active step, thread c < K
//   selects column c's R smallest of score[cp, r] + trans[cp, c], ties by
//   the flat state cp * R + r (torch.sort(stable=True), lax.top_k). Each
//   carried row score[cp, :] ascends: it is best-first sums plus one
//   emission, a restart [em, BIG, ...] or the BIG start, and adding a
//   constant in f32 keeps the order. So the selection is a K-way merge of
//   K sorted rows, no sort: R picks, each the first minimal row head (the
//   smaller cp at equal values, and within a row the smaller r comes
//   first), the winner's row then advancing. At R = 1 that is the first
//   argmin, the plain Viterbi. Then a barrier's OR gives `broken`, and all
//   threads write the new carry, the level's scores and backpointers
//   (identity at an inactive step) and started; warp 0 writes each level's
//   own first-argmin state (the first minimal row head: rows ascend),
//   which the backtrack re-seeds from. Two barriers a step.
// backtrack: a thread a path walks t = T-1 ... 0 from its seed state (the
//   ranked state of the last level), following the level above's
//   backpointer, re-seeding from the level's own argmin at a chain
//   terminal; -1 at inactive levels.

#include <atomic>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxK = 64;
constexpr int kMaxThreads = 256;     // the forward CTA's threads
constexpr int kMaxSmem = 232448;     // a CTA's shared memory on sm_90
constexpr int kKeepThreads = 128;
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ---- the keep mask -------------------------------------------------------

__global__ void lattice_keep_kernel(const float* __restrict__ pts,
                                    const unsigned char* __restrict__ vp,
                                    int B, int T, float d2_min,
                                    unsigned char* __restrict__ keep) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* p = pts + static_cast<size_t>(b) * T * 2;
  const unsigned char* v = vp + static_cast<size_t>(b) * T;
  unsigned char* out = keep + static_cast<size_t>(b) * T;
  float lx = p[0], ly = p[1];
  bool any_kept = false;
  for (int t = 0; t < T; ++t) {
    const float x = p[2 * t], y = p[2 * t + 1];
    const float dx = __fsub_rn(x, lx), dy = __fsub_rn(y, ly);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const bool k = v[t] != 0 && (!any_kept || d2 >= d2_min);
    if (k) {
      lx = x;
      ly = y;
    }
    any_kept = any_kept || k;
    out[t] = k ? 1 : 0;
  }
}

// ---- the forward pass ----------------------------------------------------

// The forward CTA's shared memory, in bytes from its base, each array 16
// aligned (ops/hmm.py::lattice_smem_bytes makes the same sum, which the
// launch checks). Nothing grows with T.
struct Layout {
  int score0, score1, trans0, trans1, em0, em1, hv, hr, bv, bi, flags, bytes;
};

__host__ __device__ inline int take(int& at, int n) {
  const int o = at;
  at += (n + 15) & ~15;
  return o;
}

__host__ __device__ inline Layout make_layout(int K, int R) {
  Layout L{};
  int at = 0;
  const int pitch = K | 1;           // odd: [r][c] and [c][r] walks miss
  L.score0 = take(at, 4 * K * R);    // the carried scores [K, R], twice
  L.score1 = take(at, 4 * K * R);
  L.trans0 = take(at, 4 * K * K);    // the staged transition block, twice
  L.trans1 = take(at, 4 * K * K);
  L.em0 = take(at, 4 * K);           // the staged emissions, twice
  L.em1 = take(at, 4 * K);
  L.hv = take(at, 4 * K * K);        // the merge's row heads [cp][c]
  L.hr = take(at, K * K);            // and their ranks r (u8)
  L.bv = take(at, 4 * R * pitch);    // the picks [r][c]: values
  L.bi = take(at, 4 * R * pitch);    // and states cp * R + r
  L.flags = take(at, 8);             // each buffer's step flags
  L.bytes = at;
  return L;
}

struct FwdParams {
  const float* em;
  const unsigned char* active;
  const unsigned char* prev_any;
  const float* trans;
  int T, K, R;
  float* scores;
  int* backptrs;
  unsigned char* started;
  int* own;
};

// step t's transition block and emissions into shared memory, in flight
// (the caller waits on the pipeline before the barrier that reads them)
__device__ inline void stage_step(const FwdParams& p, int t, float* s_trans,
                                  float* s_em, int tid, int nt) {
  const int KK = p.K * p.K;
  const float* src = p.trans + static_cast<size_t>(t) * KK;
  for (int i = tid; i < KK; i += nt) {
    __pipeline_memcpy_async(s_trans + i, src + i, sizeof(float));
  }
  const float* e = p.em + static_cast<size_t>(t) * p.K;
  for (int i = tid; i < p.K; i += nt) {
    __pipeline_memcpy_async(s_em + i, e + i, sizeof(float));
  }
  __pipeline_commit();
}

__device__ inline int step_flags(const FwdParams& p, int t) {
  return (p.active[t] ? 1 : 0) | (p.prev_any[t] ? 2 : 0);
}

// warp 0: level t's own first-argmin state, from its carried scores: the
// first minimal row head (each row ascends, so a row's first minimum is
// its head), -1 where that minimum is not below BIG
__device__ inline void write_own(const FwdParams& p, const float* cur, int t,
                                 int lane) {
  float best = CUDART_INF_F;
  int arg = p.K;
  for (int cp = lane; cp < p.K; cp += 32) {
    const float v = cur[cp * p.R];
    if (v < best) {
      best = v;
      arg = cp;
    }
  }
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, best, off);
    const int oa = __shfl_xor_sync(kFull, arg, off);
    if (ov < best || (ov == best && oa < arg)) {
      best = ov;
      arg = oa;
    }
  }
  if (lane == 0) p.own[t] = best < kBig ? arg * p.R : -1;
}

__global__ void __launch_bounds__(kMaxThreads)
    lattice_forward_kernel(FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = p.K, R = p.R, KR = K * R, pitch = K | 1;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const Layout L = make_layout(K, R);
  // buffer b of the double-buffered arrays (selected, not indexed: no
  // local-memory pointer arrays)
  auto scores_of = [&](int b) {
    return reinterpret_cast<float*>(smem + (b ? L.score1 : L.score0));
  };
  auto trans_of = [&](int b) {
    return reinterpret_cast<float*>(smem + (b ? L.trans1 : L.trans0));
  };
  auto em_of = [&](int b) {
    return reinterpret_cast<float*>(smem + (b ? L.em1 : L.em0));
  };
  float* hv = reinterpret_cast<float*>(smem + L.hv);
  unsigned char* hr = smem + L.hr;
  float* bv = reinterpret_cast<float*>(smem + L.bv);
  int* bi = reinterpret_cast<int*>(smem + L.bi);
  int* flags = reinterpret_cast<int*>(smem + L.flags);

  for (int s = tid; s < KR; s += nt) scores_of(0)[s] = kBig;
  stage_step(p, 0, trans_of(0), em_of(0), tid, nt);
  if (tid == 0) flags[0] = step_flags(p, 0);
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    const int b = t & 1;
    const float* cur = scores_of(b);
    float* nxt = scores_of(b ^ 1);
    const float* tr = trans_of(b);
    const float* em = em_of(b);
    int next_flags = 0;
    if (t + 1 < p.T) {
      stage_step(p, t + 1, trans_of(b ^ 1), em_of(b ^ 1), tid, nt);
      if (tid == 0) next_flags = step_flags(p, t + 1);
    }
    if (t > 0 && tid < 32) write_own(p, cur, t - 1, lane);
    const int fl = flags[b];
    const bool act = (fl & 1) != 0;

    // column c's R smallest of cur[cp, r] + tr[cp, c]: a K-way merge
    bool conn = false;
    if (act && tid < K) {
      const int c = tid;
      if (R == 1) {
        float best = CUDART_INF_F;
        int arg = 0;
        for (int cp = 0; cp < K; ++cp) {
          const float v = __fadd_rn(cur[cp], tr[cp * K + c]);
          if (v < best) {
            best = v;
            arg = cp;
          }
        }
        bv[c] = best;
        bi[c] = arg;
        conn = best < kBig;
      } else {
        for (int cp = 0; cp < K; ++cp) {
          hv[cp * K + c] = __fadd_rn(cur[cp * R], tr[cp * K + c]);
          hr[cp * K + c] = 0;
        }
        for (int r = 0; r < R; ++r) {
          float best = CUDART_INF_F;
          int arg = 0;
          for (int cp = 0; cp < K; ++cp) {
            const float v = hv[cp * K + c];
            if (v < best) {
              best = v;
              arg = cp;
            }
          }
          const int rr = hr[arg * K + c];
          bv[r * pitch + c] = best;
          bi[r * pitch + c] = arg * R + rr;
          if (rr + 1 < R) {
            hv[arg * K + c] = __fadd_rn(cur[arg * R + rr + 1], tr[arg * K + c]);
            hr[arg * K + c] = static_cast<unsigned char>(rr + 1);
          } else {
            hv[arg * K + c] = CUDART_INF_F;   // the row is spent
          }
        }
        conn = bv[c] < kBig;
      }
    }
    // broken: no column connected, or no active point before this one
    const bool any = __syncthreads_or(conn ? 1 : 0) != 0;
    const bool broken = !any || (fl & 2) == 0;

    // the new carry and the level: restart [em, BIG, ...], or the picks
    // plus the emission where connected; identity at an inactive step
    float* out_s = p.scores + static_cast<size_t>(t) * KR;
    int* out_b = p.backptrs + static_cast<size_t>(t) * KR;
    for (int s = tid; s < KR; s += nt) {
      float v;
      int bp;
      if (act) {
        const int c = s / R, r = s - c * R;
        const float cost = bv[r * pitch + c];
        const bool cn = cost < kBig;
        if (broken) {
          v = r == 0 ? em[c] : kBig;
          bp = -1;
        } else {
          v = cn ? __fadd_rn(cost, em[c]) : kBig;
          bp = cn ? bi[r * pitch + c] : -1;
        }
      } else {
        v = cur[s];
        bp = s;
      }
      nxt[s] = v;
      out_s[s] = v;
      out_b[s] = bp;
    }
    if (tid == 0) p.started[t] = (act && broken) ? 1 : 0;
    __pipeline_wait_prior(0);
    if (tid == 0) flags[b ^ 1] = next_flags;
    __syncthreads();
  }
  if (tid < 32) write_own(p, scores_of(p.T & 1), p.T - 1, lane);
}

// ---- the backtrack -------------------------------------------------------

__global__ void lattice_backtrack_kernel(const int* __restrict__ backptrs,
                                         const unsigned char* __restrict__ started,
                                         const unsigned char* __restrict__ active,
                                         const int* __restrict__ own,
                                         const int* __restrict__ seed, int T,
                                         int S, int P, int* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= P) return;
  int nxt = seed[q];                 // the state the row above points at
  bool nxt_started = false;
  int* o = out + static_cast<size_t>(q) * T;
  for (int t = T - 1; t >= 0; --t) {
    int prop = -1;
    if (nxt >= 0 && nxt < S) {
      prop = t == T - 1 ? nxt : backptrs[static_cast<size_t>(t + 1) * S + nxt];
    }
    // a chain terminal re-seeds from the level's own argmin
    const int choice = (nxt_started || nxt < 0) ? own[t] : prop;
    o[t] = active[t] ? choice : -1;
    nxt = choice;
    nxt_started = started[t] != 0;
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

}  // namespace

// The keep mask of B traces (pts f32 [B, T, 2], vp u8 [B, T]) into keep u8
// [B, T]; d2_min is f32(interp)^2. Returns cudaGetLastError() after the
// launch, or -1 for a shape it does not take.
extern "C" int rtt_lattice_keep(const float* pts, const unsigned char* vp,
                                int B, int T, float d2_min,
                                unsigned char* keep, void* stream) {
  if (B < 1 || T < 1) return -1;
  lattice_keep_kernel<<<(B + kKeepThreads - 1) / kKeepThreads, kKeepThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(
      pts, vp, B, T, d2_min, keep);
  return static_cast<int>(cudaGetLastError());
}

// The forward kernel's shared bytes at (K, R), -1 for a shape it does not
// take (ops/hmm.py::lattice_smem_bytes is held to it on the card).
extern "C" int rtt_lattice_forward_smem(int K, int R) {
  if (K < 1 || K > kMaxK || R < 1 || R > K) return -1;
  return make_layout(K, R).bytes;
}

// The forward pass of one trace: em f32 [T, K], active and prev_any u8
// [T], trans f32 [T, K, K] → scores f32 [T, K * R], backptrs i32 [T, K *
// R], started u8 [T], own i32 [T], one CTA of `threads` with `smem_bytes`
// of shared memory (the layout's, or -1). Returns cudaGetLastError() after
// the launch, or -1 for a shape or plan it does not take.
extern "C" int rtt_lattice_forward(const float* em, const unsigned char* active,
                                   const unsigned char* prev_any,
                                   const float* trans, int T, int K, int R,
                                   int threads, int smem_bytes, float* scores,
                                   int* backptrs, unsigned char* started,
                                   int* own, void* stream) {
  if (T < 1 || K < 1 || K > kMaxK || R < 1 || R > K) return -1;
  if (threads < K || threads < 32 || threads % 32 || threads > kMaxThreads) {
    return -1;
  }
  if (smem_bytes != make_layout(K, R).bytes || smem_bytes > kMaxSmem) {
    return -1;
  }
  static std::atomic<unsigned long long> attribute_set{0};
  const int rc = allow_smem(lattice_forward_kernel, attribute_set);
  if (rc != 0) return rc;
  FwdParams p{em, active, prev_any, trans, T, K, R,
              scores, backptrs, started, own};
  lattice_forward_kernel<<<1, threads, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The backtrack of P paths through T levels of S states: backptrs i32 [T,
// S], started, active u8 [T], own i32 [T], seed i32 [P] → out i32 [P, T],
// a thread a path in CTAs of `threads`. Returns cudaGetLastError() after
// the launch, or -1 for a shape it does not take.
extern "C" int rtt_lattice_backtrack(const int* backptrs,
                                     const unsigned char* started,
                                     const unsigned char* active,
                                     const int* own, const int* seed, int T,
                                     int S, int P, int threads, int* out,
                                     void* stream) {
  if (T < 1 || S < 1 || P < 1 || threads < 32 || threads % 32 ||
      threads > 1024) {
    return -1;
  }
  lattice_backtrack_kernel<<<(P + threads - 1) / threads, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      backptrs, started, active, own, seed, T, S, P, out);
  return static_cast<int>(cudaGetLastError());
}
