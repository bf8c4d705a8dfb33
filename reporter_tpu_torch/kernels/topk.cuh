// The running top-K of one probe point, shared by the five arms of the
// sweep kernel (sweep_exact.cu), in two forms with one interface (reset,
// offer): RegList, held in registers at a width K that is a template
// parameter (every arm is instantiated at each K of SWEEP_KS,
// kernels/build.py), and WideList, held in memory at a width given at run
// time (the wide instances, which serve every K > 16): in the CTA's
// dynamic shared memory beside the ring, or past the K whose lists fit
// there, in a global scratch.
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

// The register list at width K: the arrays above.
template <int K>
struct RegList {
  float bd[K];
  int be[K];
  float bo[K];

  __device__ __forceinline__ RegList(float*, long, int) {}
  __device__ __forceinline__ void reset(long) { rtt::reset<K>(bd, be, bo); }
  __device__ __forceinline__ void offer(float d, int e, float o) {
    rtt::offer<K>(d, e, o, bd, be, bo);
  }
};

// Where slot i of a list's fields lies. In a CTA's shared memory ([3][k]
// [STRIDE] words, a row per consumer thread): a 32-bit index off the
// lists' base, which keeps the instance's registers down; in the global
// scratch (STRIDE = 0: [3][k][npad], a row per point): a pointer per
// field and the run-time stride. (In a development run on the card the
// 32-bit index took the shared-memory instances from 72 registers to
// 65-71 and sub_bf16's spill away; in the scratch instance it made ptxas
// spill, where the pointers do not.)
template <int STRIDE>
struct Slots {
  float* base;
  int k;
  int row = 0;

  __device__ __forceinline__ Slots(float* lists, long, int width)
      : base(lists), k(width) {}
  __device__ __forceinline__ void reset(long r) { row = static_cast<int>(r); }
  __device__ __forceinline__ float& d(int i) const {
    return base[i * STRIDE + row];
  }
  __device__ __forceinline__ int& e(int i) const {
    return reinterpret_cast<int*>(base)[(k + i) * STRIDE + row];
  }
  __device__ __forceinline__ float& o(int i) const {
    return base[(2 * k + i) * STRIDE + row];
  }
};

template <>
struct Slots<0> {
  float* base;
  int k;
  long s;
  float* dp = nullptr;
  int* ep = nullptr;
  float* op = nullptr;

  __device__ __forceinline__ Slots(float* lists, long stride, int width)
      : base(lists), k(width), s(stride) {}
  __device__ __forceinline__ void reset(long p) {
    const long field = k * s;
    dp = base + p;
    ep = reinterpret_cast<int*>(base + field) + p;
    op = base + 2 * field + p;
  }
  __device__ __forceinline__ float& d(int i) const { return dp[i * s]; }
  __device__ __forceinline__ int& e(int i) const { return ep[i * s]; }
  __device__ __forceinline__ float& o(int i) const { return op[i * s]; }
};

// The list at a width k given at run time, its slots slot-major per field
// (d^2, edge bits, offset; slot i of row r at i * stride + r): in shared
// memory the rows are a CTA's 256 consumer threads (STRIDE = 256), so the
// 32 lanes of a warp touch 32 consecutive words, one per bank, whichever
// slot each lane reads; in the global scratch the rows are the points
// (STRIDE = 0: the stride, npad, given at run time). The first n slots are
// filled, in the order above; the others are never read (the store writes
// them as empty).
//
// What an offer costs, from sf at 150 m (scripts/wide_list_offers.py,
// PERF.md section 6): ~31 in-radius offers a point, ~27 of them a new
// edge, so at K = 32 most lists never fill and the admission bound below
// rarely engages. So:
// - The admission bound. The k-th slot's (d^2, edge) stays in registers
//   (kBig, -1 until the list is full), so an offer that cannot enter
//   touches no memory. Such an offer (d^2, e) is not before the k-th slot;
//   an edge held in a slot i keeps bd[i] <= the k-th d^2 <= d^2, so the
//   offer can change only an equal d^2's offset, and an equal d^2 at a
//   slot above the k-th has a smaller edge id than the k-th's <= e: so
//   only the edge of the k-th slot itself may take a smaller offset at its
//   d^2, and the fast rejection checks that one case.
// - The held-edge test. A 64-bit mask in registers has bit h(e) set for
//   every edge entered since the reset (a Bloom filter of one hash; an
//   evicted edge keeps its bit, so it holds a superset): an edge whose bit
//   is clear is not held, and skips the scan. Otherwise the scan reads
//   kScan slots' edges a step, as independent loads in flight together.
// - The insertion. The held edge that improved, or the new entry at the
//   bottom slot, moves up: kMove slots a step are read at once, the ones
//   after the entry (a run, the list being sorted) move down one each, and
//   the step ends the pass where the run ends.
template <int STRIDE>
struct WideList {
  static constexpr int kScan = 8;   // edges read per step of the scan
  static constexpr int kMove = 4;   // slots read per step of the insertion

  Slots<STRIDE> m;   // the fields: d^2, edge bits, offset
  int k, n;
  float kd;        // the admission bound: the k-th slot's (d^2, edge)
  int ke;
  unsigned long long seen;   // the Bloom mask of the edges entered

  __device__ __forceinline__ WideList(float* lists, long stride, int width)
      : m(lists, stride, width), k(width), n(0), kd(kBig), ke(-1),
        seen(0ull) {}

  __device__ __forceinline__ float& d(int i) const { return m.d(i); }
  __device__ __forceinline__ int& e(int i) const { return m.e(i); }
  __device__ __forceinline__ float& o(int i) const { return m.o(i); }

  __device__ __forceinline__ void reset(long row) {
    m.reset(row);
    n = 0;
    kd = kBig;
    ke = -1;
    seen = 0ull;
  }

  static __device__ __forceinline__ unsigned long long bit(int ee) {
    return 1ull << ((static_cast<unsigned>(ee) * 2654435761u) >> 26);
  }

  // the slot of edge ee among the first n, or n
  __device__ __forceinline__ int find(int ee) const {
    for (int b = 0; b < n; b += kScan) {
      int hit = kScan;
#pragma unroll
      for (int u = kScan - 1; u >= 0; --u) {
        if (b + u < n && e(b + u) == ee) hit = u;
      }
      if (hit < kScan) return b + hit;
    }
    return n;
  }

  // (dd, ee, oo) into slot j or above: the slots above j that come after
  // it move down one (slot j's own content is overwritten)
  __device__ __forceinline__ void place(int j, float dd, int ee, float oo) {
    while (j > 0) {
      float pd[kMove], po[kMove];
      int pe[kMove];
      int m = 0;
#pragma unroll
      for (int u = 0; u < kMove; ++u) {
        pd[u] = 0.f;
        po[u] = 0.f;
        pe[u] = 0;
        if (j - 1 - u >= 0) {
          pd[u] = d(j - 1 - u);
          pe[u] = e(j - 1 - u);
          po[u] = o(j - 1 - u);
          m += before(dd, ee, pd[u], pe[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kMove; ++u) {
        if (u < m) {
          d(j - u) = pd[u];
          e(j - u) = pe[u];
          o(j - u) = po[u];
        }
      }
      j -= m;
      if (m < kMove) break;
    }
    d(j) = dd;
    e(j) = ee;
    o(j) = oo;
  }

  __device__ __forceinline__ void offer(float dd, int ee, float oo) {
    if (!before(dd, ee, kd, ke)) {
      if (dd == kd && ee == ke && oo < o(k - 1)) o(k - 1) = oo;
      return;
    }
    const unsigned long long b = bit(ee);
    const int i = (seen & b) ? find(ee) : n;
    int j;
    if (i < n) {                          // held: keeps its smallest d^2
      const float hd = d(i);
      if (!(dd < hd)) {
        if (dd == hd && oo < o(i)) o(i) = oo;
        return;
      }
      j = i;
    } else {                              // new: the bottom slot
      seen |= b;
      j = n < k ? n++ : k - 1;
    }
    place(j, dd, ee, oo);
    if (n == k) {
      kd = d(k - 1);
      ke = e(k - 1);
    }
  }
};

}  // namespace rtt
