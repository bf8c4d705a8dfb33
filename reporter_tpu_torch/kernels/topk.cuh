// The running top-K of one probe point, shared by the five arms of the
// sweep kernel (sweep_exact.cu), in two forms with one interface (reset,
// offer): RegList, held in registers at a width K that is a template
// parameter (every arm is instantiated at each K of SWEEP_KS,
// kernels/build.py), and WideList, held in global memory at a width given
// at run time (the wide instance, which serves every K > 16).
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

// The list at a width k given at run time: its slots in a slot-major
// scratch [3][k][npad] of global memory (d^2, edge bits, offset; slot i of
// point p at i * npad + p), so the 32 lanes of a warp touch 32 consecutive
// words. The first n slots are filled, in the order above; the others are
// empty and are written as such by the store. The k-th slot's (d^2, edge)
// stays in registers as the admission bound (kBig, -1 until the list is
// full), so an offer that cannot enter touches no memory. Such an offer
// (d^2, e) is not before the k-th slot; an edge held in a slot i keeps
// bd[i] <= the k-th d^2 <= d^2, so the offer can change only an equal d^2's
// offset, and an equal d^2 at a slot above the k-th has a smaller edge id
// than the k-th's <= e: so only the edge of the k-th slot itself may take
// a smaller offset at its d^2, and the fast rejection checks that one
// case. Otherwise the held edge or the new entry moves up from its slot by
// one insertion pass, the register list's bubble for a list sorted but for
// that one entry.
struct WideList {
  float* d;        // this point's slot 0 of each field
  int* e;
  float* o;
  float* base;     // the scratch
  long s;          // npad: the stride between slots
  int k, n;
  float kd;        // the admission bound: the k-th slot's (d^2, edge)
  int ke;

  __device__ __forceinline__ WideList(float* scratch, long npad, int width)
      : d(nullptr), e(nullptr), o(nullptr), base(scratch), s(npad),
        k(width), n(0), kd(kBig), ke(-1) {}

  __device__ __forceinline__ void reset(long p) {
    d = base + p;
    e = reinterpret_cast<int*>(base + k * s) + p;
    o = base + 2 * k * s + p;
    n = 0;
    kd = kBig;
    ke = -1;
  }

  __device__ __forceinline__ void offer(float dd, int ee, float oo) {
    if (!before(dd, ee, kd, ke)) {
      if (dd == kd && ee == ke) {
        float* q = o + (k - 1) * s;
        if (oo < *q) *q = oo;
      }
      return;
    }
    int i = 0;
    while (i < n && e[i * s] != ee) ++i;
    int j;
    if (i < n) {                          // held: keeps its smallest d^2
      const float hd = d[i * s];
      if (!(dd < hd)) {
        if (dd == hd && oo < o[i * s]) o[i * s] = oo;
        return;
      }
      j = i;
    } else {                              // new: the bottom slot
      j = n < k ? n++ : k - 1;
    }
    for (; j > 0; --j) {
      const float pd = d[(j - 1) * s];
      const int pe = e[(j - 1) * s];
      if (!before(dd, ee, pd, pe)) break;
      d[j * s] = pd;
      e[j * s] = pe;
      o[j * s] = o[(j - 1) * s];
    }
    d[j * s] = dd;
    e[j * s] = ee;
    o[j * s] = oo;
    if (n == k) {
      kd = d[(k - 1) * s];
      ke = e[(k - 1) * s];
    }
  }
};

}  // namespace rtt
