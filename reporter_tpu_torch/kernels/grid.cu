// The grid candidate backend's selection for Hopper (sm_90a): per point,
// its cell row of the spatial grid, the distance to each of the row's C
// segments and the K nearest distinct edges, one launch a batch.
//
// Replaces reporter_tpu/ops/candidates.py's find_candidates (:139-162)
// with its lax.scan of K argmin steps, _topk_distinct_edges (:117-137),
// vmapped over points: jnp, not a Pallas kernel. The port's plain version
// (ops/candidates.py::_find_candidates_plain) runs it as K Python steps of
// masks, gathers and minimums over the [..., C] rows, each a handful of
// launches. This kernel is that plain version's arithmetic, one rounding
// per operation in its order (the intrinsics below, and -fmad=false), with
// its tie order, so it is bit-equal to it in all four outputs.
//
// What bounds it on this card: the bytes of the cell rows (8 * C f32 a
// point, C = 64 by default, read once per point though neighbouring points
// share a row, which L2 serves) and latency of the K selection rounds; the
// operations are some 30 a slot.
//
// A warp a point, four points a CTA. The lanes take the row's slots j =
// lane, lane + 32, ...: the cell index (f32 floor of (v - origin) / cell,
// clamped in float to [-1, n] first, then to the grid), each slot's squared
// distance d2 and projection t in _point_segment_dist's order, valid where
// the edge id is >= 0 and sqrt(d2) <= the radius; the key is d2, or BIG.
// The keys, t and edge ids of the row go to the warp's shared memory. Then
// up to K rounds: the first minimal (key, slot) by a warp reduction of
// (key bits << 32 | slot) (the keys are >= +0, so their bits order as
// their values), which is the plain version's first minimal slot; a round
// whose minimum is BIG ends the list (every later round of the plain
// version then picks nothing too); else lane 0 writes (edge, off0 + t *
// slen, sqrt(d2), 1) and every slot of that edge is set to BIG, so an
// edge appears once, at its closest slot. The unfilled places get (-1, 0,
// BIG, 0).

#include <atomic>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;            // points a CTA
constexpr int kMaxSmem = 232448;     // a CTA's shared memory on sm_90
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
// the cell_pack components (tiles/tileset.py PACK_*)
constexpr int kAx = 0, kAy = 1, kBx = 2, kBy = 3, kOff = 4, kLen = 5,
              kEdge = 6, kNComp = 8;

struct GridParams {
  const float* pts;
  const float* pack;
  int N, C, K, gw, gh;
  float ox, oy, cell, radius;
  int* edge;
  float* offset;
  float* dist;
  unsigned char* valid;
};

// the cell index along one axis, as ops/candidates.py::gather_cell_pack:
// floor((v - o) / cell) in f32, clamped in float to [-1, n] (a far
// point's quotient may not fit an int), then to [0, n - 1]
__device__ inline int cell_axis(float v, float o, float cell, int n) {
  float q = floorf(__fdiv_rn(__fsub_rn(v, o), cell));
  q = fminf(fmaxf(q, -1.0f), static_cast<float>(n));
  return min(max(static_cast<int>(q), 0), n - 1);
}

__global__ void __launch_bounds__(kWarps * 32)
    grid_candidates_kernel(GridParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + w;
  if (i >= p.N) return;              // a whole warp: no CTA barrier below
  const int C = p.C, K = p.K;
  float* s_key = reinterpret_cast<float*>(smem) + w * 3 * C;
  float* s_t = s_key + C;
  int* s_e = reinterpret_cast<int*>(s_t + C);

  const float px = p.pts[2 * i], py = p.pts[2 * i + 1];
  const long long cell =
      static_cast<long long>(cell_axis(px, p.ox, p.cell, p.gw)) * p.gh +
      cell_axis(py, p.oy, p.cell, p.gh);
  const float* row = p.pack + cell * kNComp * C;
  for (int j = lane; j < C; j += 32) {
    const float ax = row[kAx * C + j], ay = row[kAy * C + j];
    const float bx = row[kBx * C + j], by = row[kBy * C + j];
    const int e = __float_as_int(row[kEdge * C + j]);
    const float abx = __fsub_rn(bx, ax), aby = __fsub_rn(by, ay);
    const float denom =
        fmaxf(__fadd_rn(__fmul_rn(abx, abx), __fmul_rn(aby, aby)), 1e-12f);
    const float num = __fadd_rn(__fmul_rn(__fsub_rn(px, ax), abx),
                                __fmul_rn(__fsub_rn(py, ay), aby));
    const float t = fminf(fmaxf(__fdiv_rn(num, denom), 0.0f), 1.0f);
    const float dx = __fsub_rn(px, __fadd_rn(ax, __fmul_rn(t, abx)));
    const float dy = __fsub_rn(py, __fadd_rn(ay, __fmul_rn(t, aby)));
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const bool ok = e >= 0 && __fsqrt_rn(d2) <= p.radius;
    s_key[j] = ok ? d2 : kBig;
    s_t[j] = t;
    s_e[j] = e;
  }
  __syncwarp();

  const size_t base = static_cast<size_t>(i) * K;
  int k = 0;
  for (; k < K; ++k) {
    unsigned long long best = ~0ull;
    for (int j = lane; j < C; j += 32) {
      const unsigned long long key =
          (static_cast<unsigned long long>(__float_as_uint(s_key[j])) << 32) |
          static_cast<unsigned>(j);
      best = key < best ? key : best;
    }
    for (int off = 16; off; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, best, off);
      best = o < best ? o : best;
    }
    const float d2 = __uint_as_float(static_cast<unsigned>(best >> 32));
    if (!(d2 < kBig)) break;         // no candidate left: the list ends
    const int j = static_cast<int>(best & 0xffffffffu);
    const int e = s_e[j];
    if (lane == 0) {
      p.edge[base + k] = e;
      p.offset[base + k] =
          __fadd_rn(row[kOff * C + j], __fmul_rn(s_t[j], row[kLen * C + j]));
      p.dist[base + k] = __fsqrt_rn(d2);
      p.valid[base + k] = 1;
    }
    __syncwarp();
    for (int jj = lane; jj < C; jj += 32) {
      if (s_e[jj] == e) s_key[jj] = kBig;
    }
    __syncwarp();
  }
  for (int kk = k + lane; kk < K; kk += 32) {
    p.edge[base + kk] = -1;
    p.offset[base + kk] = 0.0f;
    p.dist[base + kk] = kBig;
    p.valid[base + kk] = 0;
  }
}

// the shared bytes of a CTA at row width C (-1 past the card's): each
// warp's keys, t and edge ids
int smem_bytes(int C) {
  if (C < 1) return -1;
  const long long n = static_cast<long long>(kWarps) * 3 * C * 4;
  return n > kMaxSmem ? -1 : static_cast<int>(n);
}

}  // namespace

// The K nearest distinct edges of N points (pts f32 [N, 2]) from their
// cells' rows of pack (f32 [gw * gh, 8 * C]) within `radius` → edge i32,
// offset f32, dist f32, valid u8, each [N, K]. Returns cudaGetLastError()
// after the launch, or -1 for a shape it does not take.
extern "C" int rtt_grid_candidates(const float* pts, const float* pack, int N,
                                   int C, int K, int gw, int gh, float ox,
                                   float oy, float cell, float radius,
                                   int* edge, float* offset, float* dist,
                                   unsigned char* valid, void* stream) {
  if (N < 1 || K < 1 || gw < 1 || gh < 1) return -1;
  const int smem = smem_bytes(C);
  if (smem < 0) return -1;
  // more than 48 KB of dynamic shared memory needs the attribute, set
  // once per device
  static std::atomic<unsigned long long> attribute_set{0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  const unsigned long long bit = 1ull << dev;
  if (!(attribute_set.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        grid_candidates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set.fetch_or(bit);
  }
  GridParams p{pts, pack, N, C, K, gw, gh, ox, oy, cell, radius,
               edge, offset, dist, valid};
  grid_candidates_kernel<<<(N + kWarps - 1) / kWarps, kWarps * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
