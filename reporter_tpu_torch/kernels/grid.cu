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
// share a row, which L2 serves) and the latency of the selection; the
// operations are some 30 a slot.
//
// A warp a point, four points a CTA. The lanes take the row's slots j =
// lane, lane + 32, ...: the cell index (f32 floor of (v - origin) / cell,
// clamped in float to [-1, n] first, then to the grid), each slot's squared
// distance d2 and projection t in _point_segment_dist's order, valid where
// the edge id is >= 0 and sqrt(d2) <= the radius.
//
// The plain version's K rounds (take the first minimal (d2, slot), then
// mask every slot of its edge) pick, in ascending (d2, slot), each edge's
// representative: its slot of least (d2, slot), so an edge appears once,
// at its closest slot. A round picks a representative: masking removes
// only slots of edges already picked, so the first minimal (d2, slot)
// left is a representative, and every representative of a smaller key
// was picked before it. The rounds stop at the first BIG (no valid slot
// left) or at K. So the list is the representatives of the valid slots
// (d2 < BIG) in ascending (d2 bits << 32 | slot) (the keys are >= +0, so
// their bits order as their values, ties by slot as the first minimal
// slot takes them), cut at K, and the kernel builds that ranking with no
// loop over K:
// 1. the valid slots compacted, in slot order, by ballots (within 50 m a
//    row of 64 slots holds a few): their keys and edges;
// 2. a compacted slot is a representative where no other compacted slot of
//    its edge has a smaller key (one pass over the compacted list);
// 3. a representative's place is the count of representatives with a
//    smaller key; those placed below K write (edge, off0 + t * slen,
//    sqrt(d2), 1) there;
// 4. the places from the representatives' count up to K get (-1, 0, BIG,
//    0).

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

// a warp's shared arrays: the compacted keys (u64 [C]), their edges (i32
// [C]), each slot's projection t (f32 [C]) and the representative flags
// (u8 [C], rounded up to 8 bytes)
__host__ __device__ inline int warp_bytes(int C) {
  return 8 * C + 4 * C + 4 * C + ((C + 7) & ~7);
}

__global__ void __launch_bounds__(kWarps * 32)
    grid_candidates_kernel(GridParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + w;
  if (i >= p.N) return;              // a whole warp: no CTA barrier below
  const int C = p.C, K = p.K;
  unsigned char* base = smem + static_cast<size_t>(w) * warp_bytes(C);
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(base);
  int* s_e = reinterpret_cast<int*>(base + 8 * C);
  float* s_t = reinterpret_cast<float*>(base + 12 * C);
  unsigned char* s_rep = base + 16 * C;

  const float px = p.pts[2 * i], py = p.pts[2 * i + 1];
  const long long cell =
      static_cast<long long>(cell_axis(px, p.ox, p.cell, p.gw)) * p.gh +
      cell_axis(py, p.oy, p.cell, p.gh);
  const float* row = p.pack + cell * kNComp * C;
  // ---- 1. the valid slots, compacted in slot order
  int n = 0;
  for (int j0 = 0; j0 < C; j0 += 32) {
    const int j = j0 + lane;
    bool ok = false;
    unsigned long long key = 0ull;
    int e = -1;
    if (j < C) {
      const float ax = row[kAx * C + j], ay = row[kAy * C + j];
      const float bx = row[kBx * C + j], by = row[kBy * C + j];
      e = __float_as_int(row[kEdge * C + j]);
      const float abx = __fsub_rn(bx, ax), aby = __fsub_rn(by, ay);
      const float denom = fmaxf(
          __fadd_rn(__fmul_rn(abx, abx), __fmul_rn(aby, aby)), 1e-12f);
      const float num = __fadd_rn(__fmul_rn(__fsub_rn(px, ax), abx),
                                  __fmul_rn(__fsub_rn(py, ay), aby));
      const float t = fminf(fmaxf(__fdiv_rn(num, denom), 0.0f), 1.0f);
      const float dx = __fsub_rn(px, __fadd_rn(ax, __fmul_rn(t, abx)));
      const float dy = __fsub_rn(py, __fadd_rn(ay, __fmul_rn(t, aby)));
      const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      ok = e >= 0 && __fsqrt_rn(d2) <= p.radius;
      key = (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) |
            static_cast<unsigned>(j);
      s_t[j] = t;
    }
    const unsigned m = __ballot_sync(kFull, ok);
    if (ok) {
      const int at = n + __popc(m & ((1u << lane) - 1u));
      s_key[at] = key;
      s_e[at] = e;
    }
    n += __popc(m);
  }
  __syncwarp();
  // ---- 2. the representatives: no slot of the edge with a smaller key
  int reps = 0;
  for (int a0 = 0; a0 < n; a0 += 32) {
    const int a = a0 + lane;
    bool rep = false;
    if (a < n) {
      const unsigned long long key = s_key[a];
      const int e = s_e[a];
      rep = true;
      for (int b = 0; b < n; ++b) {
        if (s_e[b] == e && s_key[b] < key) {
          rep = false;
          break;
        }
      }
      s_rep[a] = rep;
    }
    reps += __popc(__ballot_sync(kFull, rep));
  }
  __syncwarp();
  // ---- 3. each representative's place: the representatives before it
  const size_t out = static_cast<size_t>(i) * K;
  for (int a = lane; a < n; a += 32) {
    if (!s_rep[a]) continue;
    const unsigned long long key = s_key[a];
    int place = 0;
    for (int b = 0; b < n; ++b) place += s_rep[b] && s_key[b] < key;
    if (place < K) {
      const int j = static_cast<int>(key & 0xffffffffu);
      const float d2 = __uint_as_float(static_cast<unsigned>(key >> 32));
      p.edge[out + place] = s_e[a];
      p.offset[out + place] =
          __fadd_rn(row[kOff * C + j], __fmul_rn(s_t[j], row[kLen * C + j]));
      p.dist[out + place] = __fsqrt_rn(d2);
      p.valid[out + place] = 1;
    }
  }
  // ---- 4. the places past the list
  for (int kk = reps + lane; kk < K; kk += 32) {
    p.edge[out + kk] = -1;
    p.offset[out + kk] = 0.0f;
    p.dist[out + kk] = kBig;
    p.valid[out + kk] = 0;
  }
}

// the shared bytes of a CTA at row width C (-1 past the card's): each
// warp's arrays
int smem_bytes(int C) {
  if (C < 1) return -1;
  const long long n = static_cast<long long>(kWarps) * warp_bytes(C);
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
