// Native host prepare of match_many: probe traces -> the wire's input
// buffers, and the Morton keys that order traces within a bucket.
//
// Counterpart: reporter_tpu/native/prepare.cc (reporter_prepare_slice,
// reporter_morton_keys). matcher/native_prepare.py binds these entries with
// ctypes; its numpy forms (prepare_slice_python, morton_keys_python) are the
// specification, and the tests hold the two byte for byte:
//   - pad at the trace's first point (keeps the quantized form in i16
//     range); empty traces stay all-zero with len 0
//   - quantization is f32: round((x - origin_x) * 4.0f) with
//     round-half-to-even (np.round == rint); 4.0f == 1/OFFSET_QUANTUM
//   - the i16 gate is the FLOAT comparison |q| < 32767 -- NaN/inf fail it
//     exactly like numpy's NaN-propagating max, falling back to f32
//   - deltas are int32 diffs of the int32 quanta, zeroed at t >= len;
//     the i8 gate is |d| < 128 in integers
//   - Morton keys floor(first/64)+0x8000, 16-bit masked, bit-spread --
//     the same curve as ops/dense_candidates._morton; non-finite firsts
//     cast like numpy's cvttsd2si (INT64_MIN)
//
// Build: native/build.py (g++ -O3 -Wall -Wextra -Werror -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// One slice row: pad, quantize, delta-pack. Returns (q_ok, d_ok) for the
// caller's global mode reduction. Writes are row-disjoint (thread-safe).
void prepare_row(const float* xy, int64_t n, int64_t b, float* pts,
                 int32_t* len_out, float* origins, int16_t* dq16,
                 int8_t* d8, bool* q_ok_out, bool* d_ok_out) {
  // pad fill: [:n] = xy, [n:] = xy[0] (origin pad); empty row stays 0
  if (n > 0) {
    std::memcpy(pts, xy, size_t(n) * 2 * sizeof(float));
    for (int64_t t = n; t < b; ++t) {
      pts[t * 2] = xy[0];
      pts[t * 2 + 1] = xy[1];
    }
    *len_out = static_cast<int32_t>(n);
  } else {
    std::memset(pts, 0, size_t(b) * 2 * sizeof(float));
    *len_out = 0;
  }
  const float ox = pts[0], oy = pts[1];
  origins[0] = ox;
  origins[1] = oy;
  bool q_ok = true, d_ok = true;
  int32_t px = 0, py = 0;
  for (int64_t t = 0; t < b; ++t) {
    // f32 arithmetic + rint (ties-to-even) == np.round of the f32 array
    float qx = std::nearbyintf((pts[t * 2] - ox) * 4.0f);
    float qy = std::nearbyintf((pts[t * 2 + 1] - oy) * 4.0f);
    // negated comparison so NaN/inf fail the gate exactly like numpy's
    // NaN-propagating max() < 32767
    if (!(std::fabs(qx) < 32767.0f && std::fabs(qy) < 32767.0f)) {
      q_ok = false;
      break;
    }
    int32_t qxi = static_cast<int32_t>(qx), qyi = static_cast<int32_t>(qy);
    dq16[t * 2] = static_cast<int16_t>(qxi);
    dq16[t * 2 + 1] = static_cast<int16_t>(qyi);
    int32_t dx = qxi - px, dy = qyi - py;
    if (t >= n) dx = dy = 0;  // pad-region deltas are zeroed (api parity)
    if (!(std::abs(dx) < 128 && std::abs(dy) < 128)) d_ok = false;
    d8[t * 2] = static_cast<int8_t>(dx);
    d8[t * 2 + 1] = static_cast<int8_t>(dy);
    px = qxi;
    py = qyi;
  }
  *q_ok_out = q_ok;
  *d_ok_out = q_ok && d_ok;
}

// ops/dense_candidates._morton: interleave 16-bit coords, 64-bit lanes.
uint64_t spread16(uint64_t v) {
  v = (v | (v << 16)) & 0x0000FFFF0000FFFFULL;
  v = (v | (v << 8)) & 0x00FF00FF00FF00FFULL;
  v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0FULL;
  v = (v | (v << 2)) & 0x3333333333333333ULL;
  v = (v | (v << 1)) & 0x5555555555555555ULL;
  return v;
}

// numpy f64→i64 cast semantics (cvttsd2si): out-of-range / NaN / ±inf
// all collapse to INT64_MIN — keep the native keys bit-equal to the
// numpy path even on poison coordinates.
int64_t cast_i64(double v) {
  if (!(v >= -9.223372036854775e18 && v <= 9.223372036854775e18))
    return INT64_MIN;
  return static_cast<int64_t>(v);
}

}  // namespace

extern "C" {

// Pack one submit slice from a flat [n_pts, 2] f32 buffer. offs[B+1]
// bounds each row's points (offs[r+1]-offs[r] <= b; caller enforces the
// bucket). Fills pts [B,b,2] f32, lens [B] i32, origins [B,2] f32,
// dq16 [B,b,2] i16, d8 [B,b,2] i8.
//
// Returns the wire mode: 2 = i8 deltas (the preferred infeed), 1 = i16
// absolutes (some step overflowed ±127 quanta), 0 = f32 points (some
// trace spans past the i16 range, or poison NaN/inf coordinates). Rows
// are processed in parallel; dq16/d8 contents are only meaningful for
// the returned mode (matching what the numpy path materializes).
int32_t reporter_prepare_slice(const float* xy, const int64_t* offs,
                               int64_t B, int64_t b, int32_t n_threads,
                               float* pts, int32_t* lens, float* origins,
                               int16_t* dq16, int8_t* d8) {
  if (B <= 0) return 2;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > B) n_threads = static_cast<int32_t>(B);
  std::vector<uint8_t> q_ok(B), d_ok(B);
  int64_t per = (B + n_threads - 1) / n_threads;

  auto run = [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      bool qo = false, dok = false;
      prepare_row(xy + offs[r] * 2, offs[r + 1] - offs[r], b,
                  pts + r * b * 2, lens + r, origins + r * 2,
                  dq16 + r * b * 2, d8 + r * b * 2, &qo, &dok);
      q_ok[r] = qo ? 1 : 0;
      d_ok[r] = dok ? 1 : 0;
    }
  };
  if (n_threads == 1) {
    run(0, B);
  } else {
    std::vector<std::thread> workers;
    for (int32_t w = 0; w < n_threads; ++w) {
      int64_t lo = w * per, hi = std::min(B, lo + per);
      if (lo < hi) workers.emplace_back(run, lo, hi);
    }
    for (auto& th : workers) th.join();
  }
  int32_t mode = 2;
  for (int64_t r = 0; r < B; ++r) {
    if (!q_ok[r]) return 0;
    if (!d_ok[r]) mode = 1;
  }
  return mode;
}

// Morton keys of per-work-item first points (f64 [W,2], biased +0x8000
// at 64 m resolution) — matcher/native_prepare.morton_keys_python without
// the numpy passes. Keys land in the low 32 bits of u64 lanes.
void reporter_morton_keys(const double* first, int64_t W, uint64_t* keys) {
  for (int64_t w = 0; w < W; ++w) {
    uint64_t qx = static_cast<uint64_t>(
                      cast_i64(std::floor(first[w * 2] / 64.0)) + 0x8000) &
                  0xFFFF;
    uint64_t qy = static_cast<uint64_t>(
                      cast_i64(std::floor(first[w * 2 + 1] / 64.0)) + 0x8000) &
                  0xFFFF;
    keys[w] = spread16(qx) | (spread16(qy) << 1);
  }
}

}  // extern "C"
