// Shared charge-accumulation tile for the TD-VMM kernels (B1 and B2).
//
// One CTA of 256 threads owns a (16 x 64) output tile of one batch entry e
// and walks the whole K axis itself: the loop over K inside the block takes
// the place of the sequential K grid axis of the Pallas kernel
// (repro/kernels/tdvmm/tdvmm.py:_kernel), whose accumulator lived in VMEM
// scratch.  Here it lives in registers: thread (tx, ty) accumulates the 4
// outputs at row ty and columns tx + 16 j, whatever the code storage.
//
// Three code storages, as the Pallas kernel takes them:
//
//   kInt8  int8 codes, int32 accumulator.  Each K step stages a (16 x 64)
//          x tile and a (64 x 64) w tile in shared memory, both packed as
//          int32 words of four consecutive k codes, so the inner product is
//          __dp4a (s8 x s8 -> s32, exact).  w arrives N-major (E, K, N);
//          four rows of four columns are transposed in registers with
//          __byte_perm on the way into shared memory.
//   kInt4  p <= 3 codes packed two per byte along K (quant.pack_int4: byte
//          kp holds code 2kp in the low nibble, 2kp+1 in the high one), the
//          Pallas kernel's _unpack_nibbles mode.  Device memory streams the
//          packed bytes (half the int8 bytes); the loaders sign-extend the
//          nibbles on chip, (v << 4) >> 4 for the low one and v >> 4 for the
//          high one, and feed the same int8 words to the same __dp4a loop.
//          Both operands unpack the same pairs, so the int32 sums are
//          bitwise the int8 ones.
//   kF32   integer-valued float32 codes (p = 8, or noisy codes) and a
//          float32 accumulator, staged in (16 x 32) and (32 x 64) float
//          tiles.  Inside the envelope the JAX package checks (worst
//          |acc| < 2^24) every partial sum is an exact integer, so any
//          summation order, FMA included, is bitwise the plain version.
//
// Ragged M, K and N edges are zero-filled: a zero code is an inert current
// source, so padding is exact.
//
// What bounds it: at the serving shapes with few rows the weight codes
// dominate the bytes and the kernel is bound by device-memory bytes; with
// thousands of rows (prefill, the MoE dispatch buffer) it is bound by its
// own instruction issue on CUDA cores, far below the tensor-core rate.  The
// design reads each code byte from device memory once per CTA row-tile and
// keeps the accumulator and epilogue on chip, so each output is written
// once.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tdvmm {

constexpr int kThreads = 256;
constexpr int kBM = 16;          // output rows per CTA
constexpr int kBN = 64;          // output columns per CTA
constexpr int kBK = 64;          // k codes per shared-memory stage (int)
constexpr int kBKW = kBK / 4;    // ... as packed int32 words
constexpr int kBKF = 32;         // k codes per shared-memory stage (f32)
constexpr int kTN = kBN / 16;    // columns per thread

enum Codes { kInt8 = 0, kInt4 = 1, kF32 = 2 };

template <int CODES>
struct AccType { using T = int; };
template <>
struct AccType<kF32> { using T = float; };

struct TileArgs {
  const void* x;     // (E|1, M, kb) row-major: int8 codes, packed pairs, f32
  const void* w;     // (E, kb, N) row-major
  int M, K, N;       // K: code depth walked (int4: 2 kb, the padded depth)
  int kb;            // stored elements per x row / rows of w
  int shared_x;      // x has one batch entry shared by every e
  int vec_x;         // int8: kb % 4 == 0 and x 4-byte aligned: word loads
  int vec_w;         // int8/int4: N % 4 == 0 and w 4-byte aligned
};

// Sign-extend the low (hi = 0) or high (hi = 1) nibble of each byte of v.
__device__ __forceinline__ uint32_t nibbles(uint32_t v, int hi) {
  uint32_t out = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int8_t byte = (int8_t)(v >> (8 * b));
    const int8_t c = hi ? (int8_t)(byte >> 4)
                        : (int8_t)((int8_t)(byte << 4) >> 4);
    out |= (uint32_t)(uint8_t)c << (8 * b);
  }
  return out;
}

template <int CODES>
__device__ __forceinline__ int load_x_word(const TileArgs& a, const int8_t* xb,
                                           int m, int k) {
  // Codes k..k+3 of row m (k a multiple of 4), code k in the low byte.
  if (m >= a.M) return 0;
  const int8_t* p = xb + (size_t)m * a.kb;
  if (CODES == kInt4) {
    const int kp = k >> 1;
    const uint32_t b0 = kp < a.kb ? (uint32_t)(uint8_t)p[kp] : 0u;
    const uint32_t b1 = kp + 1 < a.kb ? (uint32_t)(uint8_t)p[kp + 1] : 0u;
    const uint32_t v = b0 | (b1 << 8);
    return (int)__byte_perm(nibbles(v, 0), nibbles(v, 1), 0x5140);
  }
  if (k >= a.kb) return 0;
  p += k;
  if (a.vec_x) return *reinterpret_cast<const int*>(p);
  uint32_t v = 0;
  for (int b = 0; b < 4; ++b) {
    uint32_t byte = (k + b < a.kb) ? (uint32_t)(uint8_t)p[b] : 0u;
    v |= byte << (8 * b);
  }
  return (int)v;
}

__device__ __forceinline__ uint32_t load_w_row4(const TileArgs& a,
                                                const int8_t* wb, int r,
                                                int n) {
  // Four consecutive columns n..n+3 of stored row r, column n in the low byte.
  if (r >= a.kb || n >= a.N) return 0u;
  const int8_t* p = wb + (size_t)r * a.N + n;
  if (a.vec_w) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0;
  for (int b = 0; b < 4; ++b) {
    uint32_t byte = (n + b < a.N) ? (uint32_t)(uint8_t)p[b] : 0u;
    v |= byte << (8 * b);
  }
  return v;
}

// Integer codes (kInt8, kInt4): accumulate the CTA's tile over the whole K
// axis into acc[kTN] with __dp4a.
template <int CODES>
__device__ __forceinline__ void integrate_int(const TileArgs& a, int e,
                                              int m0, int n0,
                                              int (&acc)[kTN]) {
  __shared__ int sx[kBM][kBKW + 1];
  __shared__ int sw[kBN][kBKW + 1];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int8_t* xb = static_cast<const int8_t*>(a.x)
                     + (a.shared_x ? 0 : (size_t)e * a.M * a.kb);
  const int8_t* wb = static_cast<const int8_t*>(a.w) + (size_t)e * a.kb * a.N;

#pragma unroll
  for (int j = 0; j < kTN; ++j) acc[j] = 0;

  for (int k0 = 0; k0 < a.K; k0 += kBK) {
    // x tile: 16 rows x 16 words, one word per thread.
    sx[ty][tx] = load_x_word<CODES>(a, xb, m0 + ty, k0 + 4 * tx);
    // w tile: thread (kw, nq) loads code rows 4kw..4kw+3 of columns
    // 4nq..4nq+3 and transposes the 4x4 bytes into one k-packed word per
    // column.
    {
      const int nq = t % 16, kw = t / 16;
      const int k = k0 + 4 * kw, n = n0 + 4 * nq;
      uint32_t r0, r1, r2, r3;
      if (CODES == kInt4) {
        // code rows k, k+1 are the nibbles of stored row k/2; k+2, k+3 of
        // stored row k/2 + 1
        const uint32_t p01 = load_w_row4(a, wb, k >> 1, n);
        const uint32_t p23 = load_w_row4(a, wb, (k >> 1) + 1, n);
        r0 = nibbles(p01, 0);
        r1 = nibbles(p01, 1);
        r2 = nibbles(p23, 0);
        r3 = nibbles(p23, 1);
      } else {
        r0 = load_w_row4(a, wb, k + 0, n);
        r1 = load_w_row4(a, wb, k + 1, n);
        r2 = load_w_row4(a, wb, k + 2, n);
        r3 = load_w_row4(a, wb, k + 3, n);
      }
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
      const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
      const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
      sw[4 * nq + 0][kw] = (int)__byte_perm(t0, t2, 0x5410);
      sw[4 * nq + 1][kw] = (int)__byte_perm(t0, t2, 0x7632);
      sw[4 * nq + 2][kw] = (int)__byte_perm(t1, t3, 0x5410);
      sw[4 * nq + 3][kw] = (int)__byte_perm(t1, t3, 0x7632);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBKW; ++kk) {
      const int av = sx[ty][kk];
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[j] = __dp4a(av, sw[tx + 16 * j][kk], acc[j]);
    }
    __syncthreads();
  }
}

// Float32 codes (kF32): the same tile and thread layout, float32 FMAs.
__device__ __forceinline__ void integrate_f32(const TileArgs& a, int e, int m0,
                                              int n0, float (&acc)[kTN]) {
  __shared__ float sx[kBM][kBKF + 1];
  __shared__ float sw[kBKF][kBN];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const float* xb = static_cast<const float*>(a.x)
                    + (a.shared_x ? 0 : (size_t)e * a.M * a.kb);
  const float* wb = static_cast<const float*>(a.w) + (size_t)e * a.kb * a.N;

#pragma unroll
  for (int j = 0; j < kTN; ++j) acc[j] = 0.0f;

  for (int k0 = 0; k0 < a.K; k0 += kBKF) {
    // x tile: 16 rows x 32 codes, two per thread, a warp per 32-code row.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = t / kBKF + 8 * i, c = t % kBKF;
      const int m = m0 + r, k = k0 + c;
      sx[r][c] = (m < a.M && k < a.K) ? xb[(size_t)m * a.kb + k] : 0.0f;
    }
    // w tile: 32 rows x 64 columns, eight per thread, coalesced rows.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = t / kBN + 4 * i, c = t % kBN;
      const int k = k0 + r, n = n0 + c;
      sw[r][c] = (k < a.K && n < a.N) ? wb[(size_t)k * a.N + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBKF; ++kk) {
      const float av = sx[ty][kk];
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        acc[j] = __fmaf_rn(av, sw[kk][tx + 16 * j], acc[j]);
    }
    __syncthreads();
  }
}

template <int CODES>
__device__ __forceinline__ void integrate_tile(
    const TileArgs& a, int e, int m0, int n0,
    typename AccType<CODES>::T (&acc)[kTN]) {
  if constexpr (CODES == kF32)
    integrate_f32(a, e, m0, n0, acc);
  else
    integrate_int<CODES>(a, e, m0, n0, acc);
}

// The TileArgs of a launch: K is the code depth; int4 stores (K + 1) / 2
// packed bytes per row and walks the even-padded depth.
inline TileArgs tile_args(const void* x, const void* w, int M, int K, int N,
                          int shared_x, int vec_x, int vec_w, int codes) {
  const int kb = codes == kInt4 ? (K + 1) / 2 : K;
  const int depth = codes == kInt4 ? 2 * kb : K;
  return TileArgs{x, w, M, depth, N, kb, shared_x, vec_x, vec_w};
}

// ops._epilogue term for term, in float32 with no contraction:
//   z = f32(acc) * gain;  inv = 1 / s;  q = rint(clip(z * inv, -1, 1) * L)
//   y = (q * xs) * (ws * (s * (1 / L)))
// The clip is written with comparisons so a NaN z stays NaN, as XLA's
// min/max propagate it (fminf/fmaxf would not).
__device__ __forceinline__ float readout(float z, float s, float xs, float ws,
                                         float levels, float inv_levels) {
  const float inv = __fdiv_rn(1.0f, s);
  float c = __fmul_rn(z, inv);
  c = (c < -1.0f) ? -1.0f : ((c > 1.0f) ? 1.0f : c);
  const float q = rintf(__fmul_rn(c, levels));
  const float back = __fmul_rn(s, inv_levels);
  return __fmul_rn(__fmul_rn(q, xs), __fmul_rn(ws, back));
}

}  // namespace tdvmm
