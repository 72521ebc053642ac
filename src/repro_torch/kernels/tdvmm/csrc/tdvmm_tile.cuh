// Shared int8 charge-accumulation tile for the TD-VMM kernels (B1 and B2).
//
// One CTA of 256 threads owns a (16 x 64) output tile of one batch entry e
// and walks the whole K axis itself: the loop over K inside the block takes
// the place of the sequential K grid axis of the Pallas kernel
// (repro/kernels/tdvmm/tdvmm.py:_kernel), whose accumulator lived in VMEM
// scratch.  Here it lives in registers: thread (tx, ty) accumulates the 4
// outputs at row ty and columns tx + 16 j.
//
// Each K step stages a (16 x 64)-byte x tile and a (64 x 64)-byte w tile in
// shared memory, both packed as int32 words of four consecutive k codes, so
// the inner product is __dp4a (s8 x s8 -> s32, exact).  w arrives N-major
// (E, K, N); four rows of four columns are transposed in registers with
// __byte_perm on the way into shared memory.  Ragged M, K and N edges are
// zero-filled: a zero code is an inert current source, so padding is exact.
//
// What bounds it: at the serving shapes (M = 4 .. 128 rows against
// 1024 x 2816 weights) the weight codes dominate the bytes and the kernel
// is bound by device-memory bytes, not operations; the design keeps every
// code byte read from device memory once per CTA row-tile and the int32
// accumulator and epilogue on chip, so each output is written once.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tdvmm {

constexpr int kThreads = 256;
constexpr int kBM = 16;          // output rows per CTA
constexpr int kBN = 64;          // output columns per CTA
constexpr int kBK = 64;          // k codes per shared-memory stage
constexpr int kBKW = kBK / 4;    // ... as packed int32 words
constexpr int kTN = kBN / 16;    // columns per thread

struct TileArgs {
  const int8_t* x;   // (E|1, M, K) row-major
  const int8_t* w;   // (E, K, N) row-major
  int M, K, N;
  int shared_x;      // x has one batch entry shared by every e
  int vec_x;         // K % 4 == 0 and x 4-byte aligned: word loads
  int vec_w;         // N % 4 == 0 and w 4-byte aligned: word loads
};

__device__ __forceinline__ int load_x_word(const TileArgs& a, const int8_t* xb,
                                           int m, int k) {
  if (m >= a.M || k >= a.K) return 0;
  const int8_t* p = xb + (size_t)m * a.K + k;
  if (a.vec_x) return *reinterpret_cast<const int*>(p);
  uint32_t v = 0;
  for (int b = 0; b < 4; ++b) {
    uint32_t byte = (k + b < a.K) ? (uint32_t)(uint8_t)p[b] : 0u;
    v |= byte << (8 * b);
  }
  return (int)v;
}

__device__ __forceinline__ uint32_t load_w_row4(const TileArgs& a,
                                                const int8_t* wb, int k,
                                                int n) {
  // Four consecutive columns n..n+3 of row k, column n in the low byte.
  if (k >= a.K || n >= a.N) return 0u;
  const int8_t* p = wb + (size_t)k * a.N + n;
  if (a.vec_w) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0;
  for (int b = 0; b < 4; ++b) {
    uint32_t byte = (n + b < a.N) ? (uint32_t)(uint8_t)p[b] : 0u;
    v |= byte << (8 * b);
  }
  return v;
}

// Accumulate the CTA's tile over the whole K axis into acc[kTN].
__device__ __forceinline__ void integrate_tile(const TileArgs& a, int e,
                                               int m0, int n0,
                                               int (&acc)[kTN]) {
  __shared__ int sx[kBM][kBKW + 1];
  __shared__ int sw[kBN][kBKW + 1];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int8_t* xb = a.x + (a.shared_x ? 0 : (size_t)e * a.M * a.K);
  const int8_t* wb = a.w + (size_t)e * a.K * a.N;

#pragma unroll
  for (int j = 0; j < kTN; ++j) acc[j] = 0;

  for (int k0 = 0; k0 < a.K; k0 += kBK) {
    // x tile: 16 rows x 16 words, one word per thread.
    sx[ty][tx] = load_x_word(a, xb, m0 + ty, k0 + 4 * tx);
    // w tile: thread (kw, nq) loads rows 4kw..4kw+3 of columns 4nq..4nq+3
    // and transposes the 4x4 bytes into one k-packed word per column.
    {
      const int nq = t % 16, kw = t / 16;
      const int k = k0 + 4 * kw, n = n0 + 4 * nq;
      const uint32_t r0 = load_w_row4(a, wb, k + 0, n);
      const uint32_t r1 = load_w_row4(a, wb, k + 1, n);
      const uint32_t r2 = load_w_row4(a, wb, k + 2, n);
      const uint32_t r3 = load_w_row4(a, wb, k + 3, n);
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
