// Kernel B4: the latch threshold-crossing solver (paper Eq. 4), by bisection.
//
// Replaces src/repro/kernels/crossing/crossing.py:27 (_kernel, launched by
// crossing_kernel).  For every batch row b and output column n it runs
// `iters` bisection steps on [t_lo, t_hi] of the monotone charge
//
//   Q(t) = sum_k I[k, n] * max(t - t_on[b, k], 0)
//
// against k_charge: mid = 0.5 (lo + hi); Q(mid) < k_charge moves lo, else
// hi; the result is 0.5 (lo + hi), written once.  A crossing beyond t_hi
// comes back as t_hi to within the last bracket, as from the TPU kernel.
// The brackets are the TPU kernel's; only the evaluation of Q differs.
//
// The identity (the paper's Eq. 1-5).  Let t_max[b] = max_k t_on[b, k].  For
// mid >= t_max[b] every mid - t_on[b, k] is >= 0, in float32 too (a rounded
// difference keeps its sign), so every max(., 0) is the identity and
//
//   Q(mid) = mid * S[n] - M[b, n],   S[n] = sum_k I[k, n],   M = t_on . I,
//
// M being the (B x K) . (K x N) product that the circuit itself computes.
// On the physics path every onset lies in [0, T] (value_to_onset clamps x to
// [0, 1]; the bias source sits at 0) and the first mid is t_hi / 2 = T, so
// every step of every crossing at or beyond T is linear: the 24 sums over K
// collapse into one product.  A step whose mid falls below its row's t_max
// (a crossing before the last onset) takes the general sum over K instead.
//
// Two device kernels, in order on the caller's stream:
//
//   prep   t_max[b] (an exact max) and S[n]: 8 slices of the sources
//          k = j mod 8 (one warp each, 32 columns a CTA) summed in order,
//          then the slices 0..7 in order.  No atomics: bitwise repeatable.
//   fused  one CTA per 64 x 128 tile of (rows, columns), 8 warps of 32 x 32.
//          It computes its tile of M on the tensor cores, mma.sync m16n8k8
//          TF32 -> float32, K in stages of 32 sources through a 3-stage
//          cp.async ring (80 KB of dynamic shared memory), and keeps M in
//          the accumulator registers: the (B, N) product never goes to
//          device memory.  Then the bisection runs on those registers.  A linear step is q = mid * S - M as a product
//          and a difference each rounded to float32 (__fmul_rn, __fsub_rn:
//          no FMA, so the CPU emulation repeats it exactly).  When any lane
//          of the CTA has mid < t_max (__syncthreads_or), the CTA walks K
//          over its tile as the earlier design did (onsets and currents in
//          shared memory, blocks of 32 sources, each block summed apart
//          with fmaf(c, max(mid - t, 0), p), then added to Q); the lanes
//          below t_max take that Q, the others keep their linear one.
//          iters = 0 writes 0.5 (t_lo + t_hi) without reading the operands.
//
// Precision.  The onsets and currents are not exact in TF32 (10 mantissa
// bits), so each is split as hi = tf32(v), lo = tf32(v - hi), rounded to
// nearest with ties away from zero (cvt.rna's rounding), and
// M summed as lo.hi + hi.lo + hi.hi per k8 block (3xTF32); the dropped
// lo.lo and the split's residual are ~2^-22 of each product, float32's
// order.  The tensor cores add into their accumulator without rounding to
// nearest (they truncate), which over the array's 257 k8 blocks x 3 MMAs
// put the times 3.55e-6 T from crossing_plain, over the gate (a first
// version, NVIDIA H100 80GB HBM3, 700 W); so each stage of 32 sources is
// summed on the tensor cores from zero and then added into M with one IEEE
// float32 add.  TF32 rounding is done in two integer operations, as
// cvt.rna rounds finite values: cvt.rna took four in the SASS, and with it
// and 16-source stages the array's launch took 1.398 ms in chip_smoke.py's
// B4 phase, against 0.896 ms for this version (same card and limit).
// tests/test_torch_crossing.py emulates this arithmetic: at the 1024 x 1024
// array's K 2049, 3xTF32 keeps the times within 8.9e-7 T of crossing_plain,
// one TF32 product misses the 2.5e-6 T gate by ~27x (6.7e-5 T).  A bf16
// split keeps only 16 bits and is worse still.
//
// Bound on the card: operations.  The product is 2 B K N flops, three times
// over in 3xTF32: at B 4096, K 2049, N 2048 that is 103 GFLOP, 0.208 ms at
// the H100 SXM's 495 TFLOP/s of TF32, against 84 MB of bytes (0.025 ms);
// the linear steps add a few operations per (b, n, step).  Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.896 ms, 4.3x that
// bound, at one CTA of 8 warps an SM (201 registers).  A general step
// costs what every step cost in the earlier design: a subtract, a max and
// an FMA (4 flops) per (b, n, k), which at the array's 24 steps was 1.65
// TFLOP, 24.6 ms at 67 TFLOP/s of float32 on CUDA cores (that kernel took
// 64.4 ms: three instructions a term from one warp scheduler per quarter
// SM).  The physics path takes no general step.
//
// No fast math: IEEE float32 adds, products and fmaxf.
#include <cstdint>
#include <cuda_runtime.h>

namespace crossing {

constexpr int kThreads = 256;          // 8 warps
constexpr int kBM = 64;                // rows of the CTA tile
constexpr int kBN = 128;               // columns of the CTA tile
constexpr int kWarpsN = 4;             // warps 2 (rows) x 4 (columns)
constexpr int kMT = 2;                 // m16 tiles of a warp: 32 rows
constexpr int kNT = 4;                 // n8 tiles of a warp: 32 columns
constexpr int kBK = 32;                // sources per cp.async stage
constexpr int kStages = 3;
// pitches chosen so that a warp's fragment loads hit 32 banks
constexpr int kPitchA = kBK + 4;       // onsets, [row][k]
constexpr int kPitchB = kBN + 8;       // currents, [k][col]
constexpr int kStageFloats = kBM * kPitchA + kBK * kPitchB;
// the general step's staging: onsets [row][k] and currents [k][col]
constexpr int kGK = 32;                // sources per general block
constexpr int kPitchG = kGK + 1;
constexpr int kSmemBytes = kStages * kStageFloats * 4;   // 79,872: dynamic
static_assert(kBM * kPitchG + kGK * kBN <= kStages * kStageFloats,
              "the general step's tiles reuse the product's ring");
static_assert(kThreads % kBK == 0 && kThreads % (kBN / 4) == 0 &&
                  kThreads % kBN == 0,
              "each thread copies the same columns of every stage");

constexpr int kPrepCols = 32;          // prep: columns of a CTA (one a lane)
constexpr int kPrepSlices = kThreads / 32;   // and source slices (one a warp)
constexpr int kPrepRows = kThreads / 32;     // or rows of a CTA (one a warp)

// ---------------------------------------------------------------------------
// prep: t_max and S
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
prep_kernel(const float* __restrict__ t_on, const float* __restrict__ cur,
            float* __restrict__ t_max, float* __restrict__ col_sum, int B,
            int K, int N, int col_blocks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (blockIdx.x < col_blocks) {
    __shared__ float part[kPrepSlices][kPrepCols];
    const int c = blockIdx.x * kPrepCols + lane;
    float s = 0.f;
    if (c < N)
      for (int k = warp; k < K; k += kPrepSlices)
        s += cur[(long long)k * N + c];
    part[warp][lane] = s;
    __syncthreads();
    if (warp == 0 && c < N) {
      float v = part[0][lane];
#pragma unroll
      for (int j = 1; j < kPrepSlices; ++j) v += part[j][lane];
      col_sum[c] = v;
    }
  } else {
    const int r = (blockIdx.x - col_blocks) * kPrepRows + warp;
    if (r >= B) return;
    float m = __int_as_float(0xff800000);   // -inf
    for (int k = lane; k < K; k += 32)
      m = fmaxf(m, t_on[(long long)r * K + k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) t_max[r] = m;
  }
}

// ---------------------------------------------------------------------------
// copies and tensor-core products
// ---------------------------------------------------------------------------
// 4 or 16 bytes from src to shared dst; bytes = 0 fills zeros and reads
// nothing (src must still be a valid address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Fragments (g = lane / 4, t = lane % 4): A (16 x 8) a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); B (8 x 8) b0 (k t, n g), b1 (k t+4, n g);
// C (16 x 8) c0, c1 (g, 2t, 2t+1), c2, c3 (g+8, 2t, 2t+1).
// v rounded to TF32 as cvt.rna.tf32.f32 rounds a finite v (to nearest, ties
// away from zero), in two integer operations: without cvt's guard for inf
// and NaN, which no onset or current is
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// stage `s` <- onsets rows [row0, row0 + 64) x sources [k0, k0 + 32) and
// currents sources [k0, k0 + 32) x columns [col0, col0 + 128); zeros
// outside B x K and K x N.  Thread x copies the same source column of the
// onsets and the same columns of the currents at every stage.  vec:
// currents' rows are 16-byte aligned and N is a multiple of 4, so a
// 4-column chunk is wholly inside or outside N.
__device__ __forceinline__ void load_stage(float* stage,
                                           const float* __restrict__ t_on,
                                           const float* __restrict__ cur,
                                           int B, int K, int N, int row0,
                                           int col0, int k0, bool vec) {
  float* a = stage;
  float* b = stage + kBM * kPitchA;
  {
    constexpr int kRows = kThreads / kBK;   // rows a pass covers
    const int r0 = threadIdx.x / kBK, k = threadIdx.x % kBK, gk = k0 + k;
#pragma unroll
    for (int i = 0; i < kBM / kRows; ++i) {
      const int r = r0 + i * kRows, gr = row0 + r;
      const bool in = gr < B && gk < K;
      cp_async4(a + r * kPitchA + k,
                in ? t_on + (long long)gr * K + gk : t_on, in ? 4 : 0);
    }
  }
  if (vec) {
    constexpr int kRows = kThreads / (kBN / 4);
    const int k0t = threadIdx.x / (kBN / 4), c = threadIdx.x % (kBN / 4) * 4;
    const int gc = col0 + c;
#pragma unroll
    for (int i = 0; i < kBK / kRows; ++i) {
      const int k = k0t + i * kRows, gk = k0 + k;
      const bool in = gk < K && gc < N;
      cp_async16(b + k * kPitchB + c,
                 in ? cur + (long long)gk * N + gc : cur, in ? 16 : 0);
    }
  } else {
    constexpr int kRows = kThreads / kBN;
    const int k0t = threadIdx.x / kBN, c = threadIdx.x % kBN;
    const int gc = col0 + c;
#pragma unroll
    for (int i = 0; i < kBK / kRows; ++i) {
      const int k = k0t + i * kRows, gk = k0 + k;
      const bool in = gk < K && gc < N;
      cp_async4(b + k * kPitchB + c,
                in ? cur + (long long)gk * N + gc : cur, in ? 4 : 0);
    }
  }
}

// ---------------------------------------------------------------------------
// fused: the tile of M on the tensor cores, then the bisection on it
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
fused_kernel(const float* __restrict__ t_on, const float* __restrict__ cur,
             const float* __restrict__ t_max, const float* __restrict__ col_sum,
             float* __restrict__ out, int B, int K, int N, float k_charge,
             float t_lo, float t_hi, int iters, int vec) {
  extern __shared__ __align__(16) float smem[];   // kSmemBytes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  // the warp's 32 x 32 corner of the tile
  const int wr = (warp / kWarpsN) * (kMT * 16);
  const int wc = (warp % kWarpsN) * (kNT * 8);

  // element (i, j, r) of this thread: row wr + 16 i + g + 8 (r >> 1) and
  // column wc + 8 j + 2 t + (r & 1) of the tile, as in the C fragment
  auto row_of = [&](int i, int r) { return wr + 16 * i + g + 8 * (r >> 1); };
  auto col_of = [&](int j, int r) { return wc + 8 * j + 2 * t + (r & 1); };
  auto write = [&](int i, int j, int r, float v) {
    const int gr = row0 + row_of(i, r), gc = col0 + col_of(j, r);
    if (gr < B && gc < N) out[(long long)gr * N + gc] = v;
  };

  if (iters == 0) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) write(i, j, r, 0.5f * (t_lo + t_hi));
    return;
  }

  // ---- M: the tile's product, 3xTF32, K through the cp.async ring ----
  float m[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) m[i][j][r] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage(smem + s * kStageFloats, t_on, cur, B, K, N, row0, col0,
                 s * kBK, vec);
    cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage kb landed; stage kb - 1's reads are done
    const int next = kb + kStages - 1;
    if (next < nk)
      load_stage(smem + (next % kStages) * kStageFloats, t_on, cur, B, K, N,
                 row0, col0, next * kBK, vec);
    cp_async_commit();
    const float* a = smem + (kb % kStages) * kStageFloats;
    const float* b = a + kBM * kPitchA;
    // the stage's sum on the tensor cores, then one IEEE add into M
    float part[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split(a[(wr + 16 * i + g + 8 * (r & 1)) * kPitchA + kk + t +
                  4 * (r >> 1)],
                ah[i][r], al[i][r]);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          split(b[(kk + t + 4 * r) * kPitchB + wc + 8 * j + g], bh[j][r],
                bl[j][r]);
      // the small terms first: lo.hi, hi.lo, then hi.hi
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          mma_tf32(part[i][j], al[i], bh[j][0], bh[j][1]);
          mma_tf32(part[i][j], ah[i], bl[j][0], bl[j][1]);
          mma_tf32(part[i][j], ah[i], bh[j][0], bh[j][1]);
        }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) m[i][j][r] += part[i][j][r];
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free for the general step

  // ---- the bisection on the accumulators ----
  // rows and columns outside B x N: t_max -inf keeps them linear
  float tm[kMT][2], cs[kNT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + row_of(i, 2 * h);
      tm[i][h] = gr < B ? t_max[gr] : __int_as_float(0xff800000);
    }
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = col0 + col_of(j, h);
      cs[j][h] = gc < N ? col_sum[gc] : 0.f;
    }
  float lo[kMT][kNT][4], hi[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        lo[i][j][r] = t_lo;
        hi[i][j][r] = t_hi;
      }

  float* ts = smem;                    // general step: onsets [row][k]
  float* cg = smem + kBM * kPitchG;    // and currents [k][col]
  for (int it = 0; it < iters; ++it) {
    bool below = false;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          below |= 0.5f * (lo[i][j][r] + hi[i][j][r]) < tm[i][r >> 1];
    const bool general = __syncthreads_or(below);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      // the general Q of this m16 tile's 16 elements (when the CTA needs it)
      float q[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) q[j][r] = 0.f;
      if (general) {
        for (int k0 = 0; k0 < K; k0 += kGK) {
          __syncthreads();   // the previous block's reads are done
          for (int e = threadIdx.x; e < kBM * kGK; e += kThreads) {
            const int r = e / kGK, k = e % kGK;
            const int gr = row0 + r, gk = k0 + k;
            ts[r * kPitchG + k] =
                (gr < B && gk < K) ? t_on[(long long)gr * K + gk] : 0.f;
          }
          for (int e = threadIdx.x; e < kGK * kBN; e += kThreads) {
            const int k = e / kBN, c = e % kBN;
            const int gk = k0 + k, gc = col0 + c;
            cg[k * kBN + c] =
                (gk < K && gc < N) ? cur[(long long)gk * N + gc] : 0.f;
          }
          __syncthreads();
          float p[kNT][4];
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) p[j][r] = 0.f;
#pragma unroll 4
          for (int kk = 0; kk < kGK; ++kk) {
            const float t0 = ts[(wr + 16 * i + g) * kPitchG + kk];
            const float t1 = ts[(wr + 16 * i + g + 8) * kPitchG + kk];
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              const float2 c = *reinterpret_cast<const float2*>(
                  &cg[kk * kBN + wc + 8 * j + 2 * t]);
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                const float mid = 0.5f * (lo[i][j][r] + hi[i][j][r]);
                p[j][r] = fmaf((r & 1) ? c.y : c.x,
                               fmaxf(mid - ((r >> 1) ? t1 : t0), 0.f),
                               p[j][r]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) q[j][r] += p[j][r];
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float mid = 0.5f * (lo[i][j][r] + hi[i][j][r]);
          const float lin =
              __fsub_rn(__fmul_rn(mid, cs[j][r & 1]), m[i][j][r]);
          const float qq = mid >= tm[i][r >> 1] ? lin : q[j][r];
          const bool too_low = qq < k_charge;
          lo[i][j][r] = too_low ? mid : lo[i][j][r];
          hi[i][j][r] = too_low ? hi[i][j][r] : mid;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        write(i, j, r, 0.5f * (lo[i][j][r] + hi[i][j][r]));
}

}  // namespace crossing

// t_on (B, K), currents (K, N) and out (B, N): contiguous float32; scratch:
// B + N floats for t_max and S.  Returns the first launch's
// cudaGetLastError code that is not 0, else 0.
extern "C" int crossing_b4(const float* t_on, const float* cur, float* scratch,
                           float* out, int B, int K, int N, float k_charge,
                           float t_lo, float t_hi, int iters,
                           cudaStream_t stream) {
  using namespace crossing;
  float* t_max = scratch;
  float* col_sum = scratch + B;
  if (iters > 0) {
    const int col_blocks = (N + kPrepCols - 1) / kPrepCols;
    const int row_blocks = (B + kPrepRows - 1) / kPrepRows;
    prep_kernel<<<col_blocks + row_blocks, kThreads, 0, stream>>>(
        t_on, cur, t_max, col_sum, B, K, N, col_blocks);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  static const int smem_err = (int)cudaFuncSetAttribute(
      fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (smem_err != 0) return smem_err;
  const int vec = reinterpret_cast<uintptr_t>(cur) % 16 == 0 && N % 4 == 0;
  dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  fused_kernel<<<grid, kThreads, kSmemBytes, stream>>>(t_on, cur, t_max, col_sum, out,
                                              B, K, N, k_charge, t_lo, t_hi,
                                              iters, vec);
  return (int)cudaGetLastError();
}
