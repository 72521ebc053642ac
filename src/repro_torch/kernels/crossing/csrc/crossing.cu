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
//
// The TPU kernel kept a whole (K, 128) current tile in VMEM for all
// iterations; at the physics path's K = 2049 that is 1 MB, and a Hopper
// block has 227 KB.  Here a CTA owns a 64 x 64 tile of (rows, columns) and
// each of its 256 threads a 4 x 4 block of it, with lo, hi, mid and the
// running Q in registers.  Every iteration walks K in blocks of 32 staged
// through shared memory: the currents (32 x 64) serve every row of the
// tile, the onsets (64 x 32) every column.  The currents (16 MB at the
// array's launch) stay in the 50 MB L2 across iterations, so device memory
// is read about once.  Each 32-source block is summed apart and then added
// to Q, which keeps the float32 rounding of Q near that of a pairwise sum.
//
// Bound on the card: operations.  Each (b, n, k, iteration) costs a
// subtract, a max and an FMA, counted as 4 flops: at B 4096, K 2049, N 2048
// and 24 iterations that is 1.65 TFLOP, 24.6 ms at the H100 SXM's 67 TFLOP/s
// of float32 on CUDA cores, against 84 MB of bytes (0.025 ms).  This first
// version issues three instructions per term from one warp scheduler per
// quarter SM; fewer instructions per term is the next step.
//
// No fast math: IEEE float32 adds and fmaxf, as in the plain version.
#include <cuda_runtime.h>

namespace crossing {

constexpr int kBM = 64;            // rows of the CTA tile
constexpr int kBN = 64;            // columns of the CTA tile
constexpr int kBK = 32;            // sources per staged block
constexpr int kTM = 4;             // rows per thread
constexpr int kTN = 4;             // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256
// onset rows padded to 68 floats: float4 reads stay aligned, and the
// transposing store of one row's 32 sources meets 4-way bank conflicts
constexpr int kPadM = kBM + 4;

__global__ void __launch_bounds__(kThreads)
crossing_kernel(const float* __restrict__ t_on, const float* __restrict__ cur,
                float* __restrict__ out, int B, int K, int N, float k_charge,
                float t_lo, float t_hi, int iters) {
  __shared__ __align__(16) float ts[kBK][kPadM];   // onsets, ts[k][row]
  __shared__ __align__(16) float cs[kBK][kBN];     // currents, cs[k][col]
  const int tx = threadIdx.x % (kBN / kTN);
  const int ty = threadIdx.x / (kBN / kTN);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float lo[kTM][kTN], hi[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      lo[i][j] = t_lo;
      hi[i][j] = t_hi;
    }

  for (int it = 0; it < iters; ++it) {
    float mid[kTM][kTN], q[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        mid[i][j] = 0.5f * (lo[i][j] + hi[i][j]);
        q[i][j] = 0.f;
      }
    for (int k0 = 0; k0 < K; k0 += kBK) {
      __syncthreads();   // the previous block's reads are done
      // a warp reads 32 consecutive sources of one row; outside B x K the
      // onset is 0 and outside K x N the current is 0 (adds nothing)
      for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK, k = e % kBK;
        const int gr = row0 + r, gk = k0 + k;
        ts[k][r] = (gr < B && gk < K) ? t_on[(long long)gr * K + gk] : 0.f;
      }
      for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
        const int k = e / kBN, c = e % kBN;
        const int gk = k0 + k, gc = col0 + c;
        cs[k][c] = (gk < K && gc < N) ? cur[(long long)gk * N + gc] : 0.f;
      }
      __syncthreads();
      float p[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) p[i][j] = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 tv = *reinterpret_cast<const float4*>(&ts[kk][ty * kTM]);
        const float4 cv = *reinterpret_cast<const float4*>(&cs[kk][tx * kTN]);
        const float t[kTM] = {tv.x, tv.y, tv.z, tv.w};
        const float c[kTN] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            p[i][j] = fmaf(c[j], fmaxf(mid[i][j] - t[i], 0.f), p[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) q[i][j] += p[i][j];
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const bool too_low = q[i][j] < k_charge;
        lo[i][j] = too_low ? mid[i][j] : lo[i][j];
        hi[i][j] = too_low ? hi[i][j] : mid[i][j];
      }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty * kTM + i;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx * kTN + j;
      if (c < N) out[(long long)r * N + c] = 0.5f * (lo[i][j] + hi[i][j]);
    }
  }
}

}  // namespace crossing

// t_on (B, K), currents (K, N) and out (B, N): contiguous float32.  Returns
// the launch's cudaGetLastError code.
extern "C" int crossing_b4(const float* t_on, const float* cur, float* out,
                           int B, int K, int N, float k_charge, float t_lo,
                           float t_hi, int iters, cudaStream_t stream) {
  using namespace crossing;
  dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM);
  crossing_kernel<<<grid, kThreads, 0, stream>>>(t_on, cur, out, B, K, N,
                                                 k_charge, t_lo, t_hi, iters);
  return (int)cudaGetLastError();
}
