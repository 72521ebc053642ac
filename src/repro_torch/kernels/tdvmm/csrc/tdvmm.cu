// Kernel B1: TD-VMM charge accumulation with the fused readout epilogue.
//
// Replaces repro/kernels/tdvmm/tdvmm.py:_kernel (launched by _grid_call as
// tdvmm_matmul_kernel, raw mode, and tdvmm_fused_kernel).  One CTA per
// (e, m-tile, n-tile); the K walk runs inside the block (tdvmm_tile.cuh) and
// the finished int32 tile goes through the epilogue in registers, so every
// output element is written to device memory exactly once:
//
//   mode 0  raw        out = acc (int32, or float32 for f32 codes)
//   mode 1  fused      out f32   = (f32(acc) * gain * xs) * ws
//   mode 2  readout    out f32   = the p-bit readout over a window s that is
//                      per column of an (E, 1, N) operand given by strides
//                      (scalar: 0, 0; per-expert: 1, 0; per-column: N, 1)
//
// in each of the three code storages of tdvmm_tile.cuh: int8, int4-packed
// pairs and float32 codes (the Pallas kernel's unpack4 and float-acc modes).
// Batched E maps onto gridDim.z: the MoE expert grid, (E, C, K) x (E, K, N)
// with (E,) windows, is mode 2 with per-expert strides; shared-x (one x
// batch entry against E weight tiles) reads batch 0 of x and x_scale for
// every e.
//
// Bound on the card: bytes at the decode shapes, where the weight codes
// (K x N per tile; half that for int4, four times for f32) dominate and
// 2 M K N operations sit far below the tensor-core rate; operations (on CUDA
// cores: __dp4a, or float32 FMAs) at the prefill shapes of thousands of
// rows.  The design reads each code once per row tile and never round-trips
// the accumulator or the epilogue through device memory.  __dp4a and FMAs on
// CUDA cores, not wgmma, are the simple first version.
#include "tdvmm_tile.cuh"

namespace tdvmm {

template <int MODE, int CODES>
__global__ void __launch_bounds__(kThreads)
b1_kernel(TileArgs a, const float* __restrict__ xs,
          const float* __restrict__ ws, const float* __restrict__ win,
          long long win_se, long long win_sn, void* __restrict__ out,
          float gain, float levels, float inv_levels) {
  using Acc = typename AccType<CODES>::T;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  Acc acc[kTN];
  integrate_tile<CODES>(a, e, m0, n0, acc);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m = m0 + ty;
  if (m >= a.M) return;
  const size_t row = ((size_t)e * a.M + m) * a.N;
  float xsv = 0.0f;
  if (MODE != 0) xsv = xs[(size_t)(a.shared_x ? 0 : e) * a.M + m];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= a.N) continue;
    if (MODE == 0) {
      static_cast<Acc*>(out)[row + n] = acc[j];
      continue;
    }
    const float z = __fmul_rn((float)acc[j], gain);
    const float wsv = ws[(size_t)e * a.N + n];
    float y;
    if (MODE == 2) {
      const float s = win[e * win_se + n * win_sn];
      y = readout(z, s, xsv, wsv, levels, inv_levels);
    } else {
      y = __fmul_rn(__fmul_rn(z, xsv), wsv);
    }
    static_cast<float*>(out)[row + n] = y;
  }
}

template <int MODE, int CODES>
static void launch(const TileArgs& a, int E, const float* xs, const float* ws,
                   const float* win, long long win_se, long long win_sn,
                   void* out, float gain, float levels, float inv_levels,
                   cudaStream_t stream) {
  dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM, E);
  b1_kernel<MODE, CODES><<<grid, kThreads, 0, stream>>>(
      a, xs, ws, win, win_se, win_sn, out, gain, levels, inv_levels);
}

template <int CODES>
static void launch_mode(int mode, const TileArgs& a, int E, const float* xs,
                        const float* ws, const float* win, long long win_se,
                        long long win_sn, void* out, float gain, float levels,
                        float inv_levels, cudaStream_t s) {
  if (mode == 0)
    launch<0, CODES>(a, E, xs, ws, win, win_se, win_sn, out, gain, levels,
                     inv_levels, s);
  else if (mode == 1)
    launch<1, CODES>(a, E, xs, ws, win, win_se, win_sn, out, gain, levels,
                     inv_levels, s);
  else
    launch<2, CODES>(a, E, xs, ws, win, win_se, win_sn, out, gain, levels,
                     inv_levels, s);
}

}  // namespace tdvmm

// Plain C entry point (bound with ctypes).  ``codes``: 0 int8, 1 int4 pairs,
// 2 float32; K is the code depth (int4 rows hold (K + 1) / 2 bytes).
// Returns the cudaError_t of the launch; the caller raises on a non-zero
// value.
extern "C" int tdvmm_b1(const void* x, const void* w, const void* xs,
                        const void* ws, const void* win, long long win_se,
                        long long win_sn, void* out, int E, int M, int K,
                        int N, int shared_x, int vec_x, int vec_w, int mode,
                        int codes, float gain, float levels, float inv_levels,
                        void* stream) {
  using namespace tdvmm;
  if (mode < 0 || mode > 2 || codes < 0 || codes > 2)
    return (int)cudaErrorInvalidValue;
  const TileArgs a = tile_args(x, w, M, K, N, shared_x, vec_x, vec_w, codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fxs = static_cast<const float*>(xs);
  const float* fws = static_cast<const float*>(ws);
  const float* fwin = static_cast<const float*>(win);
  if (codes == kInt8)
    launch_mode<kInt8>(mode, a, E, fxs, fws, fwin, win_se, win_sn, out, gain,
                       levels, inv_levels, s);
  else if (codes == kInt4)
    launch_mode<kInt4>(mode, a, E, fxs, fws, fwin, win_se, win_sn, out, gain,
                       levels, inv_levels, s);
  else
    launch_mode<kF32>(mode, a, E, fxs, fws, fwin, win_se, win_sn, out, gain,
                      levels, inv_levels, s);
  return (int)cudaGetLastError();
}
