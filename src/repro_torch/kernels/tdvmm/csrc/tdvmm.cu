// Kernel B1: TD-VMM charge accumulation with the fused readout epilogue.
//
// Replaces repro/kernels/tdvmm/tdvmm.py:_kernel (launched by _grid_call as
// tdvmm_matmul_kernel, raw mode, and tdvmm_fused_kernel).  One CTA per
// (e, m-tile, n-tile); the K walk runs inside the block on the tensor cores
// (tdvmm_tile.cuh: mma.sync s8 for int8 codes and int4 pairs, bf16 with a
// float32 accumulator for integer float32 codes up to |256|, 3xTF32 for
// float32 codes off the integer grid or up to |2047|), and the finished
// tile goes
// through the epilogue straight from the accumulator fragments, so every
// output element is written to device memory exactly once:
//
//   mode 0  raw        out = acc (int32, or float32 for f32 codes)
//   mode 1  fused      out f32   = (f32(acc) * gain * xs) * ws
//   mode 2  readout    out f32   = the p-bit readout over a window s that is
//                      per column of an (E, 1, N) operand given by strides
//                      (scalar: 0, 0; per-expert: 1, 0; per-column: N, 1)
//
// Batched E maps onto gridDim.z: the MoE expert grid, (E, C, K) x (E, K, N)
// with (E,) windows, is mode 2 with per-expert strides; shared-x (one x
// batch entry against E weight tiles) reads batch 0 of x and x_scale for
// every e.  The tile (16 or 128 rows) is the caller's choice
// (tdvmm.plan_tile).  The readout needs no extra pass: each thread maps its
// accumulator fragments to (m, n) (FragCoords) and writes them once.
//
// Bound on the card: bytes at the decode shapes, where the weight codes
// (K x N per tile; half that for int4, four times for f32) dominate and
// 2 M K N operations sit far below the tensor-core rate; at the prefill
// shapes of thousands of rows, the staging of codes through shared memory
// (tdvmm_tile.cuh), still well below the tensor-core rate.  The design
// streams each code once per row tile through a cp.async ring, keeps the
// accumulator in MMA fragments and never round-trips it or the epilogue
// through device memory.
#include "tdvmm_tile.cuh"

namespace tdvmm {

template <int MODE, int CODES, int TILE>
__global__ void __launch_bounds__(Geometry<TILE, CODES>::THREADS)
b1_kernel(TileArgs a, const float* __restrict__ xs,
          const float* __restrict__ ws, const float* __restrict__ win,
          long long win_se, long long win_sn, void* __restrict__ out,
          float gain, float levels, float inv_levels) {
  using G = Geometry<TILE, CODES>;
  using Acc = typename AccType<CODES>::T;
  extern __shared__ __align__(16) char smem[];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * G::BM;
  const int n0 = blockIdx.x * G::BN;
  Acc acc[G::MT][G::NT][4];
  integrate_tile<TILE, CODES>(a, e, m0, n0, smem, acc);

  const FragCoords<TILE> f;
  const int xe = a.shared_x ? 0 : e;
#pragma unroll
  for (int i = 0; i < G::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {                 // rows g and g + 8
      const int m = m0 + f.row(i, 2 * h);
      if (m >= a.M) continue;
      const size_t row = ((size_t)e * a.M + m) * a.N;
      const float xsv = MODE != 0 ? xs[(size_t)xe * a.M + m] : 0.0f;
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + f.col(j, c);
          if (n >= a.N) continue;
          const Acc v = acc[i][j][2 * h + c];
          if (MODE == 0) {
            static_cast<Acc*>(out)[row + n] = v;
            continue;
          }
          const float z = __fmul_rn((float)v, gain);
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
    }
  }
}

template <int MODE, int CODES, int TILE>
static int launch(const TileArgs& a, int E, const float* xs, const float* ws,
                  const float* win, long long win_se, long long win_sn,
                  void* out, float gain, float levels, float inv_levels,
                  cudaStream_t stream) {
  using G = Geometry<TILE, CODES>;
  constexpr auto kernel = b1_kernel<MODE, CODES, TILE>;
  const cudaError_t err = allow_smem<kernel>(G::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.N + G::BN - 1) / G::BN, (a.M + G::BM - 1) / G::BM, E);
  kernel<<<grid, G::THREADS, G::SMEM, stream>>>(
      a, xs, ws, win, win_se, win_sn, out, gain, levels, inv_levels);
  return (int)cudaGetLastError();
}

template <int MODE, int CODES>
static int launch_tile(int tile, const TileArgs& a, int E, const float* xs,
                       const float* ws, const float* win, long long win_se,
                       long long win_sn, void* out, float gain, float levels,
                       float inv_levels, cudaStream_t s) {
  if (tile == kSmall)
    return launch<MODE, CODES, kSmall>(a, E, xs, ws, win, win_se, win_sn,
                                       out, gain, levels, inv_levels, s);
  return launch<MODE, CODES, kLarge>(a, E, xs, ws, win, win_se, win_sn, out,
                                     gain, levels, inv_levels, s);
}

template <int CODES>
static int launch_mode(int mode, int tile, const TileArgs& a, int E,
                       const float* xs, const float* ws, const float* win,
                       long long win_se, long long win_sn, void* out,
                       float gain, float levels, float inv_levels,
                       cudaStream_t s) {
  if (mode == 0)
    return launch_tile<0, CODES>(tile, a, E, xs, ws, win, win_se, win_sn, out,
                                 gain, levels, inv_levels, s);
  if (mode == 1)
    return launch_tile<1, CODES>(tile, a, E, xs, ws, win, win_se, win_sn, out,
                                 gain, levels, inv_levels, s);
  return launch_tile<2, CODES>(tile, a, E, xs, ws, win, win_se, win_sn, out,
                               gain, levels, inv_levels, s);
}

}  // namespace tdvmm

// Plain C entry points (bound with ctypes).  ``codes``: 0 int8, 1 int4
// pairs, 2 float32 (bf16 tile), 3 float32 (3xTF32); ``tile``: 0 small (16 rows), 1 large (128); K is the
// code depth (int4 rows hold (K + 1) / 2 bytes).  Returns
// the cudaError_t of the launch; the caller raises on a non-zero value.
extern "C" int tdvmm_b1(const void* x, const void* w, const void* xs,
                        const void* ws, const void* win, long long win_se,
                        long long win_sn, void* out, int E, int M, int K,
                        int N, int shared_x, int vec_x, int vec_w, int mode,
                        int codes, int tile, float gain, float levels,
                        float inv_levels, void* stream) {
  using namespace tdvmm;
  if (mode < 0 || mode > 2 || codes < 0 || codes > 3 || tile < 0 || tile > 1)
    return (int)cudaErrorInvalidValue;
  const TileArgs a = tile_args(x, w, M, K, N, shared_x, vec_x, vec_w, codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fxs = static_cast<const float*>(xs);
  const float* fws = static_cast<const float*>(ws);
  const float* fwin = static_cast<const float*>(win);
  if (codes == kInt8)
    return launch_mode<kInt8>(mode, tile, a, E, fxs, fws, fwin, win_se,
                              win_sn, out, gain, levels, inv_levels, s);
  if (codes == kInt4)
    return launch_mode<kInt4>(mode, tile, a, E, fxs, fws, fwin, win_se,
                              win_sn, out, gain, levels, inv_levels, s);
  if (codes == kF32)
    return launch_mode<kF32>(mode, tile, a, E, fxs, fws, fwin, win_se,
                             win_sn, out, gain, levels, inv_levels, s);
  return launch_mode<kF32x3>(mode, tile, a, E, fxs, fws, fwin, win_se, win_sn,
                             out, gain, levels, inv_levels, s);
}

// Dynamic shared memory of one CTA, in bytes, for a tile and code storage
// (-1 for an unknown pair): what ``-Xptxas -v`` cannot report.
extern "C" int tdvmm_smem_bytes(int tile, int codes) {
  using namespace tdvmm;
  if (tile < 0 || tile > 1 || codes < 0 || codes > 3) return -1;
  switch (tile * 4 + codes) {
    case kSmall * 4 + kInt8: return Geometry<kSmall, kInt8>::SMEM;
    case kSmall * 4 + kInt4: return Geometry<kSmall, kInt4>::SMEM;
    case kSmall * 4 + kF32: return Geometry<kSmall, kF32>::SMEM;
    case kSmall * 4 + kF32x3: return Geometry<kSmall, kF32x3>::SMEM;
    case kLarge * 4 + kInt8: return Geometry<kLarge, kInt8>::SMEM;
    case kLarge * 4 + kInt4: return Geometry<kLarge, kInt4>::SMEM;
    case kLarge * 4 + kF32: return Geometry<kLarge, kF32>::SMEM;
    case kLarge * 4 + kF32x3: return Geometry<kLarge, kF32x3>::SMEM;
    default: return -1;
  }
}
