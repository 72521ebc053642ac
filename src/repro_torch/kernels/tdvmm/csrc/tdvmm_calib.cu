// Kernel B2: TD-VMM integrate + *data-calibrated* readout, one HBM output.
//
// Replaces repro/kernels/tdvmm/tdvmm.py:_calib_kernel (tdvmm_calibrated_
// kernel).  The readout window of a slot (an expert tile, or a ragged group
// member's column span) is max|z| over the whole slot, which no single tile
// sees.  The Pallas kernel walked its grid twice in one launch; a GPU grid
// has no barrier across CTAs, so this is two launches over ONE (E, M, N)
// float32 buffer:
//
//   (i)  b2_integrate: the shared tensor-core tile walk (tdvmm_tile.cuh:
//        mma.sync s8 for int8 codes and int4 pairs, bf16 with a float32
//        accumulator for integer float32 codes up to |256|, 3xTF32 for
//        float32 codes off the integer grid or up to |2047|); each CTA
//        parks its raw
//        accumulators in the float32 output (an int32 accumulator as its
//        bit pattern, as the Pallas kernel parks it; a float32 one, from
//        f32 codes, as it is).  It folds max |f32(acc) * gain| over each
//        64-column slot block of its tile (one block for the 64-column
//        small tile, two for the 128-column large one) and adds each block's max to
//        its slot with one atomicMax on the int bit pattern, which orders
//        like the value for non-negative floats.  A float max is exact and
//        order-free, so the slot window is bitwise the unfused global max.
//        One slot per expert for the MoE expert grid.
//   (ii) b2_readout: in place, every element re-reads its parked accumulator
//        and applies the epilogue with s = max(slot_max, 1e-9).
//
// Bound on the card: as B1 (bytes at decode, staging through shared memory
// at thousands of rows), plus one extra read and write of the (M, N) float32
// buffer for the second pass; the epilogue chain never exists as full-size
// intermediates.
#include "tdvmm_tile.cuh"

namespace tdvmm {

template <int CODES, int TILE>
__global__ void __launch_bounds__(Geometry<TILE, CODES>::THREADS)
b2_integrate(TileArgs a, const int* __restrict__ slots, int nsb, int slot_bw,
             float* __restrict__ slot_max, void* __restrict__ out,
             float gain) {
  using G = Geometry<TILE, CODES>;
  using Acc = typename AccType<CODES>::T;
  extern __shared__ __align__(16) char smem[];
  __shared__ float warp_max[G::THREADS / 32];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * G::BM;
  const int n0 = blockIdx.x * G::BN;
  Acc acc[G::MT][G::NT][4];
  integrate_tile<TILE, CODES>(a, e, m0, n0, smem, acc);

  // a warp's WN columns lie inside one 64-column slot block of the tile
  const FragCoords<TILE> f;
  float tmax = 0.0f;
#pragma unroll
  for (int i = 0; i < G::MT; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = m0 + f.row(i, r);
      if (m >= a.M) continue;
      const size_t row = ((size_t)e * a.M + m) * a.N;
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int n = n0 + f.col(j, r);
        if (n >= a.N) continue;
        static_cast<Acc*>(out)[row + n] = acc[i][j][r];
        tmax = fmaxf(tmax, fabsf(__fmul_rn((float)acc[i][j][r], gain)));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) warp_max[warp] = tmax;
  __syncthreads();
  if (threadIdx.x < G::HALVES) {
    const int h = threadIdx.x;
    const int col = n0 + kSlotCols * h;
    if (col < a.N) {
      float m = 0.0f;
      for (int w = 0; w < G::THREADS / 32; ++w)
        if (((w % Tile<TILE>::WARPS_N) * G::WN) / kSlotCols == h)
          m = fmaxf(m, warp_max[w]);
      const int slot = slots[(size_t)e * nsb + col / slot_bw];
      atomicMax(reinterpret_cast<int*>(slot_max) + slot, __float_as_int(m));
    }
  }
}

template <bool PARKED_F32>
__global__ void __launch_bounds__(256)
b2_readout(float* __restrict__ out, const float* __restrict__ xs,
           const float* __restrict__ ws, const int* __restrict__ slots,
           int nsb, int slot_bw, const float* __restrict__ slot_max, int E,
           int M, int N, int shared_x, float gain, float levels,
           float inv_levels) {
  const size_t total = (size_t)E * M * N;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)(idx % N);
    const size_t em = idx / N;
    const int m = (int)(em % M);
    const int e = (int)(em / M);
    const float acc = PARKED_F32 ? out[idx] : (float)__float_as_int(out[idx]);
    const float z = __fmul_rn(acc, gain);
    float s = slot_max[slots[(size_t)e * nsb + n / slot_bw]];
    s = (s < 1e-9f) ? 1e-9f : s;   // jnp.maximum(s, 1e-9): NaN stays NaN
    const float xsv = xs[(size_t)(shared_x ? 0 : e) * M + m];
    out[idx] = readout(z, s, xsv, ws[(size_t)e * N + n], levels, inv_levels);
  }
}

template <int CODES, int TILE>
static int integrate(const TileArgs& a, int E, const int* slots, int nsb,
                     int slot_bw, float* slot_max, void* out, float gain,
                     cudaStream_t s) {
  using G = Geometry<TILE, CODES>;
  constexpr auto kernel = b2_integrate<CODES, TILE>;
  const cudaError_t err = allow_smem<kernel>(G::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.N + G::BN - 1) / G::BN, (a.M + G::BM - 1) / G::BM, E);
  kernel<<<grid, G::THREADS, G::SMEM, s>>>(a, slots, nsb, slot_bw, slot_max,
                                           out, gain);
  return (int)cudaGetLastError();
}

template <int CODES>
static int integrate_tile_choice(int tile, const TileArgs& a, int E,
                                 const int* slots, int nsb, int slot_bw,
                                 float* slot_max, void* out, float gain,
                                 cudaStream_t s) {
  if (tile == kSmall)
    return integrate<CODES, kSmall>(a, E, slots, nsb, slot_bw, slot_max, out,
                                    gain, s);
  return integrate<CODES, kLarge>(a, E, slots, nsb, slot_bw, slot_max, out,
                                  gain, s);
}

}  // namespace tdvmm

// Plain C entry point (bound with ctypes): both launches on ``stream``.
// ``codes``: 0 int8, 1 int4 pairs, 2 float32 (bf16 tile), 3 float32
// (3xTF32); ``tile``: 0 small, 1 large;
// K is the code depth.  ``slot_bw`` is a multiple of 64 unless one
// slot block spans all N columns.  ``slot_max`` (nslots float32) must be
// zeroed by the caller.  Returns the first non-zero cudaError_t, else 0.
extern "C" int tdvmm_b2(const void* x, const void* w, const void* xs,
                        const void* ws, const void* slots, int nsb,
                        int slot_bw, void* slot_max, void* out, int E, int M,
                        int K, int N, int shared_x, int vec_x, int vec_w,
                        int codes, int tile, float gain, float levels,
                        float inv_levels, void* stream) {
  using namespace tdvmm;
  if (slot_bw < 1 || codes < 0 || codes > 3 || tile < 0 || tile > 1)
    return (int)cudaErrorInvalidValue;
  const TileArgs a = tile_args(x, w, M, K, N, shared_x, vec_x, vec_w, codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* islots = static_cast<const int*>(slots);
  float* fmax = static_cast<float*>(slot_max);
  int err;
  if (codes == kInt8)
    err = integrate_tile_choice<kInt8>(tile, a, E, islots, nsb, slot_bw, fmax,
                                       out, gain, s);
  else if (codes == kInt4)
    err = integrate_tile_choice<kInt4>(tile, a, E, islots, nsb, slot_bw, fmax,
                                       out, gain, s);
  else if (codes == kF32)
    err = integrate_tile_choice<kF32>(tile, a, E, islots, nsb, slot_bw, fmax,
                                      out, gain, s);
  else
    err = integrate_tile_choice<kF32x3>(tile, a, E, islots, nsb, slot_bw,
                                        fmax, out, gain, s);
  if (err) return err;
  const size_t total = (size_t)E * M * N;
  size_t blocks = (total + 255) / 256;
  if (blocks > 8 * 132) blocks = 8 * 132;
  if (blocks < 1) blocks = 1;
  float* fout = static_cast<float*>(out);
  const float* fxs = static_cast<const float*>(xs);
  const float* fws = static_cast<const float*>(ws);
  if (codes == kF32 || codes == kF32x3)
    b2_readout<true><<<(unsigned)blocks, 256, 0, s>>>(
        fout, fxs, fws, islots, nsb, slot_bw, fmax, E, M, N, shared_x, gain,
        levels, inv_levels);
  else
    b2_readout<false><<<(unsigned)blocks, 256, 0, s>>>(
        fout, fxs, fws, islots, nsb, slot_bw, fmax, E, M, N, shared_x, gain,
        levels, inv_levels);
  return (int)cudaGetLastError();
}
