// Kernel B2: TD-VMM integrate + *data-calibrated* readout, one HBM output.
//
// Replaces repro/kernels/tdvmm/tdvmm.py:_calib_kernel (tdvmm_calibrated_
// kernel).  The readout window of a slot (an expert tile, or a ragged group
// member's column span) is max|z| over the whole slot, which no single tile
// sees.  The Pallas kernel walked its grid twice in one launch; a GPU grid
// has no barrier across CTAs, so this is two launches over ONE (E, M, N)
// float32 buffer:
//
//   (i)  b2_integrate: the shared tile walk (tdvmm_tile.cuh, int8, int4
//        pairs or float32 codes); each CTA parks its raw accumulators in the
//        float32 output (an int32 accumulator as its bit pattern, as the
//        Pallas kernel parks it; a float32 one, from f32 codes, as it is)
//        and folds its tile's max |f32(acc) * gain| into the slot maximum
//        with one atomicMax on the int bit pattern, which orders like the
//        value for non-negative floats.  A float max is exact and
//        order-free, so the slot window is bitwise the unfused global max.
//        One slot per expert for the MoE expert grid.
//   (ii) b2_readout: in place, every element re-reads its parked accumulator
//        and applies the epilogue with s = max(slot_max, 1e-9).
//
// Bound on the card: bytes, as for B1, plus one extra read and write of the
// (M, N) float32 buffer for the second pass; the epilogue chain never exists
// as full-size intermediates.
#include "tdvmm_tile.cuh"

namespace tdvmm {

template <int CODES>
__global__ void __launch_bounds__(kThreads)
b2_integrate(TileArgs a, const int* __restrict__ slots, int nsb, int slot_bw,
             float* __restrict__ slot_max, void* __restrict__ out,
             float gain) {
  using Acc = typename AccType<CODES>::T;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  Acc acc[kTN];
  integrate_tile<CODES>(a, e, m0, n0, acc);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m = m0 + ty;
  float tmax = 0.0f;
  if (m < a.M) {
    const size_t row = ((size_t)e * a.M + m) * a.N;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= a.N) continue;
      static_cast<Acc*>(out)[row + n] = acc[j];
      tmax = fmaxf(tmax, fabsf(__fmul_rn((float)acc[j], gain)));
    }
  }
  __shared__ float warp_max[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = tmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    const int slot = slots[(size_t)e * nsb + n0 / slot_bw];
    atomicMax(reinterpret_cast<int*>(slot_max) + slot, __float_as_int(m));
  }
}

template <bool PARKED_F32>
__global__ void __launch_bounds__(kThreads)
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

}  // namespace tdvmm

// Plain C entry point (bound with ctypes): both launches on ``stream``.
// ``codes``: 0 int8, 1 int4 pairs, 2 float32; K is the code depth.
// ``slot_max`` (nslots float32) must be zeroed by the caller.  Returns the
// first non-zero cudaError_t, else 0.
extern "C" int tdvmm_b2(const void* x, const void* w, const void* xs,
                        const void* ws, const void* slots, int nsb,
                        int slot_bw, void* slot_max, void* out, int E, int M,
                        int K, int N, int shared_x, int vec_x, int vec_w,
                        int codes, float gain, float levels, float inv_levels,
                        void* stream) {
  using namespace tdvmm;
  if (slot_bw < 1 || codes < 0 || codes > 2) return (int)cudaErrorInvalidValue;
  const TileArgs a = tile_args(x, w, M, K, N, shared_x, vec_x, vec_w, codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* islots = static_cast<const int*>(slots);
  float* fmax = static_cast<float*>(slot_max);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, E);
  if (codes == kInt8)
    b2_integrate<kInt8><<<grid, kThreads, 0, s>>>(a, islots, nsb, slot_bw,
                                                  fmax, out, gain);
  else if (codes == kInt4)
    b2_integrate<kInt4><<<grid, kThreads, 0, s>>>(a, islots, nsb, slot_bw,
                                                  fmax, out, gain);
  else
    b2_integrate<kF32><<<grid, kThreads, 0, s>>>(a, islots, nsb, slot_bw,
                                                 fmax, out, gain);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t total = (size_t)E * M * N;
  size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 8 * 132) blocks = 8 * 132;
  if (blocks < 1) blocks = 1;
  float* fout = static_cast<float*>(out);
  const float* fxs = static_cast<const float*>(xs);
  const float* fws = static_cast<const float*>(ws);
  if (codes == kF32)
    b2_readout<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        fout, fxs, fws, islots, nsb, slot_bw, fmax, E, M, N, shared_x, gain,
        levels, inv_levels);
  else
    b2_readout<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        fout, fxs, fws, islots, nsb, slot_bw, fmax, E, M, N, shared_x, gain,
        levels, inv_levels);
  return (int)cudaGetLastError();
}
