// Kernel B3: the Mamba-2 SSD chunked scan, from a zero initial state.
//
// Replaces repro/kernels/ssd/ssd.py:_kernel (launched by ssd_kernel), which
// ran a (B, H, L/Q) grid with a sequential chunk axis and kept the (P, S)
// state in VMEM scratch.  Hopper runs CTAs in no order, so here one CTA owns
// one (batch row, head) and walks the chunks itself; the state stays in
// shared memory across the walk and goes to device memory once, at the end
// (the model's prefill hands it to decode).  Per chunk of Q positions, with
// a = -exp(a_log[h]) and cum the inclusive prefix sum of dt * a:
//
//   W[i, j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j          (j <= i)
//   y_i     = sum_j W[i, j] x_j + exp(cum_i) * (C_i . state)
//   state   = state * exp(cum_Q) + sum_j x_j (exp(cum_Q - cum_j) dt_j) B_j^T
//
// All sums run in float32 (inputs float32 or bfloat16, y written in the
// input type with round-to-nearest-even).  The head reads its B/C group as
// h / (H / G).  Shared memory holds x (Q x P), B (Q x (S+1)), the state
// (P x (S+1)) and one 32-row block of C and of the Q x Q weight tile at a
// time, all float32: 166,144 bytes at Q = 128, P = 64, S = 128, so the launch
// raises the dynamic shared memory limit first.  Rows of B and the state
// are padded by one float so that a warp reading 32 rows at one column hits
// 32 banks.
//
// Bound on the card: bytes, narrowly.  The scan needs C.B^T once per
// (row, group, chunk) and its lower triangle only, Q (Q + 1) S flops, and
// per (row, head, chunk) Q (Q + 1) P + 4 Q P S flops: 5.4 GFLOP at full
// width (B 4, L 512, H 64, G 1), 11 us at the TF32 tensor-core rate, under
// the 13 us it takes to move its 43.5 MB (bfloat16) at 3.35 TB/s.  This
// first version runs its products on CUDA cores (fmaf from shared memory),
// one CTA per (row, head), and recomputes C.B^T for every head of a group;
// tensor cores (mma.sync / wgmma) and sharing C.B^T across a group's heads
// are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssd {

constexpr int kThreads = 256;
constexpr int kRB = 32;               // rows of the Q x Q tile per pass
constexpr int kMaxSmem = 232448;      // per block on sm_90

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_log, const T* __restrict__ b,
           const T* __restrict__ c, T* __restrict__ y,
           float* __restrict__ state_out, int L, int H, int P, int G, int S,
           int Q) {
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int g = h / (H / G);
  const int S1 = S + 1;
  extern __shared__ float sm[];
  float* xs = sm;                    // Q x P
  float* bs = xs + Q * P;            // Q x (S + 1)
  float* cs = bs + Q * S1;           // kRB x S
  float* st = cs + kRB * S;          // P x (S + 1)
  float* wt = st + P * S1;           // kRB x Q
  float* dts = wt + kRB * Q;         // Q
  float* cum = dts + Q;              // Q
  float* dec = cum + Q;              // Q: exp(cum_Q - cum_j) * dt_j

  const float a = -expf(a_log[h]);
  for (int i = threadIdx.x; i < P * S1; i += kThreads) st[i] = 0.f;
  const long long xrow = (long long)H * P;   // x / y stride between positions
  const long long brow = (long long)G * S;   // b / c stride between positions
  const int nc = L / Q;
  for (int ci = 0; ci < nc; ++ci) {
    const long long t0 = (long long)bi * L + (long long)ci * Q;
    const T* xg = x + t0 * xrow + (long long)h * P;
    const T* bg = b + t0 * brow + (long long)g * S;
    const T* cg = c + t0 * brow + (long long)g * S;
    T* yg = y + t0 * xrow + (long long)h * P;
    __syncthreads();                 // the last chunk's state update is done
    for (int i = threadIdx.x; i < Q * P; i += kThreads) {
      const int j = i / P, p = i - j * P;
      xs[i] = to_f(xg[j * xrow + p]);
    }
    for (int i = threadIdx.x; i < Q * S; i += kThreads) {
      const int j = i / S, s = i - j * S;
      bs[j * S1 + s] = to_f(bg[j * brow + s]);
    }
    for (int j = threadIdx.x; j < Q; j += kThreads)
      dts[j] = dt[(t0 + j) * H + h];
    __syncthreads();
    if (threadIdx.x == 0) {
      float acc = 0.f;
      for (int j = 0; j < Q; ++j) {
        acc += dts[j] * a;
        cum[j] = acc;
      }
    }
    __syncthreads();
    const float total = cum[Q - 1];
    for (int j = threadIdx.x; j < Q; j += kThreads)
      dec[j] = expf(total - cum[j]) * dts[j];

    // y, one block of kRB rows at a time
    for (int r0 = 0; r0 < Q; r0 += kRB) {
      const int rb = min(kRB, Q - r0);
      for (int i = threadIdx.x; i < rb * S; i += kThreads) {
        const int r = i / S, s = i - r * S;
        cs[i] = to_f(cg[(long long)(r0 + r) * brow + s]);
      }
      __syncthreads();
      for (int e = threadIdx.x; e < rb * Q; e += kThreads) {
        const int r = e / Q, j = e - r * Q, i = r0 + r;
        float v = 0.f;
        if (j <= i) {
          const float* cr = cs + r * S;
          const float* br = bs + j * S1;
          float gs = 0.f;
          for (int s = 0; s < S; ++s) gs = fmaf(cr[s], br[s], gs);
          v = gs * expf(cum[i] - cum[j]) * dts[j];
        }
        wt[e] = v;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < rb * P; e += kThreads) {
        const int r = e / P, p = e - r * P, i = r0 + r;
        const float* wr = wt + r * Q;
        float intra = 0.f;
        for (int j = 0; j <= i; ++j) intra = fmaf(wr[j], xs[j * P + p], intra);
        const float* cr = cs + r * S;
        const float* sr = st + p * S1;
        float inter = 0.f;
        for (int s = 0; s < S; ++s) inter = fmaf(cr[s], sr[s], inter);
        yg[(long long)i * xrow + p] = from_f<T>(intra + expf(cum[i]) * inter);
      }
      __syncthreads();
    }

    // state update (every y row above read the previous state)
    const float dtot = expf(total);
    for (int e = threadIdx.x; e < P * S; e += kThreads) {
      const int p = e / S, s = e - p * S;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j)
        acc = fmaf(xs[j * P + p] * dec[j], bs[j * S1 + s], acc);
      st[p * S1 + s] = st[p * S1 + s] * dtot + acc;
    }
  }
  __syncthreads();
  float* so = state_out + ((long long)bi * H + h) * P * S;
  for (int e = threadIdx.x; e < P * S; e += kThreads) {
    const int p = e / S, s = e - p * S;
    so[e] = st[p * S1 + s];
  }
}

size_t smem_bytes(int P, int S, int Q) {
  return sizeof(float) * ((size_t)Q * P + (size_t)Q * (S + 1) +
                          (size_t)kRB * S + (size_t)P * (S + 1) +
                          (size_t)kRB * Q + 3 * (size_t)Q);
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, void* y, void* state, int B, int L, int H, int P,
           int G, int S, int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, S, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  ssd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<float*>(state), L, H, P, G, S, Q);
  return (int)cudaGetLastError();
}

}  // namespace ssd

// dtype: 0 float32, 1 bfloat16 (x, b, c and y); dt, a_log and the state are
// float32.  L must be a multiple of Q (the wrapper pads with dt = 0).
extern "C" int ssd_b3(const void* x, const void* dt, const void* a_log,
                      const void* b, const void* c, void* y, void* state,
                      int B, int L, int H, int P, int G, int S, int Q,
                      int dtype, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || G <= 0 || S <= 0 || Q <= 0 ||
      H % G != 0 || L % Q != 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (ssd::smem_bytes(P, S, Q) > (size_t)ssd::kMaxSmem)
    return (int)cudaErrorInvalidConfiguration;
  if (dtype == 0)
    return ssd::launch<float>(x, dt, a_log, b, c, y, state, B, L, H, P, G, S,
                              Q, stream);
  if (dtype == 1)
    return ssd::launch<__nv_bfloat16>(x, dt, a_log, b, c, y, state, B, L, H,
                                      P, G, S, Q, stream);
  return (int)cudaErrorInvalidValue;
}
