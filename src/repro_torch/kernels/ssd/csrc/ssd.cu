// Kernel B3: the Mamba-2 SSD chunked scan, from a zero initial state, on
// Hopper's tensor cores.
//
// Replaces repro/kernels/ssd/ssd.py:_kernel (launched by ssd_kernel), which
// ran a (B, H, L/Q) grid with a sequential chunk axis and kept the (P, S)
// state in VMEM scratch.  Hopper runs CTAs in no order, so the chunk axis is
// taken apart as in Mamba-2's own chunked algorithm (arXiv:2405.21060, s. 6):
// the products of a chunk need only that chunk and the state carried into
// it.  Per chunk of Q positions, with a = -exp(a_log[h]) and cum the
// inclusive prefix sum of dt * a:
//
//   G[i, j] = C_i . B_j                                   (per group)
//   W[i, j] = G[i, j] * exp(cum_i - cum_j) * dt_j          (j <= i)
//   prev_c  = prev_{c-1} exp(cum_Q of c-1) + sum_j x_j (exp(cum_Q - cum_j)
//             dt_j) B_j^T over chunk c-1,  prev_0 = 0
//   y_i     = sum_j W[i, j] x_j + exp(cum_i) * (C_i . prev_c)
//
// Three kernels, launched in order on one stream by ssd_b3:
//
//   prep   (chunk, group, row)       C.B^T once per (row, group, chunk),
//                                    shared by the group's H / G heads, and
//                                    each head's prefix sum of dt * a
//   state  (head x P-block, row)     walks the chunks with the (P, S) state
//                                    in registers: prev_c of every chunk and
//                                    the final state
//   scan   (head x P-block, chunk, row)  y: W.x + exp(cum) (C.prev^T), all
//                                    chunks in parallel
//
// Every batch row's arithmetic reads only that row, and no sum uses atomics,
// so a row's result does not depend on its neighbours or on the CTA order.
//
// The four products (C.B^T, W.x, the state update and C.prev^T) run on the
// tensor cores as mma.sync m16n8k8 TF32 -> float32.  To hold the plain
// version's float32 results within 1e-5 (SSD_RTOL), an operand that is not
// exact in TF32 is split into hi = tf32(v) and lo = tf32(v - hi) and the
// product summed as lo.hi + hi.lo + hi.hi (3xTF32); the dropped lo.lo and
// the residual of the split are ~2^-22 of each product.  bfloat16 x, B and C
// are exact in TF32 and go as one operand, so those products take two MMAs
// (one when both operands are exact: C.B^T in bfloat16).  A split into bf16
// halves keeps only 16 bits (residual 2^-16 of each product) and misses the
// float32 gate (tests/test_torch_ssd.py emulates the schemes:
// emulation_report).
//
// The prefix sum of dt * a runs in the plain version's order, one add after
// another, with the product and the sum each rounded (no FMA): the decays
// exp(cum_i - cum_j) subtract two sums of up to hundreds in magnitude, and
// another association of the same sum (a warp scan) moves the final state
// by ~1.4e-5 of its max on its own, over the gate.  The sums of the H / G
// heads of a group run in parallel in the prep kernel, one thread per head,
// each over Q positions, while the C and B tiles are in flight.
//
// Tiles go from device memory to shared memory as 16-byte cp.async copies
// where the rows allow it (the wrapper passes vec_x / vec_bc), else element
// by element; the rows past Q and the columns past P or S are zero.  Row
// pitches are padded so that the fragment loads of a warp hit 32 banks.
// The state kernel keeps two chunks' tiles in flight; the state and y go
// out through shared memory as 16-byte rows.
//
// Bound on the card: bytes.  The scan needs C.B^T once per (row, group,
// chunk) and its lower triangle only, and per (row, head, chunk) the
// weighted x, the state update and C.prev^T: 5.4 GFLOP at mamba2-1.3b's
// prefill (B 4, L 512, H 64, G 1), 11 us at the TF32 rate; it must move
// 43.5 MB (bfloat16), 13 us at 3.35 TB/s.  This design also writes and
// reads the carried states (B x (L/Q - 1) x H x P x S float32, 25 MB there)
// and C.B^T (1 MB, read by every head from L2), reads each group's C once
// per head, and multiplies each product two or three times.  What holds it
// back on the card: the scan kernel takes more than half of the time
// (chip_smoke.py's device profile of one call, PERF.md); its fragments are
// built element by element from shared memory.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssd {

constexpr int kThreads = 256;          // prep: 8 warps
constexpr int kMaxQ = 128;             // rows of a chunk: 8 warps x 16
constexpr int kMaxS = 128;
constexpr int kPBlock = 64;            // P columns per CTA of state / scan
constexpr int kHeadBlock = 64;         // heads per prefix-sum pass of prep

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

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

// Row pitches (elements) of a shared-memory tile of cpad columns.  "Rows":
// a warp's fragment load reads element (g, t) at g * pitch + t (g 0..7, t
// 0..3); "cols": at t * pitch + g.  Both keep the 32 reads on 32 banks (two
// bfloat16 lanes share a word), and every row starts 16-byte aligned.
template <typename T>
__host__ __device__ constexpr int pitch_rows(int cpad) {
  return sizeof(T) == 4 ? round_up(cpad, 32) + 4 : round_up(cpad, 64) + 8;
}
template <typename T>
__host__ __device__ constexpr int pitch_cols(int cpad) {
  return sizeof(T) == 4 ? round_up(cpad, 32) + 8 : round_up(cpad, 64) + 8;
}

// Pitch of an output tile written from MMA accumulators: a thread writes the
// pair (g, 2t), (g, 2t + 1) as one 4- or 8-byte store, on 32 banks.
template <typename T>
__host__ __device__ constexpr int pitch_out(int cpad) {
  return sizeof(T) == 4 ? round_up(cpad, 32) + 8 : round_up(cpad, 64) + 8;
}

// ---------------------------------------------------------------------------
// Copies
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// rows [0, rpad) x columns [c0, c0 + cpad) of a row-major source with row
// stride ld into dst (pitch elements a row); rows >= rvalid and columns
// >= cvalid are zero.  vec: the source's rows and base are 16-byte aligned.
template <typename T, int NTH = kThreads>
__device__ __forceinline__ void load_tile(T* dst, int pitch, const T* src,
                                          long long ld, int rvalid, int rpad,
                                          int c0, int cvalid, int cpad,
                                          int vec) {
  constexpr int E = 16 / sizeof(T);
  const int chunks = cpad / E;
  for (int idx = threadIdx.x; idx < rpad * chunks; idx += NTH) {
    const int r = idx / chunks, col = (idx - r * chunks) * E;
    T* d = dst + r * pitch + col;
    const T* s = src + r * ld + c0 + col;
    if (vec && r < rvalid && c0 + col + E <= cvalid) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        d[e] = (r < rvalid && c0 + col + e < cvalid) ? s[e] : from_f<T>(0.f);
    }
  }
}

// rows [0, rows) x columns [0, cols) of a shared-memory tile (pitch
// elements a row) to a row-major destination with row stride ld: 16 bytes
// a thread where vec (cols and ld multiples of 16 bytes, dst aligned), else
// element by element.
template <typename T, int NTH>
__device__ __forceinline__ void store_tile(T* dst, long long ld,
                                           const T* src, int pitch, int rows,
                                           int cols, bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    const int chunks = cols / E;
    for (int idx = threadIdx.x; idx < rows * chunks; idx += NTH) {
      const int r = idx / chunks, col = (idx - r * chunks) * E;
      *reinterpret_cast<uint4*>(dst + r * ld + col) =
          *reinterpret_cast<const uint4*>(src + r * pitch + col);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += NTH) {
      const int r = idx / cols, col = idx - r * cols;
      dst[r * ld + col] = src[r * pitch + col];
    }
  }
}

// the accumulator pair (c0, c1) or (c2, c3) of a fragment as one store
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// Tensor-core products: mma.sync m16n8k8 TF32, 3xTF32 for inexact operands
// ---------------------------------------------------------------------------
// Fragments (g = lane / 4, t = lane % 4): A (16 x 8) a0 (g, t), a1 (g+8, t),
// a2 (g, t+4), a3 (g+8, t+4); B (8 x 8) b0 (k t, n g), b1 (k t+4, n g);
// C (16 x 8) c0, c1 (g, 2t, 2t+1), c2, c3 (g+8, 2t, 2t+1).
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// hi and lo of v; EXACT: v is a bfloat16 value, exact in TF32, lo unused
template <bool EXACT>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    hi = tf32(v);
    lo = tf32(v - __uint_as_float(hi));
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// A fragment at rows m0.., columns k0..: f(row, col) gives the value
template <bool EXACT, typename F>
__device__ __forceinline__ FragA frag_a(F f, int m0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  FragA a;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    split<EXACT>(f(m0 + g + 8 * (r & 1), k0 + t + 4 * (r >> 1)), a.hi[r],
                 a.lo[r]);
  return a;
}
// B fragment at depth k0.., columns n0..: f(k, n) gives the value
template <bool EXACT, typename F>
__device__ __forceinline__ FragB frag_b(F f, int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  FragB b;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    split<EXACT>(f(k0 + t + 4 * r, n0 + g), b.hi[r], b.lo[r]);
  return b;
}

// d += a.b with the small terms first
template <bool AEX, bool BEX>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  if (!AEX) mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  if (!BEX) mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

template <typename T>
struct Exact {
  static constexpr bool value = sizeof(T) == 2;
};

// Warp tilings of the state and scan kernels: STATE_WN warps across S (x 4
// across the 64 P columns), SCAN_WN warps across P (x 8 across the rows).
// float32 tiles take twice the shared memory (one CTA a SM) and three MMAs
// a product, so their CTAs get twice the warps; at bfloat16 two CTAs of 8
// warps share a SM.
template <typename T>
struct Tiling {
  static constexpr int STATE_WN = sizeof(T) == 4 ? 4 : 2;
  static constexpr int STATE_THREADS = 128 * STATE_WN;
  static constexpr int STATE_NT = 16 / STATE_WN;   // 8-column tiles a warp
  static constexpr int SCAN_WN = sizeof(T) == 4 ? 2 : 1;
  static constexpr int SCAN_THREADS = 256 * SCAN_WN;
  static constexpr int SCAN_NT = 8 / SCAN_WN;
};

// ---------------------------------------------------------------------------
// prep: C.B^T per (row, group, chunk); the group's prefix sums
// ---------------------------------------------------------------------------
// gmat (B, G, nc, QP, QP): row i, columns j < 16 (i / 16 + 1) written (the
// causal part the scan reads).  cum, dtc (B, nc, H, QP): the inclusive sum
// of dt * a and dt itself, dt = 0 past Q (so cum at QP - 1 is the chunk's
// total).
template <typename T>
__global__ void __launch_bounds__(kThreads)
prep_kernel(const T* __restrict__ b, const T* __restrict__ c,
            const float* __restrict__ dt, const float* __restrict__ a_log,
            float* __restrict__ gmat, float* __restrict__ cum,
            float* __restrict__ dtc, int L, int H, int G, int S, int Q,
            int vec_bc) {
  constexpr bool EX = Exact<T>::value;
  const int ci = blockIdx.x, g = blockIdx.y, bi = blockIdx.z;
  const int nc = gridDim.x, rep = H / G;
  const int QP = round_up(Q, 16), SP = round_up(S, 16);
  const long long t0 = (long long)bi * L + (long long)ci * Q;

  extern __shared__ __align__(16) unsigned char smem[];
  const int pc = pitch_rows<T>(SP);
  T* cs = reinterpret_cast<T*>(smem);          // QP x SP: C rows
  T* bs = cs + QP * pc;                        // QP x SP: B rows
  const long long brow = (long long)G * S;
  load_tile<T>(cs, pc, c + t0 * brow + (long long)g * S, brow, Q, QP, 0, S,
               SP, vec_bc);
  load_tile<T>(bs, pc, b + t0 * brow + (long long)g * S, brow, Q, QP, 0, S,
               SP, vec_bc);

  // the prefix sums, in the plain version's order, while the copies fly:
  // dt of kHeadBlock heads staged by all threads ([j][head], pitch
  // kHeadBlock + 1), one thread per head sums over j into sums ([head][j],
  // pitch QP + 1), and all threads write both out along j
  float* dts = reinterpret_cast<float*>(bs + QP * pc);
  float* sums = dts + QP * (kHeadBlock + 1);
  const int dp = kHeadBlock + 1, sp = QP + 1;
  for (int hb = 0; hb < rep; hb += kHeadBlock) {
    const int nh = imin(kHeadBlock, rep - hb);
    for (int e = threadIdx.x; e < QP * kHeadBlock; e += kThreads) {
      const int j = e / kHeadBlock, hh = e - j * kHeadBlock;
      dts[j * dp + hh] =
          j < Q && hh < nh ? dt[(t0 + j) * H + g * rep + hb + hh] : 0.f;
    }
    __syncthreads();
    if (threadIdx.x < nh) {
      const float a = -expf(a_log[g * rep + hb + threadIdx.x]);
      float acc = 0.f;
      for (int j = 0; j < QP; ++j) {
        acc = __fadd_rn(acc, __fmul_rn(dts[j * dp + threadIdx.x], a));
        sums[threadIdx.x * sp + j] = acc;
      }
    }
    __syncthreads();
    const long long o = ((long long)(bi * nc + ci) * H + g * rep + hb) * QP;
    for (int e = threadIdx.x; e < nh * QP; e += kThreads) {
      const int hh = e / QP, j = e - hh * QP;
      cum[o + e] = sums[hh * sp + j];
      dtc[o + e] = dts[j * dp + hh];
    }
    __syncthreads();
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = 16 * warp;
  if (i0 >= Q) return;
  float acc[kMaxQ / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMaxQ / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  auto c_at = [&](int i, int s) { return to_f(cs[i * pc + s]); };
  auto b_at = [&](int s, int j) { return to_f(bs[j * pc + s]); };
  for (int k0 = 0; k0 < SP; k0 += 8) {
    const FragA fa = frag_a<EX>(c_at, i0, k0);
#pragma unroll
    for (int nt = 0; nt < kMaxQ / 8; ++nt) {
      if (8 * nt < i0 + 16) {
        const FragB fb = frag_b<EX>(b_at, k0, 8 * nt);
        mma3<EX, EX>(acc[nt], fa, fb);
      }
    }
  }
  float* gm = gmat + ((long long)(bi * G + g) * nc + ci) * QP * QP;
  const int gr = lane >> 2, tc = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kMaxQ / 8; ++nt) {
    if (8 * nt < i0 + 16) {
      const int j = 8 * nt + 2 * tc;
      float* r0 = gm + (long long)(i0 + gr) * QP + j;
      float* r1 = r0 + 8LL * QP;
      r0[0] = acc[nt][0];
      r0[1] = acc[nt][1];
      r1[0] = acc[nt][2];
      r1[1] = acc[nt][3];
    }
  }
}

// ---------------------------------------------------------------------------
// state: the chunk states, carried over the chunks
// ---------------------------------------------------------------------------
// One CTA: one (row, head) and 64 columns of P; it walks the chunks in order
// with the running state in the warps' accumulators (warp w: P rows
// 16 (w % 4).., S columns 64 (w / 4)..), two chunks' x and B tiles in
// flight.  Per chunk c it writes prev_c to slot c of states (B, nc, H, P, S;
// slot 0, whose prev is zero, is not written), then adds the chunk's own
// (x * dec)^T B onto prev_c * exp(cum_Q); the last sum is the final state.
template <typename T>
__device__ __forceinline__ void state_stage(T* xs, int px, T* bs, int pb,
                                            float* cd, const T* x, const T* b,
                                            const float* cum, const float* dtc,
                                            int ci, int bi, int h, int g,
                                            int p0, int L, int H, int P,
                                            int G, int S, int Q, int vec_x,
                                            int vec_bc) {
  const int QP = round_up(Q, 16), SP = round_up(S, 16);
  const long long hc = (long long)(bi * (L / Q) + ci) * H + h;
  constexpr int NTH = Tiling<T>::STATE_THREADS;
  load_tile<float, NTH>(cd, QP, cum + hc * QP, QP, 1, 1, 0, QP, QP, 1);
  load_tile<float, NTH>(cd + QP, QP, dtc + hc * QP, QP, 1, 1, 0, QP, QP, 1);
  const int xc = round_up(imin(kPBlock, P - p0), 16);
  const long long t0 = (long long)bi * L + (long long)ci * Q;
  const long long xrow = (long long)H * P, brow = (long long)G * S;
  load_tile<T, NTH>(xs, px, x + t0 * xrow + (long long)h * P, xrow, Q, QP,
                    p0, P, xc, vec_x);
  load_tile<T, NTH>(bs, pb, b + t0 * brow + (long long)g * S, brow, Q, QP, 0,
                    S, SP, vec_bc);
  asm volatile("cp.async.commit_group;\n" ::);
}

// elements of T in one stage of the state kernel: the x and B tiles, and at
// least the output tile (64 x S float32) that reuses it
template <typename T>
__host__ __device__ int state_stage_elems(int P, int Q, int S) {
  const int QP = round_up(Q, 16), SP = round_up(S, 16);
  const int tiles = QP * (pitch_cols<T>(round_up(imin(kPBlock, P), 16)) +
                          pitch_cols<T>(SP));
  const int out = kPBlock * pitch_out<float>(SP) * (int)(4 / sizeof(T));
  return tiles > out ? tiles : out;
}

// a warp's running-state fragments into the output tile
template <int NT>
__device__ __forceinline__ void put_state(float* ob, int po,
                                          const float (&run)[NT][4], int m0,
                                          int nh, int SP) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tc = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nh + 8 * nt < SP) {
      float* o = ob + (m0 + gr) * po + nh + 8 * nt + 2 * tc;
      store_pair(o, run[nt][0], run[nt][1]);
      store_pair(o + 8 * po, run[nt][2], run[nt][3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Tiling<T>::STATE_THREADS,
                                  512 / Tiling<T>::STATE_THREADS)
state_kernel(const T* __restrict__ x, const T* __restrict__ b,
             const float* __restrict__ cum, const float* __restrict__ dtc,
             float* __restrict__ states, float* __restrict__ state_out,
             int L, int H, int P, int G, int S, int Q, int vec_x,
             int vec_bc) {
  constexpr bool EX = Exact<T>::value;
  constexpr int NTH = Tiling<T>::STATE_THREADS, NT = Tiling<T>::STATE_NT;
  const int npb = (P + kPBlock - 1) / kPBlock;
  const int h = blockIdx.x / npb, p0 = (blockIdx.x % npb) * kPBlock;
  const int bi = blockIdx.y, nc = L / Q;
  const int g = h / (H / G);
  const int QP = round_up(Q, 16), SP = round_up(S, 16);
  const int pv = imin(kPBlock, P - p0), xc = round_up(pv, 16);

  extern __shared__ __align__(16) unsigned char smem[];
  const int px = pitch_cols<T>(round_up(imin(kPBlock, P), 16));
  const int pb = pitch_cols<T>(SP);
  const int po = pitch_out<float>(SP);
  const int stage = state_stage_elems<T>(P, Q, S);
  T* base = reinterpret_cast<T*>(smem);        // 2 x (x[j][p], B[j][s])
  float* cds = reinterpret_cast<float*>(base + 2 * stage);  // 2 x (cum, dt)
  float* dec = cds + 4 * QP;                                 // QP
  const bool vec_s = S % 4 == 0;
  for (int st = 0; st < 2 && st < nc; ++st)
    state_stage<T>(base + st * stage, px, base + st * stage + QP * px, pb,
                   cds + 2 * QP * st, x, b, cum, dtc, st, bi, h, g, p0, L, H,
                   P, G, S, Q, vec_x, vec_bc);

  const int warp = threadIdx.x >> 5;
  const int m0 = 16 * (warp & 3), nh = 8 * NT * (warp >> 2);
  const bool active = m0 < xc && nh < SP;
  float run[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) run[nt][e] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const T* xs = base + (ci & 1) * stage;
    const T* bs = xs + QP * px;
    const float* cd = cds + 2 * QP * (ci & 1);
    const long long hc = (long long)(bi * nc + ci) * H + h;
    if (ci + 1 < nc)
      asm volatile("cp.async.wait_group 1;\n" ::);
    else
      asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    const float total = cd[QP - 1];
    for (int j = threadIdx.x; j < QP; j += NTH)
      dec[j] = __fmul_rn(expf(__fsub_rn(total, cd[j])), cd[QP + j]);
    __syncthreads();
    if (active) {
      const float decay = expf(total);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[nt][e] = __fmul_rn(run[nt][e], decay);
      // A (m = p, k = j): x[j][p] dec[j]; B (k = j, n = s): B[j][s]
      auto u_at = [&](int p, int j) {
        return __fmul_rn(to_f(xs[j * px + p]), dec[j]);
      };
      auto b_at = [&](int j, int s) { return to_f(bs[j * pb + s]); };
      for (int k0 = 0; k0 < QP; k0 += 8) {
        const FragA fa = frag_a<false>(u_at, m0, k0);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nh + 8 * nt < SP) {
            const FragB fb = frag_b<EX>(b_at, k0, nh + 8 * nt);
            mma3<false, EX>(run[nt], fa, fb);
          }
        }
      }
    }
    // run is now prev of chunk ci + 1 (the final state after the last):
    // out through the stage just consumed, as 16-byte rows
    __syncthreads();
    float* ob = reinterpret_cast<float*>(base + (ci & 1) * stage);
    if (active) put_state(ob, po, run, m0, nh, SP);
    __syncthreads();
    store_tile<float, NTH>(
        ci + 1 < nc ? states + (hc + H) * P * S + (long long)p0 * S
                    : state_out + ((long long)bi * H + h) * P * S +
                          (long long)p0 * S,
        S, ob, po, pv, S, vec_s);
    __syncthreads();                   // the stage is free again
    if (ci + 2 < nc)
      state_stage<T>(base + (ci & 1) * stage, px,
                     base + (ci & 1) * stage + QP * px, pb,
                     cds + 2 * QP * (ci & 1), x, b, cum, dtc, ci + 2, bi, h,
                     g, p0, L, H, P, G, S, Q, vec_x, vec_bc);
  }
}

// ---------------------------------------------------------------------------
// scan: y = W.x + exp(cum) (C.prev^T)
// ---------------------------------------------------------------------------
// One CTA: one (row, head, chunk) and 64 columns of P; warp w: rows
// 16 (w % 8).. of the chunk, 8 SCAN_NT columns of the block from
// 8 SCAN_NT (w / 8).
template <typename T>
__global__ void __launch_bounds__(Tiling<T>::SCAN_THREADS, 2)
scan_kernel(const T* __restrict__ x, const T* __restrict__ c,
            const float* __restrict__ gmat, const float* __restrict__ cum,
            const float* __restrict__ dtc, const float* __restrict__ states,
            T* __restrict__ y, int L, int H, int P, int G, int S, int Q,
            int vec_x, int vec_bc) {
  constexpr bool EX = Exact<T>::value;
  constexpr int NTH = Tiling<T>::SCAN_THREADS, NT = Tiling<T>::SCAN_NT;
  const int npb = (P + kPBlock - 1) / kPBlock;
  const int h = blockIdx.x / npb, p0 = (blockIdx.x % npb) * kPBlock;
  const int ci = blockIdx.y, bi = blockIdx.z, nc = gridDim.y;
  const int g = h / (H / G);
  const int QP = round_up(Q, 16), SP = round_up(S, 16);
  const int pv = imin(kPBlock, P - p0), xc = round_up(pv, 16);
  const long long t0 = (long long)bi * L + (long long)ci * Q;
  const long long hc = (long long)(bi * nc + ci) * H + h;

  extern __shared__ __align__(16) unsigned char smem[];
  const int xcmax = round_up(imin(kPBlock, P), 16);
  const int px = pitch_cols<T>(xcmax);
  const int pc = pitch_rows<T>(SP);
  const int pp = pitch_rows<float>(SP);
  T* xs = reinterpret_cast<T*>(smem);                   // QP x xc: x[j][p]
  T* cs = xs + QP * px;                                 // QP x SP: C[i][s]
  float* ps = reinterpret_cast<float*>(cs + QP * pc);   // xc x SP: prev[p][s]
  float* cm = ps + xcmax * pp;                          // QP
  float* dts = cm + QP;                                 // QP
  T* ys = reinterpret_cast<T*>(dts + QP);               // QP x xc: y[i][p]
  const int py = pitch_out<T>(xcmax);
  const long long xrow = (long long)H * P, brow = (long long)G * S;
  load_tile<T, NTH>(xs, px, x + t0 * xrow + (long long)h * P, xrow,
                             Q, QP, p0, P, xc, vec_x);
  load_tile<T, NTH>(cs, pc, c + t0 * brow + (long long)g * S, brow,
                             Q, QP, 0, S, SP, vec_bc);
  if (ci > 0)
    load_tile<float, NTH>(ps, pp,
                                   states + hc * P * S + (long long)p0 * S,
                                   S, pv, xc, 0, S, SP, (S % 4) == 0);
  load_tile<float, NTH>(cm, QP, cum + hc * QP, QP, 1, 1, 0, QP, QP,
                                 1);
  load_tile<float, NTH>(dts, QP, dtc + hc * QP, QP, 1, 1, 0, QP, QP,
                                 1);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = 16 * (warp & 7), n00 = 8 * NT * (warp >> 3);
  const bool active = i0 < Q && n00 < xc;
  float acc[NT][4], inter[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = inter[nt][e] = 0.f;

  const int gr = lane >> 2, tc = lane & 3;
  if (active) {
    // the weighted x, over the causal columns j < i0 + 16; each step's
    // C.B^T values are loaded one step ahead
    const float* g0 = gmat + ((long long)(bi * G + g) * nc + ci) * QP * QP +
                      (long long)(i0 + gr) * QP + tc;
    const float* g1 = g0 + 8LL * QP;
    const float ci0 = cm[i0 + gr], ci1 = cm[i0 + gr + 8];
    auto x_at = [&](int j, int p) { return to_f(xs[j * px + p]); };
    const int kend = i0 + 16;
    float gv[4] = {__ldg(g0), __ldg(g1), __ldg(g0 + 4), __ldg(g1 + 4)};
    for (int k0 = 0; k0 < kend; k0 += 8) {
      float gn[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + 8 < kend) {
        gn[0] = __ldg(g0 + k0 + 8);
        gn[1] = __ldg(g1 + k0 + 8);
        gn[2] = __ldg(g0 + k0 + 12);
        gn[3] = __ldg(g1 + k0 + 12);
      }
      FragA fa;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + gr + 8 * (r & 1), j = k0 + tc + 4 * (r >> 1);
        const float m = expf(__fsub_rn((r & 1) ? ci1 : ci0, cm[j]));
        const float w = j > i ? 0.f : __fmul_rn(__fmul_rn(gv[r], m), dts[j]);
        split<false>(w, fa.hi[r], fa.lo[r]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (n00 + 8 * nt < xc) {
          const FragB fb = frag_b<EX>(x_at, k0, n00 + 8 * nt);
          mma3<false, EX>(acc[nt], fa, fb);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) gv[r] = gn[r];
    }
    // the carried state: C.prev^T
    if (ci > 0) {
      auto c_at = [&](int i, int s) { return to_f(cs[i * pc + s]); };
      auto p_at = [&](int s, int p) { return ps[p * pp + s]; };
      for (int k0 = 0; k0 < SP; k0 += 8) {
        const FragA fa = frag_a<EX>(c_at, i0, k0);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (n00 + 8 * nt < xc) {
            const FragB fb = frag_b<false>(p_at, k0, n00 + 8 * nt);
            mma3<EX, false>(inter[nt], fa, fb);
          }
        }
      }
    }
    // y = W.x + exp(cum) (C.prev^T), through the output tile
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + gr + 8 * half;
      const float e = expf(cm[i]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        if (n00 + 8 * nt < xc)
          store_pair(ys + i * py + n00 + 8 * nt + 2 * tc,
                     __fadd_rn(acc[nt][2 * half],
                               __fmul_rn(e, inter[nt][2 * half])),
                     __fadd_rn(acc[nt][2 * half + 1],
                               __fmul_rn(e, inter[nt][2 * half + 1])));
    }
  }
  __syncthreads();
  store_tile<T, NTH>(y + t0 * (long long)H * P + (long long)h * P +
                                  p0,
                              (long long)H * P, ys, py, Q, pv,
                              (pv * sizeof(T)) % 16 == 0 &&
                                  (P * sizeof(T)) % 16 == 0);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
template <typename T>
size_t smem_prep(int Q, int S) {
  const int QP = round_up(Q, 16);
  return 2 * sizeof(T) * (size_t)QP * pitch_rows<T>(round_up(S, 16)) +
         sizeof(float) * ((size_t)QP * (kHeadBlock + 1) +
                          (size_t)kHeadBlock * (QP + 1));
}
template <typename T>
size_t smem_state(int P, int Q, int S) {
  return 2 * sizeof(T) * (size_t)state_stage_elems<T>(P, Q, S) +
         sizeof(float) * 5 * (size_t)round_up(Q, 16);
}
template <typename T>
size_t smem_scan(int P, int Q, int S) {
  const int QP = round_up(Q, 16), SP = round_up(S, 16);
  const int xc = round_up(imin(kPBlock, P), 16);
  return sizeof(T) * (size_t)QP *
             (pitch_cols<T>(xc) + pitch_rows<T>(SP) + pitch_out<T>(xc)) +
         sizeof(float) * ((size_t)xc * pitch_rows<float>(SP) + 2 * QP);
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch(const void* x_, const void* dt, const void* a_log, const void* b_,
           const void* c_, void* y_, void* state, float* gmat, float* cum,
           float* dtc, float* states, int B, int L, int H, int P,
           int G, int S, int Q, int vec_x, int vec_bc, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const T* b = static_cast<const T*>(b_);
  const T* c = static_cast<const T*>(c_);
  const int nc = L / Q, npb = (P + kPBlock - 1) / kPBlock;
  const size_t s1 = smem_prep<T>(Q, S), s2 = smem_state<T>(P, Q, S),
               s4 = smem_scan<T>(P, Q, S);
  int err;
  if ((err = allow_smem(prep_kernel<T>, s1)) ||
      (err = allow_smem(state_kernel<T>, s2)) ||
      (err = allow_smem(scan_kernel<T>, s4)))
    return err;
  prep_kernel<T><<<dim3(nc, G, B), kThreads, s1, stream>>>(
      b, c, static_cast<const float*>(dt), static_cast<const float*>(a_log),
      gmat, cum, dtc, L, H, G, S, Q, vec_bc);
  if ((err = (int)cudaGetLastError())) return err;
  state_kernel<T><<<dim3(H * npb, B), Tiling<T>::STATE_THREADS, s2,
                    stream>>>(
      x, b, cum, dtc, states, static_cast<float*>(state), L, H, P, G, S, Q,
      vec_x, vec_bc);
  if ((err = (int)cudaGetLastError())) return err;
  scan_kernel<T><<<dim3(H * npb, nc, B), Tiling<T>::SCAN_THREADS, s4,
                   stream>>>(
      x, c, gmat, cum, dtc, states, static_cast<T*>(y_), L, H, P, G, S, Q,
      vec_x, vec_bc);
  return (int)cudaGetLastError();
}

}  // namespace ssd

// dtype: 0 float32, 1 bfloat16 (x, b, c and y); dt, a_log, the state and
// the scratch are float32.  L must be a multiple of Q (the wrapper pads with
// dt = 0); Q <= 128 and S <= 128.  Scratch, in floats: gmat B G (L/Q) QP^2,
// cum and dtc B (L/Q) H QP each, states B (L/Q) H P S, with QP = Q rounded
// up to 16, each 16-byte aligned.  vec_x / vec_bc: x's / b's and c's rows
// and bases are 16-byte aligned.
extern "C" int ssd_b3(const void* x, const void* dt, const void* a_log,
                      const void* b, const void* c, void* y, void* state,
                      void* gmat, void* cum, void* dtc, void* states, int B,
                      int L, int H, int P, int G, int S, int Q, int dtype,
                      int vec_x, int vec_bc, cudaStream_t stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || G <= 0 || S <= 0 || Q <= 0 ||
      H % G != 0 || L % Q != 0 || Q > ssd::kMaxQ || S > ssd::kMaxS ||
      B * G > 65535 || L / Q > 65535)
    return (int)cudaErrorInvalidValue;
  float* f[4] = {static_cast<float*>(gmat), static_cast<float*>(cum),
                 static_cast<float*>(dtc), static_cast<float*>(states)};
  if (dtype == 0)
    return ssd::launch<float>(x, dt, a_log, b, c, y, state, f[0], f[1], f[2],
                              f[3], B, L, H, P, G, S, Q, vec_x, vec_bc,
                              stream);
  if (dtype == 1)
    return ssd::launch<__nv_bfloat16>(x, dt, a_log, b, c, y, state, f[0],
                                      f[1], f[2], f[3], B, L, H, P, G, S, Q,
                                      vec_x, vec_bc, stream);
  return (int)cudaErrorInvalidValue;
}
