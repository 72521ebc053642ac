// Shared charge-accumulation tile for the TD-VMM kernels (B1 and B2), on
// Hopper's tensor cores.
//
// One CTA owns a (BM x BN) output tile of one batch entry e and walks the
// whole K axis itself: the loop over K inside the block takes the place of
// the sequential K grid axis of the Pallas kernel
// (repro/kernels/tdvmm/tdvmm.py:_kernel), whose accumulator lived in VMEM
// scratch.  Here it lives in registers as mma.sync accumulator fragments:
// each warp owns a (WM x WN) sub-tile made of m16n8 fragments.
//
// Two tiles, chosen on the host by M alone (tdvmm.plan_tile):
//
//   kSmall   16 x 64,   4 warps of 16 x 16, 4 stages   M <= 256 (decode,
//                                                      chunked prefill, the
//                                                      128-row captures)
//   kLarge   128 x 128, 8 warps of 64 x 32, 3 stages   M > 256 (prefill and
//                                                      calibration at
//                                                      thousands of rows,
//                                                      the MoE dispatch
//                                                      buffer)
//
// Up to a few hundred rows the small tile's many CTAs keep the card's SMs
// busy; beyond, the large tile's reuse of each staged code wins
// (scripts/tdvmm_tile_ab.py measures both at the serving shapes).
//
// Operands stream from device memory in the storage they have there, with
// 16-byte cp.async copies into a ring of STAGES shared-memory stages, so the
// copies of later K steps overlap the products of this one.  A chunk that
// is ragged (M, K or N edge) or unaligned (a row that is not a multiple of
// 16 bytes, or a base that is not 16-byte aligned: vec_x / vec_w = 0) is
// copied element by element with bounds and zero fill instead.  A zero code
// is an inert current source, so padding is exact.
//
// Three code storages, as the Pallas kernel takes them:
//
//   kInt8  int8 codes: mma.sync m16n8k32 s8 x s8 -> s32.  The int32
//          accumulator is exact in any order.  The s8 MMA wants both
//          operands K-major; x is (M, K) row-major and feeds the A
//          fragments from its stage as it is.  w arrives N-major (E, K, N),
//          so each K step transposes its stage on chip (4 x 4 byte blocks
//          with __byte_perm) into an (N, K) buffer for the B fragments.
//   kInt4  p <= 3 codes packed two per byte along K (quant.pack_int4: byte
//          kp holds code 2kp in the low nibble, 2kp+1 in the high one), the
//          Pallas kernel's _unpack_nibbles mode.  The packed bytes stream
//          from device memory (half the int8 bytes); the same on-chip pass
//          sign-extends the nibbles ((v << 4) >> 4 for the low one, v >> 4
//          for the high one) into int8 codes in K order, x and w alike, and
//          feeds the same s8 MMA.  Both operands unpack the same pairs, so
//          the int32 sums are bitwise the int8 ones.
//   kF32   integer-valued float32 codes (p = 8): mma.sync m16n8k16
//          bf16 x bf16 -> f32.  The float32 codes stream from device memory
//          as they are stored (4 bytes each) and round to bf16 as the
//          fragments are loaded from shared memory.  That rounding is exact
//          for |code| <= 256 (the wrapper raises for a wider code width,
//          tdvmm.check_code_width), every product of two such codes is
//          exact in float32, and inside the envelope the layer checks
//          (worst |acc| < 2^24) every partial sum is an integer that float32
//          holds exactly, so the tensor cores' float32 sums are bitwise the
//          plain version's whatever their order or internal alignment.
//          Codes with programming noise are not integers; they go to kF32x3.
//   kF32x3 float32 codes on the TF32 tensor cores, three products:
//          mma.sync m16n8k8 tf32 x tf32 -> f32.  Staged as kF32 stages them;
//          as each fragment loads, every code v is split into TF32 parts
//          hi = tf32(v), lo = tf32(v - hi) (to nearest, ties away from zero,
//          as cvt.rna rounds a finite v), and each 8-deep block is summed as
//          lo.hi + hi.lo + hi.hi.  The tensor cores add into their
//          accumulator truncating, not to nearest (B4's finding, PR 17's
//          crossing.cu), so each 32-code K stage is summed on them from zero
//          and then added into the running total with one IEEE add.  This
//          takes codes the bf16 tile cannot: codes off the integer grid
//          (programming noise during training), within float32 rounding of
//          the plain version (the dropped lo.lo and the split's residual are
//          ~2^-22 of each product; tdvmm.F32X3_RTOL bounds the sum), and
//          integer codes up to |2047| (p = 9-11), which TF32 holds exactly:
//          their lo parts are 0, every product and partial sum is an integer
//          below 2^24, and the result is bitwise the plain version's.  No
//          atomics: two calls are bitwise equal.
//
// What bounds it: at decode, device-memory bytes (the weight codes); the
// small tile's ring keeps up to three K steps of weights in flight per CTA.
// At the large tile the operations sit far below the tensor-core rate: the
// kernel is bound by staging, the 16-byte copies from L2 into shared memory
// and the fragment loads out of it.  For float32 codes the staging of the
// 4-byte codes dominates (a split of the kernel into loads alone and
// products alone on the card puts most of its time in the loads); for int8
// and int4 the two halves weigh about the same.  Neither a 128 x 256 tile
// nor a row-grouped CTA order nor rounding to bf16 once per CTA instead of
// per warp made it faster.  The accumulator and epilogue stay on chip, so
// each output is written once.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tdvmm {

enum Codes { kInt8 = 0, kInt4 = 1, kF32 = 2, kF32x3 = 3 };
enum TileId { kSmall = 0, kLarge = 1 };

// Output columns per readout-slot block (tdvmm.TILE_N): B2 keeps one
// running max per 64-column block of a CTA tile.
constexpr int kSlotCols = 64;

template <int CODES>
struct AccType { using T = int; };
template <>
struct AccType<kF32> { using T = float; };
template <>
struct AccType<kF32x3> { using T = float; };

// Per storage: EB bytes per stored element; KS stored elements per K step
// along a row of x (= rows of w per step; 64 codes for the integer
// storages, 32 for float32); XROW / WPAD the padded shared-memory row
// pitch of the raw x stage and the pad of a raw w row (bytes).
template <int CODES>
struct Storage;
template <>
struct Storage<kInt8> {
  static constexpr int EB = 1, KS = 64, XROW = 64 + 16, WPAD = 16;
};
template <>
struct Storage<kInt4> {
  static constexpr int EB = 1, KS = 32, XROW = 32 + 16, WPAD = 16;
};
template <>
struct Storage<kF32> {
  static constexpr int EB = 4, KS = 32, XROW = 128 + 32, WPAD = 16;
};
template <>
struct Storage<kF32x3> : Storage<kF32> {};

// Pitch of the on-chip int8 code rows (the transposed w, the unpacked int4
// x): 64 codes + 16 bytes, conflict-free for the fragment loads.
constexpr int kCodeRow = 64 + 16;

template <int TILE>
struct Tile;
template <>
struct Tile<kSmall> {
  static constexpr int BM = 16, BN = 64, WARPS_M = 1, WARPS_N = 4, STAGES = 4;
};
template <>
struct Tile<kLarge> {
  static constexpr int BM = 128, BN = 128, WARPS_M = 2, WARPS_N = 4,
                       STAGES = 3;
};

template <int TILE, int CODES>
struct Geometry {
  using T = Tile<TILE>;
  using S = Storage<CODES>;
  static constexpr int BM = T::BM, BN = T::BN, STAGES = T::STAGES;
  static constexpr int THREADS = 32 * T::WARPS_M * T::WARPS_N;
  static constexpr int WM = BM / T::WARPS_M, WN = BN / T::WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;   // m16 / n8 fragments
  static constexpr int WROW = BN * S::EB + S::WPAD;
  static constexpr int SX = BM * S::XROW;           // raw x stage bytes
  static constexpr int SW = S::KS * WROW;           // raw w stage bytes
  static constexpr int STAGE = SX + SW;
  static constexpr bool FLOAT = CODES == kF32 || CODES == kF32x3;
  static constexpr int WT = FLOAT ? 0 : BN * kCodeRow;
  static constexpr int XC = CODES == kInt4 ? BM * kCodeRow : 0;
  static constexpr int SMEM = STAGES * STAGE + WT + XC;
  static constexpr int HALVES = BN / kSlotCols;     // slot blocks per tile
};

struct TileArgs {
  const void* x;     // (E|1, M, kb) row-major: int8 codes, packed pairs, f32
  const void* w;     // (E, kb, N) row-major
  int M, N;
  int kb;            // stored elements per x row / rows of w (int4: the
                     // code depth K padded to even, halved)
  int shared_x;      // x has one batch entry shared by every e
  int vec_x;         // x rows a multiple of 16 bytes, base 16-byte aligned
  int vec_w;         // w rows a multiple of 16 bytes, base 16-byte aligned
};

// The TileArgs of a launch: K is the code depth; int4 stores (K + 1) / 2
// packed bytes per row (the pad nibble of an odd K is a zero code).
inline TileArgs tile_args(const void* x, const void* w, int M, int K, int N,
                          int shared_x, int vec_x, int vec_w, int codes) {
  const int kb = codes == kInt4 ? (K + 1) / 2 : K;
  return TileArgs{x, w, M, N, kb, shared_x, vec_x, vec_w};
}

// ---------------------------------------------------------------------------
// Copies
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 16-byte chunk of a stage: the bytes [off, off + 16) of a device row
// holding ``valid`` bytes (valid <= 0: all zero).  ``vec``: the chunk is
// whole and 16-byte aligned, so it goes by cp.async; otherwise element by
// element (EB-byte elements) with zero fill past ``valid``.
template <int EB>
__device__ __forceinline__ void copy_chunk(char* dst, const char* row,
                                           int off, int valid, int vec) {
  if (valid >= off + 16 && vec) {
    cp_async16(dst, row + off);
    return;
  }
  if (EB == 4) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = off + 4 * j < valid
                 ? reinterpret_cast<const float*>(row + off)[j] : 0.0f;
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (off + j < valid)
        v[j / 4] |= (uint32_t)(uint8_t)row[off + j] << (8 * (j % 4));
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Stage the K step kt: x rows m0.. (KS stored elements each) and w rows
// kt*KS.. (BN columns each) into one raw stage.
template <int TILE, int CODES>
__device__ __forceinline__ void load_stage(const TileArgs& a, const char* xb,
                                           const char* wb, int m0, int n0,
                                           int kt, char* stage) {
  using G = Geometry<TILE, CODES>;
  using S = Storage<CODES>;
  constexpr int XCH = S::KS * S::EB / 16;           // chunks per x row
  constexpr int WCH = G::BN * S::EB / 16;           // chunks per w row
  const int t = threadIdx.x;
  const int xrow_bytes = a.kb * S::EB;
  const int koff = kt * S::KS * S::EB;
#pragma unroll
  for (int c = t; c < G::BM * XCH; c += G::THREADS) {
    const int r = c / XCH, q = c % XCH;
    const int m = m0 + r;
    const char* row = xb + (size_t)(m < a.M ? m : 0) * xrow_bytes;
    copy_chunk<S::EB>(stage + r * S::XROW + 16 * q, row, koff + 16 * q,
                      m < a.M ? xrow_bytes : 0, a.vec_x);
  }
  char* sw = stage + G::SX;
  const int wrow_bytes = a.N * S::EB;
#pragma unroll
  for (int c = t; c < S::KS * WCH; c += G::THREADS) {
    const int r = c / WCH, q = c % WCH;
    const int kr = kt * S::KS + r;
    const char* row = wb + (size_t)(kr < a.kb ? kr : 0) * wrow_bytes;
    copy_chunk<S::EB>(sw + r * G::WROW + 16 * q, row, n0 * S::EB + 16 * q,
                      kr < a.kb ? wrow_bytes : 0, a.vec_w);
  }
}

// ---------------------------------------------------------------------------
// On-chip conversion of the integer storages
// ---------------------------------------------------------------------------
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

// The raw stage's w (K-major rows of N codes) into wt (N rows of 64 codes,
// K-major), and for int4 the packed x into xc (BM rows of 64 codes).  A
// unit is a 4 x 4 block: code rows 4kw..4kw+3 of columns 4nq..4nq+3; lanes
// run over 8 kw first so both the reads and the writes spread over banks.
template <int TILE, int CODES>
__device__ __forceinline__ void convert_stage(const char* stage, char* wt,
                                              char* xc) {
  using G = Geometry<TILE, CODES>;
  constexpr int NQ = G::BN / 4;
  const char* sw = stage + G::SX;
  const int t = threadIdx.x;
#pragma unroll
  for (int u = t; u < 16 * NQ; u += G::THREADS) {
    const int kw = u % 8 + 8 * (u / (8 * NQ));
    const int nq = (u / 8) % NQ;
    uint32_t r0, r1, r2, r3;
    if (CODES == kInt4) {
      // code rows 4kw, 4kw+1 are the nibbles of packed row 2kw; 4kw+2,
      // 4kw+3 of packed row 2kw+1
      const uint32_t p01 =
          *reinterpret_cast<const uint32_t*>(sw + (2 * kw) * G::WROW + 4 * nq);
      const uint32_t p23 = *reinterpret_cast<const uint32_t*>(
          sw + (2 * kw + 1) * G::WROW + 4 * nq);
      r0 = nibbles(p01, 0);
      r1 = nibbles(p01, 1);
      r2 = nibbles(p23, 0);
      r3 = nibbles(p23, 1);
    } else {
      const char* p = sw + (4 * kw) * G::WROW + 4 * nq;
      r0 = *reinterpret_cast<const uint32_t*>(p);
      r1 = *reinterpret_cast<const uint32_t*>(p + G::WROW);
      r2 = *reinterpret_cast<const uint32_t*>(p + 2 * G::WROW);
      r3 = *reinterpret_cast<const uint32_t*>(p + 3 * G::WROW);
    }
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
    const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
    const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
    const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
    char* q = wt + (4 * nq) * kCodeRow + 4 * kw;
    *reinterpret_cast<uint32_t*>(q) = __byte_perm(t0, t2, 0x5410);
    *reinterpret_cast<uint32_t*>(q + kCodeRow) = __byte_perm(t0, t2, 0x7632);
    *reinterpret_cast<uint32_t*>(q + 2 * kCodeRow) =
        __byte_perm(t1, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(q + 3 * kCodeRow) =
        __byte_perm(t1, t3, 0x7632);
  }
  if (CODES == kInt4) {
    // each packed word of x (codes 8wq..8wq+7 of a row) into two code words
#pragma unroll
    for (int u = t; u < G::BM * 8; u += G::THREADS) {
      const int r = u / 8, wq = u % 8;
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          stage + r * Storage<kInt4>::XROW + 4 * wq);
      const uint32_t lo = nibbles(v, 0), hi = nibbles(v, 1);
      uint2 out = make_uint2(__byte_perm(lo, hi, 0x5140),
                             __byte_perm(lo, hi, 0x7362));
      *reinterpret_cast<uint2*>(xc + r * kCodeRow + 8 * wq) = out;
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core products on one staged K step
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 codes as one bf16x2 word, ``lo`` in the low half (exact for
// integers up to 256 in magnitude).
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Integer storages: A fragments from ``xa`` (rows of ``kCodeRow`` bytes: the
// raw int8 stage, or the unpacked int4 codes), B from the transposed wt.
template <int TILE>
__device__ __forceinline__ void mma_step_int(
    const char* xa, const char* wt, int wm0, int wn0,
    int (&acc)[Geometry<TILE, kInt8>::MT][Geometry<TILE, kInt8>::NT][4]) {
  using G = Geometry<TILE, kInt8>;
  const int lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {              // two k32 halves of 64 codes
    uint32_t a[G::MT][4];
#pragma unroll
    for (int i = 0; i < G::MT; ++i) {
      const char* p = xa + (wm0 + 16 * i + g) * kCodeRow + 32 * kk + 4 * tg;
      a[i][0] = *reinterpret_cast<const uint32_t*>(p);
      a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kCodeRow);
      a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kCodeRow + 16);
    }
#pragma unroll
    for (int j = 0; j < G::NT; ++j) {
      const char* p = wt + (wn0 + 8 * j + g) * kCodeRow + 32 * kk + 4 * tg;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
      for (int i = 0; i < G::MT; ++i) mma_s8(acc[i][j], a[i], b0, b1);
    }
  }
}

// Float32 codes: fragments straight from the raw stage, rounded to bf16 on
// the way into registers.
template <int TILE>
__device__ __forceinline__ void mma_step_f32(
    const char* stage, int wm0, int wn0,
    float (&acc)[Geometry<TILE, kF32>::MT][Geometry<TILE, kF32>::NT][4]) {
  using G = Geometry<TILE, kF32>;
  constexpr int XP = Storage<kF32>::XROW / 4;   // floats per x row
  constexpr int WP = G::WROW / 4;               // floats per w row
  const float* sx = reinterpret_cast<const float*>(stage);
  const float* sw = reinterpret_cast<const float*>(stage + G::SX);
  const int lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {              // two k16 halves of 32 codes
    uint32_t a[G::MT][4];
#pragma unroll
    for (int i = 0; i < G::MT; ++i) {
      const float* p = sx + (wm0 + 16 * i + g) * XP + 16 * kk + 2 * tg;
      const float2 v0 = *reinterpret_cast<const float2*>(p);
      const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * XP);
      const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
      const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * XP + 8);
      a[i][0] = bf16x2(v0.x, v0.y);
      a[i][1] = bf16x2(v1.x, v1.y);
      a[i][2] = bf16x2(v2.x, v2.y);
      a[i][3] = bf16x2(v3.x, v3.y);
    }
#pragma unroll
    for (int j = 0; j < G::NT; ++j) {
      const float* p = sw + (16 * kk + 2 * tg) * WP + wn0 + 8 * j + g;
      const uint32_t b0 = bf16x2(p[0], p[WP]);
      const uint32_t b1 = bf16x2(p[8 * WP], p[9 * WP]);
#pragma unroll
      for (int i = 0; i < G::MT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
    }
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

// v rounded to TF32 as cvt.rna.tf32.f32 rounds a finite v (to nearest, ties
// away from zero), in two integer operations; codes are finite
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(__fsub_rn(v, __uint_as_float(hi)));
}

// Float32 codes in 3xTF32 (kF32x3): one staged K step of 32 codes as four
// k8 blocks into ``part`` (zeroed by the caller), the small terms first.
// Fragments (g = lane / 4, tg = lane % 4): A (16 x 8) a0 (g, tg), a1 (g+8,
// tg), a2 (g, tg+4), a3 (g+8, tg+4); B (8 x 8) b0 (k tg, n g), b1 (k tg+4,
// n g); C as the m16n8 map of FragCoords.
template <int TILE>
__device__ __forceinline__ void mma_step_f32x3(
    const char* stage, int wm0, int wn0,
    float (&part)[Geometry<TILE, kF32x3>::MT][Geometry<TILE, kF32x3>::NT][4]) {
  using G = Geometry<TILE, kF32x3>;
  constexpr int XP = Storage<kF32x3>::XROW / 4;  // floats per x row
  constexpr int WP = G::WROW / 4;                // floats per w row
  const float* sx = reinterpret_cast<const float*>(stage);
  const float* sw = reinterpret_cast<const float*>(stage + G::SX);
  const int lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {              // four k8 blocks of 32 codes
    uint32_t ah[G::MT][4], al[G::MT][4];
#pragma unroll
    for (int i = 0; i < G::MT; ++i) {
      const float* p = sx + (wm0 + 16 * i + g) * XP + 8 * kk + tg;
      split(p[0], ah[i][0], al[i][0]);
      split(p[8 * XP], ah[i][1], al[i][1]);
      split(p[4], ah[i][2], al[i][2]);
      split(p[8 * XP + 4], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < G::NT; ++j) {
      const float* p = sw + (8 * kk + tg) * WP + wn0 + 8 * j + g;
      uint32_t bh0, bl0, bh1, bl1;
      split(p[0], bh0, bl0);
      split(p[4 * WP], bh1, bl1);
#pragma unroll
      for (int i = 0; i < G::MT; ++i) {
        mma_tf32(part[i][j], al[i], bh0, bh1);
        mma_tf32(part[i][j], ah[i], bl0, bl1);
        mma_tf32(part[i][j], ah[i], bh0, bh1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The K walk
// ---------------------------------------------------------------------------
// The mma.sync m16n8 accumulator map: the warp's sub-tile origin (wm0, wn0)
// inside the CTA tile, the lane's group g and thread-in-group tg, and the
// tile row and column of accumulator r of fragment (i, j).
template <int TILE>
struct FragCoords {
  int wm0, wn0, g, tg;
  __device__ __forceinline__ FragCoords() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    wm0 = (warp / Tile<TILE>::WARPS_N) * (Tile<TILE>::BM / Tile<TILE>::WARPS_M);
    wn0 = (warp % Tile<TILE>::WARPS_N) * (Tile<TILE>::BN / Tile<TILE>::WARPS_N);
    g = lane / 4;
    tg = lane % 4;
  }
  __device__ __forceinline__ int row(int i, int r) const {
    return wm0 + 16 * i + g + 8 * (r / 2);
  }
  __device__ __forceinline__ int col(int j, int r) const {
    return wn0 + 8 * j + 2 * tg + (r % 2);
  }
};

// Accumulate the CTA's (BM x BN) tile at (m0, n0) of batch entry e over the
// whole K axis into this thread's fragments: acc[i][j][r] is output
// (FragCoords::row(i, r), FragCoords::col(j, r)) of the tile.
template <int TILE, int CODES>
__device__ __forceinline__ void integrate_tile(
    const TileArgs& a, int e, int m0, int n0, char* smem,
    typename AccType<CODES>::T (&acc)[Geometry<TILE, CODES>::MT]
                                     [Geometry<TILE, CODES>::NT][4]) {
  using G = Geometry<TILE, CODES>;
  using S = Storage<CODES>;
  const FragCoords<TILE> f;
  const int wm0 = f.wm0, wn0 = f.wn0;
  const char* xb = static_cast<const char*>(a.x)
                   + (a.shared_x ? 0 : (size_t)e * a.M * a.kb * S::EB);
  const char* wb = static_cast<const char*>(a.w)
                   + (size_t)e * a.kb * a.N * S::EB;
  char* wt = smem + G::STAGES * G::STAGE;
  char* xc = wt + G::WT;

#pragma unroll
  for (int i = 0; i < G::MT; ++i)
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int nk = (a.kb + S::KS - 1) / S::KS;
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < nk) load_stage<TILE, CODES>(a, xb, wb, m0, n0, s,
                                        smem + s * G::STAGE);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();
    // the stage read in step kt - 1 is free: refill it with step
    // kt + STAGES - 1
    const int pre = kt + G::STAGES - 1;
    if (pre < nk)
      load_stage<TILE, CODES>(a, xb, wb, m0, n0, pre,
                              smem + (pre % G::STAGES) * G::STAGE);
    cp_async_commit();
    const char* stage = smem + (kt % G::STAGES) * G::STAGE;
    if constexpr (CODES == kF32) {
      mma_step_f32<TILE>(stage, wm0, wn0, acc);
    } else if constexpr (CODES == kF32x3) {
      // the stage's sum on the tensor cores from zero, then one IEEE add
      float part[G::MT][G::NT][4];
#pragma unroll
      for (int i = 0; i < G::MT; ++i)
#pragma unroll
        for (int j = 0; j < G::NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) part[i][j][r] = 0.0f;
      mma_step_f32x3<TILE>(stage, wm0, wn0, part);
#pragma unroll
      for (int i = 0; i < G::MT; ++i)
#pragma unroll
        for (int j = 0; j < G::NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[i][j][r] = __fadd_rn(acc[i][j][r], part[i][j][r]);
    } else {
      convert_stage<TILE, CODES>(stage, wt, xc);
      __syncthreads();
      mma_step_int<TILE>(CODES == kInt8 ? stage : xc, wt, wm0, wn0, acc);
    }
  }
  cp_async_wait<0>();
}

// Allow a kernel's dynamic shared memory above the 48 KB default, once per
// kernel.
template <auto KERNEL>
inline cudaError_t allow_smem(int bytes) {
  static const cudaError_t err = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
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
