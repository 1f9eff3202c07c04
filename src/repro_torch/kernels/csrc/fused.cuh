// The fused base + LoRA delta kernels, templated on where W comes from:
// y[n] = x[n] @ W + scale[n] * (x[n] @ A[n]) @ B[n].
//
// fused.cu instantiates them for a dense W (row-major, or read as W^T in
// place for the backward's dx); fused_q.cu for a quantized W whose tiles are
// dequantized as they are staged. x (N, M, K), W (K, L) shared by all
// adapters, A (N, K, r), B (N, r, L), scale (N,) f32 (or null: 1), y
// (N, M, L); x, A, B, y contiguous row-major in one type (bf16 or f32),
// r <= 128. Rounding follows the Pallas kernel (src/repro/kernels/fused.py,
// _fused_kernel / _fused_kernel_q): the base and xA accumulate in f32, xA
// is never rounded, B is read as f32, and y is cast to the input type once,
// as base + scale * (xA @ B). A quantized W element is the f32 product
// code * scale rounded to the input type once, as _dequant_tile does.
//
// Design. The TPU grid ran one pass per adapter and so re-read the shared W
// once per adapter. Here the rows of all adapters are flattened (row g
// belongs to adapter g / M) and tiled together, so a staged W tile serves
// every adapter whose rows fall in the block.
//  * bf16, > 16 rows, K and L multiples of 8, operands 16-byte aligned (8
//    for int8/nf4 codes): fused_wgmma_kernel, one warp-specialised pass for
//    Hopper. Its 128-row tiles run over the flattened rows when each 64-row
//    slab lies inside one adapter (N == 1 or M % 64 == 0); otherwise (a
//    ragged pack) over each adapter's rows, as the Pallas grid does, ceil(M
//    / 128) tiles an adapter, the last one's rows past the adapter's end
//    computed and not stored. A 128 x BN
//    output tile per block, 64 deep per K step, through a ring of shared-
//    memory stages guarded by full/empty mbarriers. One producer warpgroup
//    fills the ring: TMA for the x tile, a dense W tile and the A tiles
//    (its threads write A where TMA cannot address it: r not a multiple of
//    8), and, for a quantized W, the dequantized tile from its threads. Two consumer warpgroups each run
//    wgmma m64nBNk16 on 64 rows (BN = 256 at r <= 16, else 128) and, on
//    the same x tile, m64nRPk16 against their adapter's A tile (RP = r
//    rounded up to 16, 32, 64 or 128; zero columns past r), so xA costs
//    RP / BN more tensor-core work. The
//    epilogue stages xA (f32) and the B tile in shared memory and writes
//    y = cast(base + scale * sum_q xA[q] * B[q]) (f32 FMAs in q order)
//    with 16-byte stores.
//  * bf16, at most 16 rows in all (decode's 8 rows of 8 adapters), K and L
//    multiples of 8, W row-major, x, W, A, B 16-byte aligned (8 for the
//    codes): decode.cuh's weight-streaming kernel, two launches (xA, then
//    the base and the epilogue in one pass over W).
//  * f32, > 16 rows, K and L multiples of 4, x, W (or the codes and
//    scales), A and B 16-byte aligned, W row-major or W^T: ffma.cuh's
//    tiled FFMA kernel, two launches (xA, then the base with the delta in
//    its epilogue; a third, fused_epilogue, only when K is split).
//  * Otherwise -- f32 or the backward's W^T at decode rows, odd shapes:
//    three launches: xA as f32 partial sums (tile.cuh's gemm_kernel over the
//    adapters, K split across blocks), the base product as f32 partials
//    (split K when the output tiles are few), and fused_epilogue, which adds
//    each quantity's ranges in a fixed order and writes
//    y = cast(base + scale * xA @ B) once. Same function, same rounding
//    points; x is read twice.
// When the wgmma kernel's output tiles are too few for the card, K is split
// into ranges whose f32 partials fused_epilogue adds in a fixed order
// (deterministic, no atomics). The path and the split plan depend only on
// shapes, dtype and alignment, never on how W is stored, and a dequantized
// tile holds exactly the values of the dense W = cast(dequantize(W)) in the
// dense tile's layout: so the quantized kernel is bit-equal to the dense one
// on the dequantized weight, as the Pallas kernel's contract requires
// (fused.py:37-46).
#pragma once

#include <type_traits>

#include "hopper.cuh"
#include "tile.cuh"

namespace plora {

constexpr int RMAX = 128;
constexpr int EPI_ROWS = 16;      // rows per block of the epilogue
constexpr int EPI_THREADS = 256;  // = columns per block of the epilogue

using bf16 = __nv_bfloat16;

// y = cast(sum of the base partials + scale * (sum of the xA partials) @ B),
// each sum over its K ranges in order. part_y [splits_y][rows][L],
// part_xa [splits_xa][rows][R].
template <typename T>
__global__ void __launch_bounds__(EPI_THREADS)
fused_epilogue(const float* __restrict__ part_y, const float* __restrict__ part_xa,
               const T* __restrict__ b, const float* __restrict__ scale, T* __restrict__ y,
               int M, int L, int R, int rows, int splits_y, int splits_xa) {
  __shared__ float xa[EPI_ROWS][RMAX];
  const int m0 = blockIdx.y * EPI_ROWS;
  for (int p = threadIdx.x; p < EPI_ROWS * R; p += EPI_THREADS) {
    const int r = p / R, j = p % R, g = m0 + r;
    float sum = 0.f;
    if (g < rows)
      for (int s = 0; s < splits_xa; ++s) sum += part_xa[((size_t)s * rows + g) * R + j];
    xa[r][j] = sum;
  }
  __syncthreads();
  const int gl = blockIdx.x * EPI_THREADS + threadIdx.x;
  if (gl >= L) return;
  for (int r = 0; r < EPI_ROWS && m0 + r < rows; ++r) {
    const int g = m0 + r, ad = g / M;
    float base = 0.f;
    for (int s = 0; s < splits_y; ++s) base += part_y[((size_t)s * rows + g) * L + gl];
    const T* bp = b + (size_t)ad * R * L;
    float d = 0.f;
    for (int q = 0; q < R; ++q) d = fmaf(xa[r][q], to_f32(bp[(size_t)q * L + gl]), d);
    y[(size_t)g * L + gl] = from_f32<T>(base + (scale ? scale[ad] : 1.f) * d);
  }
}

// ---------------------------------------------------------------------------
// The warp-specialised wgmma kernel: geometry
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128, WG_BK = 64;  // output rows per block, K per stage
constexpr int WG_THREADS = 384;         // producer warpgroup + 2 consumers
constexpr int NUM_SMS = 132;            // H100 SXM
constexpr int SMEM_OPTIN = 232448;      // shared memory a block may opt into
// quantized W: raw code tiles in flight, and how many K steps ahead they load
constexpr int RAW_STAGES = 3, RAW_AHEAD = 2;

// Shared-memory tiles, all 128-byte swizzled and 1024-byte aligned:
//  x    [128 rows][64 k]        K-major (TMA)
//  W    [BN/64 slabs][64 k][64] MN-major (TMA of the row-major W, or the
//                                dequantized tile), or
//       [BN rows][64 k]         K-major (TMA of W^T: dx)
//  A    2 x [RP/AW slabs][64 k][AW] MN-major, one per 64-row slab's
//                                adapter (TMA of A, or written by threads);
//                                AW = min(RP, 64) columns, swizzled over
//                                AW * 2 bytes (32, 64 or 128)
//
// The tile width for a padded rank: the base and xA accumulators (BN / 2 +
// RP / 2 f32 per consumer thread) must fit the 168 registers a thread of a
// 384-thread block gets; past RP = 16 at BN = 256 ptxas spills and
// serializes the wgmma instructions.
__host__ __device__ constexpr int wg_bn(int rp) { return rp <= 16 ? 256 : 128; }

template <int RP, int RAW = 0>  // RAW: bytes of one raw code tile (quantized W)
struct WgCfg {
  static constexpr int BN = wg_bn(RP);
  static constexpr int X_BYTES = WG_BM * WG_BK * 2;
  static constexpr int W_BYTES = BN * WG_BK * 2;
  static constexpr int A_BYTES = RP * WG_BK * 2;
  static constexpr int A_AW = RP < 64 ? RP : 64;                 // columns per A slab
  static constexpr int A_RB = A_AW * 2;                          // bytes per k row of a slab
  static constexpr int A_LBO = WG_BK * A_RB, A_SBO = 8 * A_RB;   // descriptor strides
  static constexpr int A_LAYOUT = A_RB == 128 ? 1 : A_RB == 64 ? 2 : 3;
  static constexpr int STAGE = X_BYTES + W_BYTES + 2 * A_BYTES;
  static constexpr int HEADER = 1024;  // mbarriers, the nf4 codebook
  static constexpr int RAW_RING = RAW_STAGES * RAW;
  static constexpr int RING_MAX = SMEM_OPTIN - 1024 - HEADER - RAW_RING;  // 1024: alignment
  static constexpr int STAGES = RING_MAX / STAGE < 4 ? RING_MAX / STAGE : 4;
  static constexpr int SMEM = 1024 + HEADER + STAGES * STAGE + RAW_RING;
  // epilogue, per consumer warpgroup, over the ring: xA f32, B bf16, y bf16
  static constexpr int XA_LD = RP + 4;  // row strides padded against bank conflicts
  static constexpr int YS_LD = BN + 8;
  static constexpr int XA_BYTES = 64 * XA_LD * 4;
  static constexpr int B_BYTES = RP * BN * 2;
  static constexpr int EPI = (XA_BYTES + B_BYTES + 64 * YS_LD * 2 + 1023) / 1024 * 1024;
  static_assert(STAGES >= 3, "too few pipeline stages");
  static_assert(STAGE % 1024 == 0 && A_BYTES % 1024 == 0, "tiles must stay 1024-byte aligned");
  static_assert(2 * EPI <= STAGES * STAGE, "the epilogue must fit over the ring");
};

// How the kernel obtains a W tile, and the register split between the
// producer warpgroup and the two consumers. The block holds 168 registers a
// thread from launch (384 threads, 1 block per SM); setmaxnreg.inc waits
// until the producer's setmaxnreg.dec has freed enough, so the split must
// fit that pool or the consumers wait forever.
constexpr int WG_REG_POOL = 168 * WG_THREADS;
template <class WS>
struct WgSource;
template <bool TRANS>
struct WgSource<Dense<bf16, TRANS>> {
  static constexpr bool TMA = true, KMAJOR = TRANS;
  static constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
};
template <>
struct WgSource<Int8W<bf16>> {
  static constexpr bool TMA = false, KMAJOR = false;
  static constexpr int PRODUCER_REGS = 112, CONSUMER_REGS = 192;
};
template <>
struct WgSource<Nf4W<bf16>> {
  static constexpr bool TMA = false, KMAJOR = false;
  static constexpr int PRODUCER_REGS = 112, CONSUMER_REGS = 192;
};

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// byte offset of the 16-byte unit `unit` of row `row` in a 128-byte-swizzled
// tile of 128-byte rows (the TMA's SWIZZLE_128B and wgmma's layout type 1)
__device__ __forceinline__ int sw128(int row, int unit) {
  return row * 128 + ((unit ^ (row & 7)) << 4);
}

// A[ad] rows [k0, k0 + 64) (one contiguous span of the (K x R) row-major
// matrix) into the A tile's layout (the one a TMA load gives), by the
// producer's threads: for ranks whose rows TMA cannot address (R not a
// multiple of 8) or an A not 16-byte aligned. Columns q >= R stay as zeroed
// at the start; k >= ke is written as 0.
template <class C>
__device__ __forceinline__ void stage_a(unsigned char* at, const bf16* __restrict__ a, int ad,
                                        int K, int R, int k0, int ke, int t) {
  const bf16* src = a + ((size_t)ad * K + k0) * R;
  const int nk = min(WG_BK, ke - k0);
  for (int e = t; e < WG_BK * R; e += 128) {
    const int kk = e / R, q = e % R, qa = q % C::A_AW;
    const int unit = (qa >> 3) ^ (((kk * C::A_RB) >> 7) & (C::A_RB / 16 - 1));
    *reinterpret_cast<bf16*>(at + (q / C::A_AW) * C::A_LBO + kk * C::A_RB + unit * 16 +
                             (qa & 7) * 2) = kk < nk ? src[e] : __ushort_as_bfloat16(0);
  }
}

// 8 columns of one k row: int8 codes (byte j = column j) times their
// scales. A code c becomes the f32 c exactly without a conversion
// instruction: the bits 0x4B0000uu, u = c + 128, are the float 2^23 + u.
__device__ __forceinline__ uint4 deq_int8(uint2 u, const float (&s)[8]) {
  const uint32_t w0 = u.x ^ 0x80808080u, w1 = u.y ^ 0x80808080u;
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float c = __fsub_rn(__uint_as_float(__byte_perm(j < 4 ? w0 : w1, 0x4B000000u,
                                                          0x7540 + (j & 3))),
                              8388736.f);  // 2^23 + 128
    v[j] = __fmul_rn(c, s[j]);
  }
  return make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]),
                    bf16x2(v[6], v[7]));
}

// 8 columns of one k row from nf4 codes (byte j = column j; `shift` 0: the
// low nibble, the even row; 4: the odd row), codebook `cb` in shared memory
// (16 entries in 16 banks: a warp's lookups never conflict)
__device__ __forceinline__ uint4 deq_nf4(uint2 u, int shift, const float* cb,
                                         const float (&s)[8]) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = __fmul_rn(cb[((j < 4 ? u.x : u.y) >> (8 * (j & 3) + shift)) & 15], s[j]);
  return make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]),
                    bf16x2(v[6], v[7]));
}

__device__ __forceinline__ void load_f8(const float* p, float (&s)[8]) {
  const float4 s0 = *reinterpret_cast<const float4*>(p);
  const float4 s1 = *reinterpret_cast<const float4*>(p + 4);
  s[0] = s0.x; s[1] = s0.y; s[2] = s0.z; s[3] = s0.w;
  s[4] = s1.x; s[5] = s1.y; s[6] = s1.z; s[7] = s1.w;
}

}  // namespace plora

#include "decode.cuh"  // PATH_DECODE's kernel: uses deq_int8, deq_nf4 and load_f8 above
#include "ffma.cuh"    // PATH_FFMA's kernel: uses decode.cuh's cp.async helpers

namespace plora {

// The producer's dequantizing stage of a quantized W. The codes of a K step
// (64 rows x BN bytes for int8, 32 x BN for nf4's two rows a byte) arrive
// by TMA in a ring of RAW_STAGES raw tiles, RAW_AHEAD steps ahead of the
// step being dequantized; where TMA cannot address them (L not a multiple of
// 16, codes not 16-byte aligned) the threads load them from global memory.
// Each of the 128 threads owns 8 columns (one 16-byte unit) and NP pairs of
// k rows, and writes cast(code * scale) into the MN-major swizzled layout
// the dense TMA load produces.
template <class WS, int BN>
struct QStage {
  static constexpr int CH = BN / 8, G = 128 / CH, NP = 32 / G;
  static constexpr bool NF4 = std::is_same<WS, Nf4W<bf16>>::value;
  static constexpr int RAW_ROWS = NF4 ? WG_BK / 2 : WG_BK, RAW_BYTES = RAW_ROWS * BN;

  // the codes of rows k, k + 1 (k = k0 + kk) of the thread's 8 columns
  static __device__ __forceinline__ void codes(const WS& w, const unsigned char* raw, bool tma,
                                               int kk, int k, int ke, int col, bool col_ok,
                                               int c8, uint2& lo, uint2& hi) {
    const uint2 zero = make_uint2(0, 0);
    if constexpr (NF4) {  // K is even: both rows of a byte lie inside the range
      lo = tma ? *reinterpret_cast<const uint2*>(raw + (kk >> 1) * BN + c8 * 8)
               : (col_ok && k < ke)
                     ? *reinterpret_cast<const uint2*>(w.codes + (size_t)(k >> 1) * w.ld + col)
                     : zero;
    } else {
      const uint8_t* p = reinterpret_cast<const uint8_t*>(w.codes) + (size_t)k * w.ld + col;
      lo = tma ? *reinterpret_cast<const uint2*>(raw + kk * BN + c8 * 8)
               : (col_ok && k < ke) ? *reinterpret_cast<const uint2*>(p) : zero;
      hi = tma ? *reinterpret_cast<const uint2*>(raw + (kk + 1) * BN + c8 * 8)
               : (col_ok && k + 1 < ke) ? *reinterpret_cast<const uint2*>(p + w.ld) : zero;
    }
  }

  // s8: int8's per-column scales of this thread's columns; cb: nf4 codebook
  static __device__ __forceinline__ void store(unsigned char* ws, const WS& w,
                                               const unsigned char* raw, bool tma,
                                               const float* cb, const float (&s8)[8], int col,
                                               bool col_ok, int k0, int ke, int rg, int c8) {
    const uint4 zero = make_uint4(0, 0, 0, 0);
    unsigned char* slab = ws + (c8 >> 3) * (WG_BK * 128);
    float sb[8];  // nf4: the scale row of a block that covers the whole step
    bool whole = false;
    if constexpr (NF4) {
      whole = w.blk % WG_BK == 0;
      if (whole && col_ok) load_f8(w.scales + (size_t)(k0 / w.blk) * w.ld + col, sb);
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int kk = 2 * (rg + G * i), k = k0 + kk;
      uint2 lo, hi;
      codes(w, raw, tma, kk, k, ke, col, col_ok, c8, lo, hi);
      uint4 v0 = zero, v1 = zero;
      if constexpr (NF4) {
        if (col_ok && k < ke) {
          if (whole) {
            v0 = deq_nf4(lo, 0, cb, sb);
            v1 = deq_nf4(lo, 4, cb, sb);
          } else {
            float sc[8];
            load_f8(w.scales + (size_t)(k / w.blk) * w.ld + col, sc);
            v0 = deq_nf4(lo, 0, cb, sc);
            load_f8(w.scales + (size_t)((k + 1) / w.blk) * w.ld + col, sc);
            v1 = deq_nf4(lo, 4, cb, sc);
          }
        }
      } else {
        if (col_ok && k < ke) v0 = deq_int8(lo, s8);
        if (col_ok && k + 1 < ke) v1 = deq_int8(hi, s8);
      }
      *reinterpret_cast<uint4*>(slab + sw128(kk, c8 & 7)) = v0;
      *reinterpret_cast<uint4*>(slab + sw128(kk + 1, c8 & 7)) = v1;
    }
  }
};

template <class WS, int RP>
using WgKernelCfg = WgCfg<RP, WgSource<WS>::TMA ? 0 : QStage<WS, wg_bn(RP)>::RAW_BYTES>;

// ---------------------------------------------------------------------------
// The kernel. Grid (row tiles, column tiles, K ranges): blockIdx.x walks the
// 128-row tiles, so the blocks in flight share W's column tiles in L2 and
// W is read from device memory about once. Block z covers K steps
// [z * steps, (z + 1) * steps); with part_y it writes f32 partials
// (part_y [z][rows][L], and part_xa [z][rows][R] from column tile 0) for
// fused_epilogue, else y.
//
// Row tiles: with tpa == 0 (flat), tile x holds rows [128 x, 128 x + 128)
// of all adapters, each 64-row slab inside one adapter. With tpa > 0 (a
// ragged pack: N > 1, M % 64 != 0), tile x holds rows [128 i, 128 i + 128)
// of adapter x / tpa, i = x % tpa: one adapter, one A tile. Its x rows past
// the adapter's end are loaded through the same map as the flat tiles --
// the next adapter's rows, or TMA's zeros past the last row -- so every
// load stays a whole 128 x 64 box; they are multiplied and never stored.
// ---------------------------------------------------------------------------

template <class WS, int RP>
__global__ void __launch_bounds__(WG_THREADS, 1)
fused_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w, const WS w,
                   const __grid_constant__ CUtensorMap tm_a, const bf16* __restrict__ a,
                   const bf16* __restrict__ b,
                   const float* __restrict__ scale, bf16* __restrict__ y,
                   float* __restrict__ part_y, float* __restrict__ part_xa, int N, int M, int K,
                   int L, int R, int rows, int steps, int tpa, int a_by_tma, int q_by_tma) {
  using S = WgSource<WS>;
  using Q = QStage<WS, wg_bn(RP)>;
  using C = WgKernelCfg<WS, RP>;
  static_assert(128 * S::PRODUCER_REGS + 256 * S::CONSUMER_REGS <= WG_REG_POOL,
                "the register split must fit the block's pool");
  constexpr int BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + C::STAGES;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem + 128);  // RAW_STAGES
  float* cb = reinterpret_cast<float*>(smem + 256);
  unsigned char* ring = smem + C::HEADER;
  unsigned char* raw_ring = ring + C::STAGES * C::STAGE;

  const int l0 = blockIdx.y * BN, z = blockIdx.z;
  const int kb = z * steps * WG_BK, ke = min(K, kb + steps * WG_BK);
  const int nsteps = (ke - kb + WG_BK - 1) / WG_BK;
  const int ad_t = tpa ? blockIdx.x / tpa : 0;  // a ragged tile's adapter
  const int m0 = tpa ? ad_t * M + (blockIdx.x % tpa) * WG_BM : blockIdx.x * WG_BM;
  // the two slabs' adapters, and the end of the rows the block stores
  const int ad0 = tpa ? ad_t : m0 / M, ad1 = tpa ? ad_t : min((m0 + 64) / M, N - 1);
  const int g_end = tpa ? (ad_t + 1) * M : rows;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  for (int st = 0; st < C::STAGES; ++st)  // A columns q >= R are read as zeros
    for (int i = threadIdx.x; i < 2 * C::A_BYTES / 16; i += WG_THREADS)
      reinterpret_cast<uint4*>(ring + st * C::STAGE + C::X_BYTES + C::W_BYTES)[i] =
          make_uint4(0, 0, 0, 0);
  if (threadIdx.x < 16) cb[threadIdx.x] = NF4_CODEBOOK[threadIdx.x];
  if (threadIdx.x == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(&full[st], 2);   // the TMA issuer's arrival + the staged tiles'
      mbar_init(&empty[st], 8);  // one per consumer warp
    }
    for (int st = 0; st < RAW_STAGES; ++st) mbar_init(&raw_full[st], 1);
    fence_barrier_init();
  }
  fence_proxy_async();
  __syncthreads();

  if (wg == 0) {
    // ---- producer --------------------------------------------------------
    reg_dealloc<S::PRODUCER_REGS>();
    constexpr int CH = BN / 8;
    const int c8 = t % CH, rg = t / CH, col = l0 + c8 * 8;
    const bool col_ok = col < L;
    float s8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if constexpr (!S::TMA) {
      if constexpr (!Q::NF4)
        if (col_ok) load_f8(w.scales + col, s8);
      if (q_by_tma && t == 0)
        for (int d = 0; d < RAW_AHEAD && d < nsteps; ++d) {
          mbar_arrive_expect_tx(&raw_full[d], Q::RAW_BYTES);
          tma_load_2d(raw_ring + d * Q::RAW_BYTES, &tm_w, &raw_full[d], l0,
                      (kb + d * WG_BK) / (Q::NF4 ? 2 : 1));
        }
    }
    for (int it = 0; it < nsteps; ++it) {
      const int st = it % C::STAGES, k0 = kb + it * WG_BK;
      unsigned char* xs = ring + st * C::STAGE;
      unsigned char* ws = xs + C::X_BYTES;
      unsigned char* as = ws + C::W_BYTES;
      mbar_wait(&empty[st], ((it / C::STAGES) & 1) ^ 1);
      if (t == 0) {
        const int a_tiles = a_by_tma ? (ad1 != ad0 ? 2 : 1) : 0;
        mbar_arrive_expect_tx(&full[st],
                              C::X_BYTES + (S::TMA ? C::W_BYTES : 0) + a_tiles * C::A_BYTES);
        tma_load_2d(xs, &tm_x, &full[st], k0, m0);
        for (int u = 0; u < a_tiles; ++u)
#pragma unroll
          for (int j = 0; j < RP / C::A_AW; ++j)
            tma_load_3d(as + u * C::A_BYTES + j * C::A_LBO, &tm_a, &full[st], j * C::A_AW, k0,
                        u ? ad1 : ad0);
        if constexpr (!S::TMA) {  // raw codes RAW_AHEAD steps on, into a tile read at it - 1
          const int ahead = it + RAW_AHEAD, rs = ahead % RAW_STAGES;
          if (q_by_tma && ahead < nsteps) {
            mbar_arrive_expect_tx(&raw_full[rs], Q::RAW_BYTES);
            tma_load_2d(raw_ring + rs * Q::RAW_BYTES, &tm_w, &raw_full[rs], l0,
                        (k0 + RAW_AHEAD * WG_BK) / (Q::NF4 ? 2 : 1));
          }
        }
        if constexpr (S::TMA) {
          if constexpr (S::KMAJOR) {
            tma_load_2d(ws, &tm_w, &full[st], k0, l0);
          } else {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_2d(ws + j * (WG_BK * 128), &tm_w, &full[st], l0 + 64 * j, k0);
          }
        }
      }
      if (!a_by_tma) {
        stage_a<C>(as, a, ad0, K, R, k0, ke, t);
        if (ad1 != ad0) stage_a<C>(as + C::A_BYTES, a, ad1, K, R, k0, ke, t);
      }
      if constexpr (!S::TMA) {
        const int rs = it % RAW_STAGES;
        if (q_by_tma) mbar_wait(&raw_full[rs], (it / RAW_STAGES) & 1);
        Q::store(ws, w, raw_ring + rs * Q::RAW_BYTES, q_by_tma, cb, s8, col, col_ok, k0, ke, rg,
                 c8);
      }
      fence_proxy_async();
      named_barrier(1, 128);
      if (t == 0) mbar_arrive(&full[st]);
    }
    return;
  }

  // ---- consumers: 64 rows each -------------------------------------------
  reg_alloc<S::CONSUMER_REGS>();
  const int cw = wg - 1, lane = threadIdx.x % 32, warp = t / 32;
  const int a_off = C::X_BYTES + C::W_BYTES + (cw == 1 && ad1 != ad0 ? C::A_BYTES : 0);
  float acc[BN / 2], xacc[RP / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < RP / 2; ++i) xacc[i] = 0.f;
  fence_regs(acc);
  fence_regs(xacc);
  for (int it = 0; it < nsteps; ++it) {
    const int st = it % C::STAGES;
    mbar_wait(&full[st], (it / C::STAGES) & 1);
    const unsigned char* xs = ring + st * C::STAGE + cw * (64 * 128);
    const unsigned char* ws = ring + st * C::STAGE + C::X_BYTES;
    const unsigned char* as = ring + st * C::STAGE + a_off;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      const uint64_t da = smem_desc(xs + kk * 32, 16, 1024, 1);
      const uint64_t dw = S::KMAJOR ? smem_desc(ws + kk * 32, 16, 1024, 1)
                                    : smem_desc(ws + kk * 16 * 128, WG_BK * 128, 1024, 1);
      wgmma<BN, S::KMAJOR ? 0 : 1>(acc, da, dw);
      wgmma<RP, 1>(xacc, da, smem_desc(as + kk * 16 * C::A_RB, C::A_LBO, C::A_SBO, C::A_LAYOUT));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done with its stage
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % C::STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(xacc);

  // ---- epilogue ------------------------------------------------------------
  named_barrier(2, 256);  // both consumers are done with the ring
  fence_proxy_async();
  unsigned char* ep = ring + cw * C::EPI;
  float* xa_s = reinterpret_cast<float*>(ep);
  bf16* bs = reinterpret_cast<bf16*>(ep + C::XA_BYTES);
  bf16* ys = reinterpret_cast<bf16*>(ep + C::XA_BYTES + C::B_BYTES);
  const int r0 = warp * 16 + lane / 4, ct = 2 * (lane % 4);  // rows r0, r0 + 8
  const int g0 = m0 + 64 * cw, ad = cw ? ad1 : ad0;
#pragma unroll
  for (int j = 0; j < RP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xa_s[(r0 + 8 * (i / 2)) * C::XA_LD + 8 * j + ct + (i % 2)] = xacc[4 * j + i];
  named_barrier(3 + cw, 128);

  if (part_y) {  // K split: f32 partials, fused_epilogue finishes
    if (blockIdx.y == 0)
      for (int p = t; p < 64 * R; p += 128) {
        const int r = p / R, qq = p % R, g = g0 + r;
        if (g < g_end) part_xa[((size_t)z * rows + g) * R + qq] = xa_s[r * C::XA_LD + qq];
      }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = g0 + r0 + 8 * h, gl = l0 + 8 * j + ct;
        if (g < g_end && gl < L)
          *reinterpret_cast<float2*>(part_y + ((size_t)z * rows + g) * L + gl) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    return;
  }

  // the B tile of the slab's adapter: rows q < R, columns [l0, l0 + BN)
  const bf16* bp = b + (size_t)ad * R * L + l0;
  if ((reinterpret_cast<uintptr_t>(b) & 15) == 0) {
    for (int p = t; p < R * (BN / 8); p += 128) {
      const int qq = p / (BN / 8), c = (p % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(bs + qq * BN + c) =
          l0 + c < L ? *reinterpret_cast<const uint4*>(bp + (size_t)qq * L + c)
                     : make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int p = t; p < R * BN; p += 128) {
      const int qq = p / BN, c = p % BN;
      bs[qq * BN + c] = l0 + c < L ? bp[(size_t)qq * L + c] : __ushort_as_bfloat16(0);
    }
  }
  named_barrier(3 + cw, 128);

  const float sc = scale ? scale[ad] : 1.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
    for (int q0 = 0; q0 < R; q0 += 16) {
      float x0[16], x1[16];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 v0 = *reinterpret_cast<const float4*>(xa_s + r0 * C::XA_LD + q0 + 4 * u);
        const float4 v1 =
            *reinterpret_cast<const float4*>(xa_s + (r0 + 8) * C::XA_LD + q0 + 4 * u);
        x0[4 * u] = v0.x; x0[4 * u + 1] = v0.y; x0[4 * u + 2] = v0.z; x0[4 * u + 3] = v0.w;
        x1[4 * u] = v1.x; x1[4 * u + 1] = v1.y; x1[4 * u + 2] = v1.z; x1[4 * u + 3] = v1.w;
      }
#pragma unroll
      for (int qq = 0; qq < 16; ++qq) {
        if (q0 + qq < R) {
          const __nv_bfloat162 bv =
              *reinterpret_cast<const __nv_bfloat162*>(bs + (q0 + qq) * BN + 8 * j + ct);
          const float b0 = __low2float(bv), b1 = __high2float(bv);
          d0 = fmaf(x0[qq], b0, d0);
          d1 = fmaf(x0[qq], b1, d1);
          d2 = fmaf(x1[qq], b0, d2);
          d3 = fmaf(x1[qq], b1, d3);
        }
      }
    }
    *reinterpret_cast<uint32_t*>(ys + r0 * C::YS_LD + 8 * j + ct) =
        bf16x2(fmaf(sc, d0, acc[4 * j]), fmaf(sc, d1, acc[4 * j + 1]));
    *reinterpret_cast<uint32_t*>(ys + (r0 + 8) * C::YS_LD + 8 * j + ct) =
        bf16x2(fmaf(sc, d2, acc[4 * j + 2]), fmaf(sc, d3, acc[4 * j + 3]));
  }
  named_barrier(3 + cw, 128);
  for (int p = t; p < 64 * (BN / 8); p += 128) {
    const int r = p / (BN / 8), c = (p % (BN / 8)) * 8, g = g0 + r;
    if (g < g_end && l0 + c < L)
      *reinterpret_cast<uint4*>(y + (size_t)g * L + l0 + c) =
          *reinterpret_cast<const uint4*>(ys + r * C::YS_LD + c);
  }
}

// ---------------------------------------------------------------------------
// Plan and launch
// ---------------------------------------------------------------------------

enum { PATH_SPLIT3 = 0, PATH_WGMMA = 1, PATH_DECODE = 2, PATH_FFMA = 3 };

// Whether a call takes the wgmma path (see fused_wgmma_kernel).
// `aligned`: x and every W array can be read with the kernel's TMA and
// vector loads.
inline bool use_wgmma(bool aligned, int dtype, int n, int m, int k, int l) {
  return dtype == 1 && n * m > ThinTile::BM && k % 8 == 0 && l % 8 == 0 && aligned;
}

// The wgmma kernel's row tiles per adapter (its `tpa`): 0 where the flat
// tiles keep each 64-row slab inside one adapter, else ceil(M / 128).
inline int wg_tpa(int n, int m) { return n > 1 && m % 64 != 0 ? (m + WG_BM - 1) / WG_BM : 0; }

// The wgmma kernel's row tiles in all (grid.x).
inline int wg_row_tiles(int n, int m) {
  const int tpa = wg_tpa(n, m);
  return tpa ? n * tpa : (n * m + WG_BM - 1) / WG_BM;
}

// Whether a call takes the decode path (decode.cuh): bf16, at most 16 rows
// in all, K and L multiples of 8, W row-major (not the backward's W^T), A
// and B 16-byte aligned, and read by vector loads.
inline bool use_decode(bool aligned, bool ab_aligned, bool trans_w, int dtype, int n, int m,
                       int k, int l) {
  return dtype == 1 && n * m <= DEC_MAX_ROWS && k % 8 == 0 && l % 8 == 0 && aligned &&
         ab_aligned && !trans_w;
}

inline bool aligned_to(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

inline int rank_pad(int r) { return r <= 16 ? 16 : r <= 32 ? 32 : r <= 64 ? 64 : 128; }

// One block per SM: split K only when the output tiles leave SMs idle,
// keeping at least 4 K steps per range. `splits` > 0 asks for that many
// ranges instead (the autotuner's candidate), clamped by the same rule.
inline SplitK plan_wgmma(int row_tiles, int k, int l, int bn, int splits) {
  const int ksteps = (k + WG_BK - 1) / WG_BK;
  if (splits > 0) return k_ranges(ksteps, splits, MAX_SPLITS);
  const int tiles = row_tiles * ((l + bn - 1) / bn);
  return k_ranges(ksteps, tiles >= NUM_SMS ? 1 : NUM_SMS / tiles, MAX_SPLITS);
}

// The plan of a call: its path, the wgmma kernel's padded rank and tile
// width, the K ranges of the base product and of xA, and the f32 workspace
// (elements) for their partial sums (0: none needed; on the ffma path the
// base's partials only when K is split, then xA's). On the decode path:
// rp, bn, splits_y and steps are the main kernel's rows (RM), column threads,
// K ranges and row pairs per range, xa_* and splits_xa the xA pass's, and
// the workspace is xA itself (rows x r f32).
struct Plan {
  int path, rp, bn, splits_y, splits_xa, steps;
  long long workspace;
  int xa_rm, xa_ct, xa_pairs;
};

// `aligned`: x and W can be read by the kernels' TMA and vector loads;
// `ab_aligned`: A and B start on 16 bytes; `trans_w`: W is the backward's
// W^T, read in place; `splits` > 0: the K ranges the wgmma and ffma paths
// take in place of their plan's choice (clamped as the plan clamps; the
// decode and split3 paths keep their plans), 0: the plan's choice.
inline Plan make_plan(bool aligned, bool ab_aligned, bool trans_w, int dtype, int n, int m, int k,
                      int l, int r, int splits = 0) {
  const int rows = n * m;
  if (use_decode(aligned, ab_aligned, trans_w, dtype, n, m, k, l)) {
    const DecodeGeom g = decode_geom(k, l, 1, 4, 32, DEC_SLOTS);
    // the xA pass takes what the main kernel's blocks leave of the card
    // (its blocks hold two thirds of the main kernel's shared memory)
    const long long left = 2 * (DEC_SLOTS - g.blocks);
    const DecodeGeom ga = decode_geom(k, r, n, dec_xa_ct(r), dec_xa_ct(r), left > n ? left : n);
    return {PATH_DECODE, dec_rm(rows), g.ct, g.splits, ga.splits, g.pairs,
            (long long)rows * r, dec_rm(m), ga.ct, ga.pairs};
  }
  if (use_wgmma(aligned, dtype, n, m, k, l)) {
    const int rp = rank_pad(r), bn = wg_bn(rp);
    const SplitK sk = plan_wgmma(wg_row_tiles(n, m), k, l, bn, splits);
    return {PATH_WGMMA, rp, bn, sk.splits, sk.splits, sk.steps,
            sk.splits > 1 ? (long long)sk.splits * rows * (l + r) : 0, 0, 0, 0};
  }
  if (use_ffma(aligned, ab_aligned, dtype, n, m, k, l)) {
    const SplitK sk = plan_ffma(rows, k, l, splits);
    const int sx = gemm_plan_for(n, m, k, r).splits;
    return {PATH_FFMA, 0, 0, sk.splits, sx, sk.steps,
            (sk.splits > 1 ? (long long)sk.splits * rows * l : 0) + (long long)sx * rows * r,
            0, 0, 0};
  }
  const int sy = gemm_plan_for(1, rows, k, l).splits, sx = gemm_plan_for(n, m, k, r).splits;
  return {PATH_SPLIT3, 0, 0, sy, sx, 0, (long long)sy * rows * l + (long long)sx * rows * r,
          0, 0, 0};
}

inline int check_sizes(int n, int m, int k, int l, int r) {
  if (n <= 0 || m <= 0 || k <= 0 || l <= 0 || r <= 0 || r > RMAX) return (int)cudaErrorInvalidValue;
  if ((long long)n * m > 65535LL * EPI_ROWS) return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
inline void launch_epilogue(const float* part_y, const float* part_xa, const void* b,
                            const float* scale, void* y, int m, int l, int r, int rows,
                            int splits_y, int splits_xa, cudaStream_t stream) {
  const dim3 grid((l + EPI_THREADS - 1) / EPI_THREADS, (rows + EPI_ROWS - 1) / EPI_ROWS);
  fused_epilogue<T><<<grid, EPI_THREADS, 0, stream>>>(part_y, part_xa, static_cast<const T*>(b),
                                                      scale, static_cast<T*>(y), m, l, r, rows,
                                                      splits_y, splits_xa);
}

// --- TMA descriptors, encoded on the host ----------------------------------

// cuTensorMapEncodeTiled, taken from the driver through the runtime so that
// the library needs no link to libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A 2-D map over a row-major (outer x inner) array of `elem`-byte elements,
// in boxes of box_outer x box_inner; out-of-range elements load as 0.
inline int encode_2d(CUtensorMap* map, const void* p, CUtensorMapDataType type, int elem,
                     uint64_t inner, uint64_t outer, uint32_t box_inner, uint32_t box_outer,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return ERR_TENSOR_MAP;
  const cuuint64_t dims[2] = {inner, outer}, strides[1] = {inner * elem};
  const cuuint32_t box[2] = {box_inner, box_outer}, one[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(p), dims, strides, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

// bf16, 128-byte swizzled boxes of box_outer x 64
inline int encode_bf16(CUtensorMap* map, const void* p, uint64_t inner, uint64_t outer,
                       uint32_t box_outer) {
  return encode_2d(map, p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, inner, outer, WG_BK, box_outer,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

// A's map: (N x K x R) in boxes of AW ranks x 64 k x 1 adapter, swizzled
// over AW * 2 bytes; ranks past R load as 0. Needs R a multiple of 8 (row
// strides of 16 bytes) and A 16-byte aligned: `a_tma`.
inline bool a_tma(const void* a, int r) { return r % 8 == 0 && aligned_to(a, 16); }

inline int encode_a(CUtensorMap* map, const void* a, int n, int k, int r, int rp) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return ERR_TENSOR_MAP;
  const uint32_t aw = rp < 64 ? rp : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)r, (cuuint64_t)k, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)r * 2, (cuuint64_t)k * r * 2};
  const cuuint32_t box[3] = {aw, WG_BK, 1}, elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = aw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : aw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(a), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)res;
}

// W's map: (K x L) row-major in boxes of 64 k x 64 columns; W^T read from
// W stored (L x K) in boxes of BN columns x 64 k; a quantized W's raw codes
// (uint8, K or K/2 rows of L) in boxes of one K step x BN, where TMA can
// address them (`q_tma`), else none.
inline int w_map(CUtensorMap* map, const Dense<bf16, false>& w, int k, int l, int) {
  return encode_bf16(map, w.p, l, k, 64);
}
inline int w_map(CUtensorMap* map, const Dense<bf16, true>& w, int k, int l, int bn) {
  return encode_bf16(map, w.p, k, l, bn);
}
inline bool q_tma(const void* codes, int l) { return l % 16 == 0 && aligned_to(codes, 16); }
template <class WS>
inline const void* w_codes(const WS& w) {
  if constexpr (WgSource<WS>::TMA) return nullptr;
  else return w.codes;
}
template <class WS>
inline int w_map(CUtensorMap* map, const WS& w, int k, int l, int bn) {
  *map = CUtensorMap{};
  if (!q_tma(w.codes, l)) return 0;
  const bool nf4 = QStage<WS, 256>::NF4;  // two k rows a byte
  return encode_2d(map, w.codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, l, nf4 ? k / 2 : k, bn,
                   nf4 ? WG_BK / 2 : WG_BK, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <class WS, int RP>
inline int launch_wgmma(const Plan& pl, const CUtensorMap& tx, const CUtensorMap& tw,
                        const CUtensorMap& ta, const WS& w, const void* a, const void* b, const float* scale, void* y,
                        float* part_y, float* part_xa, int n, int m, int k, int l, int r,
                        cudaStream_t stream) {
  using C = WgKernelCfg<WS, RP>;
  auto kernel = fused_wgmma_kernel<WS, RP>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(wg_row_tiles(n, m), (l + C::BN - 1) / C::BN, pl.splits_y);
  kernel<<<grid, WG_THREADS, C::SMEM, stream>>>(
      tx, tw, w, ta, static_cast<const bf16*>(a), static_cast<const bf16*>(b), scale,
      static_cast<bf16*>(y), part_y, part_xa, n, m, k, l, r, n * m, pl.steps, wg_tpa(n, m),
      a_tma(a, r),
      WgSource<WS>::TMA ? 0 : (int)q_tma(w_codes(w), l));
  return (int)cudaGetLastError();
}

// The decode path's two launches (decode.cuh): xA of every adapter into
// `xa` (rows x r f32), then the weight-streaming kernel.
template <class WS>
inline int launch_decode(const Plan& pl, const void* x, const WS& w, const void* a, const void* b,
                         const float* scale, void* y, float* xa, int n, int m, int k, int l,
                         int r, cudaStream_t stream) {
  using S = typename DecodeSource<WS>::type;
  const bf16* xb = static_cast<const bf16*>(x);
  const DecA as{static_cast<const bf16*>(a), r, (int)(r % 8 == 0 && aligned_to(a, 16)),
                (long long)k * r};
  const dim3 xa_grid(1, n, pl.splits_xa);
  cudaError_t e = pl.xa_rm <= 8
      ? launch_xa_ct<8>(pl.xa_ct, xa_grid, xb, as, xa, m, k, r, pl.xa_pairs, stream)
      : launch_xa_ct<16>(pl.xa_ct, xa_grid, xb, as, xa, m, k, r, pl.xa_pairs, stream);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((l + 8 * pl.bn - 1) / (8 * pl.bn), 1, pl.splits_y);
  const S ws = DecodeSource<WS>::make(w);
  e = pl.rp <= 8 ? launch_main_ct<S, 8>(pl.bn, grid, xb, ws, b, scale, y, xa, m, k, l, r, n * m,
                                        pl.steps, stream)
                 : launch_main_ct<S, 16>(pl.bn, grid, xb, ws, b, scale, y, xa, m, k, l, r, n * m,
                                         pl.steps, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The ffma path's launches: xA of every adapter as f32 partials (tile.cuh's
// gemm_kernel), then fused_ffma_kernel, and fused_epilogue only when K is
// split. Workspace: [the base's partials, when split][xA's partials].
template <class WS>
inline int launch_ffma(const Plan& pl, const float* x, const WS& w, const float* a,
                       const float* b, const float* scale, float* y, float* workspace, int n,
                       int m, int k, int l, int r, cudaStream_t stream) {
  const int rows = n * m;
  float* part_y = pl.splits_y > 1 ? workspace : nullptr;
  float* part_xa = workspace + (pl.splits_y > 1 ? (long long)pl.splits_y * rows * l : 0);
  if ((long long)n * pl.splits_xa > 65535 || pl.splits_y > 65535 ||
      (l + FF_BN - 1) / FF_BN > 65535)
    return (int)cudaErrorInvalidValue;
  auto kernel = fused_ffma_kernel<WS>;
  static PerDevice smem_set;  // the attribute belongs to the device it is set on
  const int e = smem_set.get([&] {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     FF_SMEM);
  });
  if (e) return e;
  launch_gemm<float>(Dense<float, false>{x, k}, Dense<float, false>{a, r}, nullptr,
                     (float*)nullptr, part_xa, n, m, k, r, stream);
  const dim3 grid((rows + FF_BM - 1) / FF_BM, (l + FF_BN - 1) / FF_BN, pl.splits_y);
  kernel<<<grid, FF_THREADS, FF_SMEM, stream>>>(x, w, part_xa, pl.splits_xa, b, scale, y, part_y,
                                                m, k, l, r, rows, pl.steps);
  if (part_y)
    launch_epilogue<float>(part_y, part_xa, b, scale, y, m, l, r, rows, pl.splits_y,
                           pl.splits_xa, stream);
  return (int)cudaGetLastError();
}

// One call of the fused function on the plan `pl`, W read through `w`
// (element (k, l) of the (K x L) weight; tile.cuh's sources). `workspace`:
// the plan's f32 workspace (on the decode path, xA).
template <typename T, class WS>
inline int launch_fused(const Plan& pl, const void* x, const WS& w, const void* a, const void* b,
                        const float* scale, void* y, float* workspace, int n, int m, int k,
                        int l, int r, cudaStream_t stream) {
  const int rows = n * m;
  float* part_y = workspace;
  float* part_xa = workspace ? workspace + (long long)pl.splits_y * rows * l : nullptr;
  if (pl.workspace > 0 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, bf16>::value && DecodeSource<WS>::OK) {
    if (pl.path == PATH_DECODE)
      return launch_decode(pl, x, w, a, b, scale, y, workspace, n, m, k, l, r, stream);
  }
  if constexpr (std::is_same<T, float>::value) {
    if (pl.path == PATH_FFMA)
      return launch_ffma(pl, static_cast<const float*>(x), w, static_cast<const float*>(a),
                         static_cast<const float*>(b), scale, static_cast<float*>(y), workspace,
                         n, m, k, l, r, stream);
  }
  if constexpr (std::is_same<T, bf16>::value) {
    if (pl.path == PATH_WGMMA) {
      if (pl.splits_y > 65535) return (int)cudaErrorInvalidValue;
      CUtensorMap tx, tw, ta{};
      if (const int bad = encode_bf16(&tx, x, k, rows, WG_BM)) return bad;
      if (const int bad = w_map(&tw, w, k, l, pl.bn)) return bad;
      if (a_tma(a, r))
        if (const int bad = encode_a(&ta, a, n, k, r, pl.rp)) return bad;
      float* py = pl.splits_y > 1 ? part_y : nullptr;
      int rc;
      switch (pl.rp) {
        case 16: rc = launch_wgmma<WS, 16>(pl, tx, tw, ta, w, a, b, scale, y, py, part_xa, n, m, k, l, r, stream); break;
        case 32: rc = launch_wgmma<WS, 32>(pl, tx, tw, ta, w, a, b, scale, y, py, part_xa, n, m, k, l, r, stream); break;
        case 64: rc = launch_wgmma<WS, 64>(pl, tx, tw, ta, w, a, b, scale, y, py, part_xa, n, m, k, l, r, stream); break;
        default: rc = launch_wgmma<WS, 128>(pl, tx, tw, ta, w, a, b, scale, y, py, part_xa, n, m, k, l, r, stream);
      }
      if (rc) return rc;
      if (pl.splits_y > 1)
        launch_epilogue<T>(part_y, part_xa, b, scale, y, m, l, r, rows, pl.splits_y,
                           pl.splits_xa, stream);
      return (int)cudaGetLastError();
    }
  }
  if ((long long)n * pl.splits_xa > 65535 || pl.splits_y > 65535) return (int)cudaErrorInvalidValue;
  const Dense<T, false> xs{static_cast<const T*>(x), k};
  launch_gemm<T>(xs, Dense<T, false>{static_cast<const T*>(a), r}, nullptr, (T*)nullptr, part_xa,
                 n, m, k, r, stream);
  launch_gemm<T>(xs, w, nullptr, (T*)nullptr, part_y, 1, rows, k, l, stream);
  launch_epilogue<T>(part_y, part_xa, b, scale, y, m, l, r, rows, pl.splits_y, pl.splits_xa,
                     stream);
  return (int)cudaGetLastError();
}

}  // namespace plora
