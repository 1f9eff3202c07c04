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
//  * bf16, > 16 rows, each 64-row tile inside one adapter, K and L multiples
//    of 8, operands 16-byte aligned (8 for int8/nf4 codes):
//    fused_mma_kernel, one pass in the TPU kernel's manner. mma.sync
//    m16n8k16 (bf16 in, f32 accumulate) multiplies each staged x fragment by
//    the W tile and by the adapter's A tile; xA stays in f32 registers across
//    the K loop and the delta is applied once, when y is written. A W^T tile
//    is staged column by column (its 8-element loads run along K), which is
//    the layout the mma's B fragment wants: no transposed copy of W.
//  * Otherwise -- decode's 8 rows of 8 adapters, f32, odd shapes: three
//    launches: xA as f32 partial sums (tile.cuh's gemm_kernel over the
//    adapters, K split across blocks), the base product as f32 partials
//    (split K when the output tiles are few), and fused_epilogue, which adds
//    each quantity's ranges in a fixed order and writes
//    y = cast(base + scale * xA @ B) once. Same function, same rounding
//    points; x is read twice.
// The path and the split plan depend only on shapes, dtype and alignment,
// never on how W is stored, and a dequantized tile holds exactly the values
// of the dense W = cast(dequantize(W)): so the quantized kernel is bit-equal
// to the dense one on the dequantized weight, as the Pallas kernel's
// contract requires (fused.py:37-46).
#pragma once

#include <type_traits>

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
// 8 consecutive bf16 W values along the source's adjacent index, packed in a
// uint4: the tensor-core kernel's staging load. Element (k, l) as in tile.cuh.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <bool TRANS>
__device__ __forceinline__ uint4 load8(const Dense<bf16, TRANS>& w, int k, int l) {
  return *reinterpret_cast<const uint4*>(TRANS ? w.p + (size_t)l * w.ld + k
                                               : w.p + (size_t)k * w.ld + l);
}

// columns l..l+7 of row k, from 8 codes and 8 scales
template <class Q>
__device__ __forceinline__ uint4 dequant8(const Q& w, const uint8_t (&c)[8], int k, int l,
                                          const float* srow) {
  const float4 s0 = *reinterpret_cast<const float4*>(srow + l);
  const float4 s1 = *reinterpret_cast<const float4*>(srow + l + 4);
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  bf16 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16_rn(w.code_value(c[j], k) * s[j]);
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

struct Int8Code {
  __device__ __forceinline__ float code_value(uint8_t c, int) const {
    return (float)(int8_t)c;
  }
};
struct Nf4Code {
  __device__ __forceinline__ float code_value(uint8_t c, int k) const {
    return NF4_CODEBOOK[(k & 1) ? (c >> 4) : (c & 15)];
  }
};

__device__ __forceinline__ void load_codes8(const uint8_t* p, uint8_t (&c)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c[j] = (u.x >> (8 * j)) & 0xff;
    c[4 + j] = (u.y >> (8 * j)) & 0xff;
  }
}

__device__ __forceinline__ uint4 load8(const Int8W<bf16>& w, int k, int l) {
  uint8_t c[8];
  load_codes8(reinterpret_cast<const uint8_t*>(w.codes) + (size_t)k * w.ld + l, c);
  return dequant8(Int8Code{}, c, k, l, w.scales);
}

__device__ __forceinline__ uint4 load8(const Nf4W<bf16>& w, int k, int l) {
  uint8_t c[8];
  load_codes8(w.codes + (size_t)(k >> 1) * w.ld + l, c);
  return dequant8(Nf4Code{}, c, k, l, w.scales + (size_t)(k / w.blk) * w.ld);
}

// ---------------------------------------------------------------------------
// The one-pass tensor-core kernel: bf16, more than 16 rows, each 64-row tile
// inside one adapter.
// ---------------------------------------------------------------------------

constexpr int MMA_BM = 64, MMA_BN = 64, MMA_BK = 32, MMA_THREADS = 128;  // 4 warps, 32x32 each
constexpr int X_LD = MMA_BK + 8;   // row strides (bf16) padded so that the
constexpr int W_LD = MMA_BN + 8;   // fragment reads are free of bank conflicts
constexpr int WT_LD = MMA_BK + 8;  // W^T tile: one row per output column
constexpr int A_LD = RMAX + 8;
constexpr int XA_LD = RMAX + 1;    // f32
constexpr int SMEM_X = MMA_BM * X_LD * 2, SMEM_A = MMA_BK * A_LD * 2;
constexpr int SMEM_W = MMA_BK * W_LD * 2 > MMA_BN * WT_LD * 2 ? MMA_BK * W_LD * 2
                                                              : MMA_BN * WT_LD * 2;
constexpr int SMEM_TILES = SMEM_X + SMEM_W + SMEM_A;
constexpr int SMEM_XA = MMA_BM * XA_LD * 4;  // reuses the tiles' space after the K loop
constexpr int MMA_SMEM = SMEM_TILES > SMEM_XA ? SMEM_TILES : SMEM_XA;

// c += a (16x16, row) * b (16x8, col); fragment layouts as in the PTX ISA for
// m16n8k16: a = {rows g, g+8} x {k 2t..2t+1, 2t+8..2t+9}, b = k {2t, 2t+1,
// 2t+8, 2t+9} x column g, c = {rows g, g+8} x columns {2t, 2t+1}, where
// g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte loads of one K step's x tile (64 x 32) and W tile (32 x 64), two
// of each per thread; K and L are multiples of 8, so no 8-element chunk
// crosses an edge. A W^T source is loaded 8 k at a time per column (chunk c:
// column c / 4, k 8 * (c % 4)); any other source 8 columns at a time per k.
template <class WS>
__device__ __forceinline__ void mma_load(uint4 (&xr)[2], uint4 (&wr)[2], const bf16* __restrict__ x,
                                         const WS& w, int rows, int K, int L, int m0, int l0,
                                         int k0, int kend) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = threadIdx.x + u * MMA_THREADS;
    const int r = c >> 2, kc = (c & 3) * 8, g = m0 + r;
    xr[u] = (g < rows && k0 + kc < kend)
                ? *reinterpret_cast<const uint4*>(x + (size_t)g * K + k0 + kc) : zero;
    if constexpr (WS::FAST_I) {
      const int gl = l0 + (c >> 2), gk = k0 + (c & 3) * 8;
      wr[u] = (gk < kend && gl < L) ? load8(w, gk, gl) : zero;
    } else {
      const int gk = k0 + (c >> 3), gl = l0 + (c & 7) * 8;
      wr[u] = (gk < kend && gl < L) ? load8(w, gk, gl) : zero;
    }
  }
}

template <class WS>
__global__ void __launch_bounds__(MMA_THREADS)
fused_mma_kernel(const bf16* __restrict__ x, WS w, const bf16* __restrict__ a,
                 const bf16* __restrict__ b, const float* __restrict__ scale, bf16* __restrict__ y,
                 float* __restrict__ part_y, float* __restrict__ part_xa,
                 int M, int K, int L, int R, int rows, int steps) {
  __shared__ __align__(16) unsigned char smem[MMA_SMEM];
  bf16(*xs)[X_LD] = reinterpret_cast<bf16(*)[X_LD]>(smem);
  bf16(*ws)[W_LD] = reinterpret_cast<bf16(*)[W_LD]>(smem + SMEM_X);    // W tile [k][l]
  bf16(*wt)[WT_LD] = reinterpret_cast<bf16(*)[WT_LD]>(smem + SMEM_X);  // W^T tile [l][k]
  bf16(*as)[A_LD] = reinterpret_cast<bf16(*)[A_LD]>(smem + SMEM_X + SMEM_W);
  float(*xa)[XA_LD] = reinterpret_cast<float(*)[XA_LD]>(smem);  // after the K loop

  const int s = blockIdx.z, m0 = blockIdx.y * MMA_BM, l0 = blockIdx.x * MMA_BN;
  const int kb = s * steps * MMA_BK, ke = min(K, kb + steps * MMA_BK);
  const int ad = m0 / M;  // the tile's one adapter
  const bool do_xa = part_y == nullptr || blockIdx.x == 0;
  const int RP = (R + 15) / 16 * 16;  // rank padded with zero columns to whole n8 pairs
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp >> 1, wn = warp & 1, gq = lane >> 2, tq = lane & 3;
  const bf16* ap = a + (size_t)ad * K * R;

  float acc[2][4][4], xacc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xacc[i][j][e] = 0.f;
  }

  uint4 xr[2], wr[2];
  mma_load(xr, wr, x, w, rows, K, L, m0, l0, kb, ke);
  for (int k0 = kb; k0 < ke; k0 += MMA_BK) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = threadIdx.x + u * MMA_THREADS;
      *reinterpret_cast<uint4*>(&xs[c >> 2][(c & 3) * 8]) = xr[u];
      if constexpr (WS::FAST_I)
        *reinterpret_cast<uint4*>(&wt[c >> 2][(c & 3) * 8]) = wr[u];
      else
        *reinterpret_cast<uint4*>(&ws[c >> 3][(c & 7) * 8]) = wr[u];
    }
    if (do_xa)
      for (int p = threadIdx.x; p < MMA_BK * RP; p += MMA_THREADS) {
        const int kk = p / RP, j = p % RP, gk = k0 + kk;
        as[kk][j] = (j < R && gk < ke) ? ap[(size_t)gk * R + j] : __ushort_as_bfloat16(0);
      }
    __syncthreads();
    if (k0 + MMA_BK < ke) mma_load(xr, wr, x, w, rows, K, L, m0, l0, k0 + MMA_BK, ke);
#pragma unroll
    for (int kk = 0; kk < MMA_BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r0 = wm * 32 + mi * 16 + gq;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&xs[r0][kk + tq * 2]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&xs[r0 + 8][kk + tq * 2]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&xs[r0][kk + tq * 2 + 8]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&xs[r0 + 8][kk + tq * 2 + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn * 32 + ni * 8 + gq;
        uint32_t b0, b1;
        if constexpr (WS::FAST_I) {
          b0 = *reinterpret_cast<const uint32_t*>(&wt[c][kk + tq * 2]);
          b1 = *reinterpret_cast<const uint32_t*>(&wt[c][kk + tq * 2 + 8]);
        } else {
          b0 = pack2(ws[kk + tq * 2][c], ws[kk + tq * 2 + 1][c]);
          b1 = pack2(ws[kk + tq * 2 + 8][c], ws[kk + tq * 2 + 9][c]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma16816(acc[mi][ni], af[mi], b0, b1);
      }
      if (do_xa) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int c = (wn + 2 * q) * 8 + gq;  // this warp's n8 tiles: wn, wn+2, ...
          if ((wn + 2 * q) * 8 >= RP) break;
          const uint32_t b0 = pack2(as[kk + tq * 2][c], as[kk + tq * 2 + 1][c]);
          const uint32_t b1 = pack2(as[kk + tq * 2 + 8][c], as[kk + tq * 2 + 9][c]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma16816(xacc[mi][q], af[mi], b0, b1);
        }
      }
    }
    __syncthreads();
  }

  if (do_xa) {  // xA fragments to shared memory (the tiles are no longer read)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if ((wn + 2 * q) * 8 >= RP) break;
        const int r0 = wm * 32 + mi * 16 + gq, c0 = (wn + 2 * q) * 8 + tq * 2;
        xa[r0][c0] = xacc[mi][q][0];
        xa[r0][c0 + 1] = xacc[mi][q][1];
        xa[r0 + 8][c0] = xacc[mi][q][2];
        xa[r0 + 8][c0 + 1] = xacc[mi][q][3];
      }
  }
  __syncthreads();

  if (part_y) {  // split: partial sums out, the epilogue kernel finishes
    if (blockIdx.x == 0)
      for (int p = threadIdx.x; p < MMA_BM * R; p += MMA_THREADS) {
        const int r = p / R, j = p % R, g = m0 + r;
        if (g < rows) part_xa[((size_t)s * rows + g) * R + j] = xa[r][j];
      }
  }
  const bf16* bp = b + (size_t)ad * R * L;
  const float sc = scale ? scale[ad] : 1.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mi * 16 + gq + h * 8, g = m0 + r;
        if (g >= rows) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gl = l0 + wn * 32 + ni * 8 + tq * 2 + e;
          if (gl >= L) continue;
          if (part_y) {
            part_y[((size_t)s * rows + g) * L + gl] = acc[mi][ni][h * 2 + e];
            continue;
          }
          float d = 0.f;
          for (int q = 0; q < R; ++q) d = fmaf(xa[r][q], __bfloat162float(bp[(size_t)q * L + gl]), d);
          y[(size_t)g * L + gl] = __float2bfloat16_rn(acc[mi][ni][h * 2 + e] + sc * d);
        }
      }
}

// ---------------------------------------------------------------------------
// Plan and launch
// ---------------------------------------------------------------------------

// Whether a call takes the tensor-core path (see fused_mma_kernel).
// `aligned`: x and every W array can be read with the kernel's vector loads.
inline bool use_mma(bool aligned, int dtype, int n, int m, int k, int l) {
  return dtype == 1 && n * m > ThinTile::BM && (n == 1 || m % MMA_BM == 0) && k % 8 == 0 &&
         l % 8 == 0 && aligned;
}

inline bool aligned_to(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

inline SplitK plan_mma(int rows, int k, int l) {
  return split_k(((rows + MMA_BM - 1) / MMA_BM) * ((l + MMA_BN - 1) / MMA_BN), k, MMA_BK);
}

// The plan of a call: K ranges of the base product and of xA, and the f32
// workspace (elements) for their partial sums (0: none needed).
struct Plan {
  bool mma;
  int splits_y, splits_xa;
  long long workspace;
};

inline Plan make_plan(bool aligned, int dtype, int n, int m, int k, int l, int r) {
  const int rows = n * m;
  if (use_mma(aligned, dtype, n, m, k, l)) {
    const int s = plan_mma(rows, k, l).splits;
    return {true, s, s, s > 1 ? (long long)s * rows * (l + r) : 0};
  }
  const int sy = gemm_plan_for(1, rows, k, l).splits, sx = gemm_plan_for(n, m, k, r).splits;
  return {false, sy, sx, (long long)sy * rows * l + (long long)sx * rows * r};
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

// One call of the fused function on the plan `pl`, W read through `w`
// (element (k, l) of the (K x L) weight; tile.cuh's sources).
template <typename T, class WS>
inline int launch_fused(const Plan& pl, const void* x, const WS& w, const void* a, const void* b,
                        const float* scale, void* y, float* workspace, int n, int m, int k,
                        int l, int r, cudaStream_t stream) {
  const int rows = n * m;
  float* part_y = workspace;
  float* part_xa = workspace ? workspace + (long long)pl.splits_y * rows * l : nullptr;
  if (pl.workspace > 0 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, bf16>::value) {
    if (pl.mma) {
      const dim3 grid((l + MMA_BN - 1) / MMA_BN, (rows + MMA_BM - 1) / MMA_BM, pl.splits_y);
      const int steps = plan_mma(rows, k, l).steps;
      fused_mma_kernel<WS><<<grid, MMA_THREADS, 0, stream>>>(
          static_cast<const bf16*>(x), w, static_cast<const bf16*>(a),
          static_cast<const bf16*>(b), scale, static_cast<bf16*>(y),
          pl.splits_y > 1 ? part_y : nullptr, part_xa, m, k, l, r, rows, steps);
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
