// The f32 path of the fused base + LoRA delta kernel ("ffma"):
// y[n] = x[n] @ W + scale[n] * (x[n] @ A[n]) @ B[n] in full f32 FMA.
//
// Replaces the dense and quantized branches of the Pallas TPU kernel
// src/repro/kernels/fused.py (fused_matmul -> _fused_kernel, and
// _fused_kernel_q with _dequant_tile) on an f32 x at the training and
// prefill shapes: the forward, the block-checkpointed recompute and the
// backward's dx = fused(g, W^T, B^T, A^T), W^T read in place from W's own
// storage.
//
// What bounds it on an H100. At the training shapes (2,048 rows, K and L
// 512-18,944) it does 2 x 2,048 FLOP per f32 weight element read: far above
// the card's f32 ridge (67 TFLOP/s over 3.35 TB/s, ~20 FLOP a byte), so the
// FP32 pipes (128 FFMA lanes an SM a clock) bound it, at 67 TFLOP/s. No
// tensor core: f32 parity stays at full f32 (TF32 keeps ~3 decimal digits).
// What the design does about that: keep the FFMA pipes fed.
//  * Register tile: a 128 x 128 output tile per block of 256 threads, each
//    owning 8 x 8 outputs (4 x 2 warps of 32 x 64; a warp's lanes 4 rows x
//    8 columns). Per 4 k a thread reads 8 + 8 float4 from shared memory for
//    256 FFMAs: 4 FFMAs a shared word. The lanes of a row (or a column)
//    read the same address (a broadcast), and the 4 (8) distinct rows of a
//    warp's load fall in distinct banks: no conflicts. (8 x 16 outputs a
//    thread, 5.3 FFMAs a word, ran slower in the forward on an H100: at
//    234-255 registers ptxas no longer overlaps the shared loads.)
//  * Asynchronous loads: a ring of 3 stages of BK = 32 in dynamic shared
//    memory (108 KB), filled by 16-byte cp.async (zero-filled past the
//    edges), two stages in flight while one is multiplied: one barrier per
//    8,192 FFMAs of a warp. Every operand keeps its layout on the way in:
//    x (and dx's W^T) is K-contiguous and lands as [row][k] (stride 36:
//    a float4 of 4 k per row), a row-major W lands as [k][column] (a
//    float4 of 4 columns per k). The loop reads 16 float4 per 4 k in both
//    cases, so dx pays for W^T what the forward pays for W; only the
//    columns a lane owns differ (4 adjacent and 4 more 32 on for a row-major
//    W, 8 strided by 8 for W^T), so that each layout's loads stay
//    conflict-free. A quantized W (int8, nf4) is loaded as codes into
//    registers one stage ahead, dequantized to exactly the dense W's f32
//    values and stored in the row-major layout: the same sums in the same
//    order, so it is bit-equal to the dense kernel on cast(dequantize(W)).
//  * Two launches: the xA pass (tile.cuh's gemm_kernel, f32 partial sums
//    over K ranges), then this kernel, whose epilogue stages the block's xA
//    rows (the partials added in order) in shared memory over the ring,
//    reads B through L1 and writes y = cast(acc + scale * xA @ B) once: no
//    f32 partial y. Rows of several adapters may share a tile (row g
//    belongs to adapter g / M).
//  * Split K only where the last wave of output tiles leaves enough SMs
//    idle to pay for it (plan_ffma; at 2,048 rows: k and v's 64 tiles, q,
//    o and down's 448 = 3.4 waves): each K range writes f32 partials, and
//    fused.cuh's fused_epilogue adds them in a fixed order (the same bits
//    every call).
// Launches allocate nothing and never synchronise (CUDA-graph safe); the
// ring's shared-memory size is set once per device (PerDevice).
#pragma once

#include <cmath>

namespace plora {

constexpr int FF_BM = 128, FF_BN = 128, FF_BK = 32;  // output tile, K per stage
constexpr int FF_STAGES = 3, FF_THREADS = 256;
constexpr int FF_MAX_SPLITS = 4;  // K ranges the plan may cut
constexpr int FF_KLD = FF_BK + 4;       // row stride (floats) of a [row][k] tile
constexpr int FF_TILE = FF_BM * FF_KLD;  // floats of one operand's tile in a stage
constexpr int FF_SMEM = FF_STAGES * 2 * FF_TILE * 4;  // 110,592 bytes
constexpr int FF_CHUNKS = FF_BM * FF_BK / 4 / FF_THREADS;  // 16-byte copies a thread, per tile
constexpr int FF_QROWS = FF_BK / 8;  // k rows a thread stages of a quantized W tile
static_assert(FF_BK * FF_BN <= FF_TILE, "a [k][column] tile fits its slot");
static_assert(FF_BM * (RMAX + 4) <= FF_STAGES * 2 * FF_TILE, "the xA rows fit over the ring");

// a 16-byte asynchronous copy; when !ok, 16 zero bytes (src is not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ld4(float (&d)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}

// Rows [r0, r0 + 128) x k [k0, k0 + BK) of a row-major (nrows x *) array
// with row stride ld into a [row][k] tile; zero past nrows or ke.
__device__ __forceinline__ void ff_load_rows(float* tile, const float* p, int ld, int r0,
                                             int nrows, int k0, int ke) {
#pragma unroll
  for (int u = 0; u < FF_CHUNKS; ++u) {
    const int c = threadIdx.x + u * FF_THREADS, row = c / (FF_BK / 4), kc = c % (FF_BK / 4) * 4;
    const int gr = r0 + row, gk = k0 + kc;
    const bool ok = gr < nrows && gk < ke;
    cp_async16_zfill(tile + row * FF_KLD + kc, ok ? p + (size_t)gr * ld + gk : p, ok);
  }
}

// k [k0, k0 + BK) x columns [l0, l0 + 128) of a row-major (K x L) array
// into a [k][column] tile; zero past ke or L.
__device__ __forceinline__ void ff_load_cols(float* tile, const float* p, int ld, int l0, int L,
                                             int k0, int ke) {
#pragma unroll
  for (int u = 0; u < FF_CHUNKS; ++u) {
    const int c = threadIdx.x + u * FF_THREADS, kk = c >> 5, cc = (c & 31) * 4;
    const int gk = k0 + kk, gl = l0 + cc;
    const bool ok = gk < ke && gl < L;
    cp_async16_zfill(tile + kk * FF_BN + cc, ok ? p + (size_t)gk * ld + gl : p, ok);
  }
}

// How a W tile reaches shared memory. Dense: cp.async, [row][k] for W^T
// (KMAJOR), else [k][column]. Quantized: codes into registers (`load`, one
// stage ahead), then f32 values into a [k][column] tile (`store`); each
// thread owns 4 adjacent columns of rows kk, kk + 8, ... (FF_QROWS rows).
template <class WS>
struct FfSource;

template <bool TRANS>
struct FfSource<Dense<float, TRANS>> {
  static constexpr bool ASYNC = true, KMAJOR = TRANS;
  __device__ __forceinline__ void init(const Dense<float, TRANS>&, int, int) {}
  __device__ __forceinline__ void store(float*, const float*) const {}
};

template <>
struct FfSource<Int8W<float>> {
  static constexpr bool ASYNC = false, KMAJOR = false;
  uint32_t code[FF_QROWS];
  float s[4];  // the 4 columns' scales
  int col;
  bool ok[FF_QROWS];
  __device__ __forceinline__ void init(const Int8W<float>& w, int l0, int L) {
    col = l0 + (threadIdx.x & 31) * 4;
    s[0] = s[1] = s[2] = s[3] = 0.f;
    if (col < L) ld4(s, w.scales + col);
  }
  __device__ __forceinline__ void load(const Int8W<float>& w, int k0, int ke, int L) {
#pragma unroll
    for (int u = 0; u < FF_QROWS; ++u) {
      const int gk = k0 + (threadIdx.x >> 5) + 8 * u;
      ok[u] = gk < ke && col < L;
      code[u] = ok[u] ? *reinterpret_cast<const uint32_t*>(w.codes + (size_t)gk * w.ld + col) : 0u;
    }
  }
  __device__ __forceinline__ void store(float* tile, const float*) const {
#pragma unroll
    for (int u = 0; u < FF_QROWS; ++u) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)  // (float)code * scale, as Int8W<float>::value
        v[e] = ok[u] ? __fmul_rn((float)(int8_t)(code[u] >> (8 * e)), s[e]) : 0.f;
      *reinterpret_cast<float4*>(tile + ((threadIdx.x >> 5) + 8 * u) * FF_BN +
                                 (threadIdx.x & 31) * 4) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
};

template <>
struct FfSource<Nf4W<float>> {
  static constexpr bool ASYNC = false, KMAJOR = false;
  uint32_t code[FF_QROWS];
  float s[FF_QROWS][4];  // each row's block scales of the 4 columns
  int col;
  bool ok[FF_QROWS];
  __device__ __forceinline__ void init(const Nf4W<float>&, int l0, int) {
    col = l0 + (threadIdx.x & 31) * 4;
  }
  __device__ __forceinline__ void load(const Nf4W<float>& w, int k0, int ke, int L) {
#pragma unroll
    for (int u = 0; u < FF_QROWS; ++u) {
      const int gk = k0 + (threadIdx.x >> 5) + 8 * u;
      ok[u] = gk < ke && col < L;
      code[u] = 0u;
      if (ok[u]) {
        code[u] = *reinterpret_cast<const uint32_t*>(w.codes + (size_t)(gk >> 1) * w.ld + col);
        ld4(s[u], w.scales + (size_t)(gk / w.blk) * w.ld + col);
      }
    }
  }
  // cb: the codebook in shared memory (a lane's lookups never serialise)
  __device__ __forceinline__ void store(float* tile, const float* cb) const {
    const int shift = (threadIdx.x >> 5 & 1) * 4;  // an odd row (k0 is even): the high nibble
#pragma unroll
    for (int u = 0; u < FF_QROWS; ++u) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)  // codebook[q] * scale, as Nf4W<float>::value
        v[e] = ok[u] ? __fmul_rn(cb[(code[u] >> (8 * e + shift)) & 15], s[u][e]) : 0.f;
      *reinterpret_cast<float4*>(tile + ((threadIdx.x >> 5) + 8 * u) * FF_BN +
                                 (threadIdx.x & 31) * 4) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
};

// The tile column of a thread's output column j (0..7): for a [k][column]
// W tile 4 adjacent columns and 4 more 32 on (two float4 a k); for a
// [row][k] tile (W^T) 8 columns strided by 8 (one float4 of 4 k each).
template <bool KMAJOR>
__device__ __forceinline__ int ff_col(int wn0, int lc, int j) {
  return KMAJOR ? wn0 + lc + 8 * j : wn0 + 4 * lc + 32 * (j >> 2) + (j & 3);
}

// acc[i][j] += sum over the stage's BK k, in k order, of
// x[row i][k] * W[k][column j]; rows wm0 + lr + 4 i.
template <bool KMAJOR>
__device__ __forceinline__ void ffma_stage(float (&acc)[8][8], const float* xs, const float* ws,
                                           int wm0, int wn0, int lr, int lc) {
#pragma unroll
  for (int kc = 0; kc < FF_BK; kc += 4) {
    float a[8][4], bv[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) ld4(a[i], xs + (wm0 + lr + 4 * i) * FF_KLD + kc);
    if constexpr (KMAJOR) {
#pragma unroll
      for (int j = 0; j < 8; ++j) ld4(bv[j], ws + ff_col<true>(wn0, lc, j) * FF_KLD + kc);
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[4];
          ld4(v, ws + (kc + kk) * FF_BN + wn0 + 4 * lc + 32 * h);
#pragma unroll
          for (int e = 0; e < 4; ++e) bv[4 * h + e][kk] = v[e];
        }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], bv[j][kk], acc[i][j]);
  }
}

// Grid (row tiles, column tiles, K ranges): blockIdx.x walks the 128-row
// tiles, so the blocks in flight share W's column tiles in L2. Block z
// covers K steps [z * steps, (z + 1) * steps). x (rows x K) row-major; xa
// the xA pass's partials [splits_xa][rows][R]; b (N, R, L); y (rows x L).
// With part_y the block writes its f32 partials to part_y[z][rows][L]
// (fused_epilogue finishes), else y.
template <class WS>
__global__ void __launch_bounds__(FF_THREADS, 1)
fused_ffma_kernel(const float* __restrict__ x, const WS w, const float* __restrict__ xa,
                  int splits_xa, const float* __restrict__ b, const float* __restrict__ scale,
                  float* __restrict__ y, float* __restrict__ part_y, int M, int K, int L, int R,
                  int rows, int steps) {
  using S = FfSource<WS>;
  extern __shared__ float4 ff_smem[];
  __shared__ float cb[16];
  float* smem = reinterpret_cast<float*>(ff_smem);
  const int m0 = blockIdx.x * FF_BM, l0 = blockIdx.y * FF_BN, z = blockIdx.z;
  const int kb = z * steps * FF_BK, ke = min(K, kb + steps * FF_BK);
  const int nsteps = (ke - kb + FF_BK - 1) / FF_BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp & 3) * 32, wn0 = (warp >> 2) * 64, lr = lane >> 3, lc = lane & 7;
  if (threadIdx.x < 16) cb[threadIdx.x] = NF4_CODEBOOK[threadIdx.x];
  S src;
  src.init(w, l0, L);
  __syncthreads();

  // k step `it` into its stage: x (and a dense W) by cp.async; a quantized
  // W's codes into registers
  auto issue = [&](int it) {
    float* xs = smem + (it % FF_STAGES) * 2 * FF_TILE;
    const int k0 = kb + it * FF_BK;
    ff_load_rows(xs, x, K, m0, rows, k0, ke);
    if constexpr (!S::ASYNC) src.load(w, k0, ke, L);
    else if constexpr (S::KMAJOR) ff_load_rows(xs + FF_TILE, w.p, w.ld, l0, L, k0, ke);
    else ff_load_cols(xs + FF_TILE, w.p, w.ld, l0, L, k0, ke);
  };
  for (int s = 0; s < FF_STAGES - 1; ++s) {
    if (s < nsteps) {
      issue(s);
      src.store(smem + s * 2 * FF_TILE + FF_TILE, cb);
    }
    cp_async_commit();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<FF_STAGES - 2>();  // this thread's copies of step it have landed
    __syncthreads();  // everyone's have, and everyone is done with step it - 1's stage
    const int nx = it + FF_STAGES - 1;  // into step it - 1's stage
    if (nx < nsteps) issue(nx);
    cp_async_commit();
    const float* xs = smem + (it % FF_STAGES) * 2 * FF_TILE;
    ffma_stage<S::KMAJOR>(acc, xs, xs + FF_TILE, wm0, wn0, lr, lc);
    if (nx < nsteps) src.store(smem + (nx % FF_STAGES) * 2 * FF_TILE + FF_TILE, cb);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  if (part_y) {  // K split: f32 partials
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int g = m0 + wm0 + lr + 4 * i;
      if (g >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int gl = l0 + ff_col<S::KMAJOR>(wn0, lc, j);
        if (gl < L) part_y[((size_t)z * rows + g) * L + gl] = acc[i][j];
      }
    }
    return;
  }

  // the block's xA rows (the K ranges' partials added in order) over the ring
  const int R4 = (R + 3) & ~3, XLD = R4 + 4;
  for (int p = threadIdx.x; p < FF_BM * R4; p += FF_THREADS) {
    const int r = p / R4, q = p % R4, g = m0 + r;
    float sum = 0.f;
    if (g < rows && q < R)
      for (int sp = 0; sp < splits_xa; ++sp) sum += xa[((size_t)sp * rows + g) * R + q];
    smem[r * XLD + q] = sum;
  }
  __syncthreads();
  const int g0 = m0 + wm0 + lr;  // the thread's rows: g0 + 4 i
  if (g0 >= rows) return;
  const int ad_lo = g0 / M, ad_hi = min(g0 + 28, rows - 1) / M;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // columns j = 4 h .. 4 h + 3
    float d[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][e] = 0.f;
    for (int ad = ad_lo; ad <= ad_hi; ++ad) {
      const float* bp = b + (size_t)ad * R * L + l0;
      for (int q0 = 0; q0 < R; q0 += 4) {
        float xv[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) ld4(xv[i], smem + (wm0 + lr + 4 * i) * XLD + q0);
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          if (q0 + qq >= R) break;
          const float* bq = bp + (size_t)(q0 + qq) * L;
          float bv[4];
          if constexpr (S::KMAJOR) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = ff_col<true>(wn0, lc, 4 * h + e);
              bv[e] = l0 + c < L ? __ldg(bq + c) : 0.f;
            }
          } else {
            const int c = ff_col<false>(wn0, lc, 4 * h);
            if (l0 + c < L) {
              const float4 v = __ldg(reinterpret_cast<const float4*>(bq + c));
              bv[0] = v.x; bv[1] = v.y; bv[2] = v.z; bv[3] = v.w;
            } else {
              bv[0] = bv[1] = bv[2] = bv[3] = 0.f;
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if ((g0 + 4 * i) / M == ad)
#pragma unroll
              for (int e = 0; e < 4; ++e) d[i][e] = fmaf(xv[i][qq], bv[e], d[i][e]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int g = g0 + 4 * i;
      if (g >= rows) continue;
      const float sc = scale ? scale[g / M] : 1.f;
      float* yr = y + (size_t)g * L + l0;
      if constexpr (S::KMAJOR) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = ff_col<true>(wn0, lc, 4 * h + e);
          if (l0 + c < L) yr[c] = fmaf(sc, d[i][e], acc[i][4 * h + e]);
        }
      } else {
        const int c = ff_col<false>(wn0, lc, 4 * h);
        if (l0 + c < L)
          *reinterpret_cast<float4*>(yr + c) =
              make_float4(fmaf(sc, d[i][0], acc[i][4 * h]), fmaf(sc, d[i][1], acc[i][4 * h + 1]),
                          fmaf(sc, d[i][2], acc[i][4 * h + 2]),
                          fmaf(sc, d[i][3], acc[i][4 * h + 3]));
      }
    }
  }
}

// Whether an f32 call takes this path: more rows than a decode tile, K and
// L multiples of 4 (16-byte rows), x, W (or the codes and scales), A and B
// on 16 bytes (`aligned`, `ab_aligned`).
inline bool use_ffma(bool aligned, bool ab_aligned, int dtype, int n, int m, int k, int l) {
  return dtype == 0 && (long long)n * m > ThinTile::BM && k % 4 == 0 && l % 4 == 0 && aligned &&
         ab_aligned;
}

// Seconds an output tile takes per unit of K on one SM: its 2 x BM x BN
// FLOP at ~60 % of an SM's share of the 67 TFLOP/s f32 peak (about the
// rate the kernel holds at the training shapes on an H100).
constexpr double FF_S_PER_K = 2.0 * FF_BM * FF_BN / (0.6 * 67e12 / NUM_SMS);

// The time of a call with K cut into s ranges: whole waves of one block an
// SM (the last wave may leave SMs idle), and when split, the f32 partials
// written and read back at 3.35 TB/s and fused_epilogue's launch.
inline double ffma_time(long long tiles, int k, int s, long long rows, int l) {
  const double t = std::ceil((double)tiles * s / NUM_SMS) * FF_S_PER_K * std::ceil((double)k / s);
  return s == 1 ? t : t + 8.0 * s * rows * l / 3.35e12 + 1e-5;
}

// Split K where the last wave leaves enough SMs idle to pay for the
// partials (at 2,048 rows k and v: 64 tiles; q, o and down: 448), at most 4
// ranges of at least 4 K steps each. `splits` > 0 asks for that many ranges
// instead (the autotuner's candidate), clamped to the same limits.
inline SplitK plan_ffma(int rows, int k, int l, int splits) {
  const int ksteps = (k + FF_BK - 1) / FF_BK;
  if (splits > 0) return k_ranges(ksteps, splits, FF_MAX_SPLITS);
  const long long tiles = (long long)((rows + FF_BM - 1) / FF_BM) * ((l + FF_BN - 1) / FF_BN);
  int best = 1;
  for (int s = 2; s <= FF_MAX_SPLITS && ksteps >= 4 * s; ++s)
    if (ffma_time(tiles, k, s, rows, l) < ffma_time(tiles, k, best, rows, l)) best = s;
  const int steps = (ksteps + best - 1) / best;
  return {(ksteps + steps - 1) / steps, steps};
}

}  // namespace plora
