// Shared pieces of the port's hand-written GEMM kernels (packed_matmul.cu,
// fused.cu, fused_q.cu): element conversion, the operand sources a kernel
// reads its matrices through (row-major, transposed, or quantized codes),
// register-staged tile loads, one shared-memory tiled product step with
// plain f32 FMA, and the split-K plan. Each kernel is compiled on its own
// into a library with a plain C interface (kernels/_build.py), so this
// header is included once per library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>

namespace plora {

// A value computed once per device: function attributes
// (cudaFuncSetAttribute) and occupancy belong to the current device, so a
// plain function-local static would set them on the first device a process
// launches on and leave a launch on any other device to fail. `get(f)`
// runs f on the current device's first call and keeps its int result; one
// thread per device at a time (each slot is written by its own device's
// thread only).
constexpr int PLORA_MAX_DEVICES = 64;
struct PerDevice {
  bool done[PLORA_MAX_DEVICES] = {};
  int value[PLORA_MAX_DEVICES] = {};
  template <class F>
  int get(F f) {
    int d = 0;
    if (cudaGetDevice(&d) != cudaSuccess || d < 0 || d >= PLORA_MAX_DEVICES) return f();
    if (!done[d]) {
      value[d] = f();
      done[d] = true;
    }
    return value[d];
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as astype(bf16)
}

// ---------------------------------------------------------------------------
// Operand sources. A kernel reads element (i, j) of an (R x C) operand
// through one of these, so a transposed view or a quantized weight needs no
// copy. FAST_I says which index is adjacent in memory: the staging loads
// walk that index across neighbouring threads, so they stay coalesced.
// ---------------------------------------------------------------------------

// A dense matrix, row-major (p[i * ld + j]) or stored as its transpose
// (p[j * ld + i]: the (C x R) row-major matrix a transposed view reads).
template <typename T, bool TRANS>
struct Dense {
  const T* p;
  int ld;
  static constexpr bool FAST_I = TRANS;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return to_f32(TRANS ? p[(size_t)j * ld + i] : p[(size_t)i * ld + j]);
  }
  // the same layout, `elems` elements further on (the next adapter's matrix)
  __host__ __device__ Dense shift(size_t elems) const { return {p + elems, ld}; }
};

// Dequantization, as kernels/quant.py's dequantize and then one cast to the
// compute type T: the f32 product code * scale, rounded to T once. Element
// (k, l) of a (K x L) weight; shared by every adapter (shift is a no-op).
__constant__ float NF4_CODEBOOK[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f, 0.33791524171829224f,
    0.44070982933044434f, 0.5626170039176941f, 0.7229568362236023f, 1.0f};

// int8 codes (K, L), one f32 scale per column (1, L).
template <typename T>
struct Int8W {
  const int8_t* codes;
  const float* scales;
  int ld;  // L
  static constexpr bool FAST_I = false;
  __device__ __forceinline__ T value(int k, int l) const {
    return from_f32<T>((float)codes[(size_t)k * ld + l] * scales[l]);
  }
  __device__ __forceinline__ float operator()(int k, int l) const { return to_f32(value(k, l)); }
  __host__ __device__ Int8W shift(size_t) const { return *this; }
};

// nf4 codes (K/2, L) uint8, two K rows per byte (low nibble = even row),
// looked up in the 16-entry codebook; f32 scales (K/blk, L), one per block
// of blk rows.
template <typename T>
struct Nf4W {
  const uint8_t* codes;
  const float* scales;
  int ld, blk;  // L, rows per scale block
  static constexpr bool FAST_I = false;
  __device__ __forceinline__ T value(int k, int l) const {
    const uint8_t b = codes[(size_t)(k >> 1) * ld + l];
    const int q = (k & 1) ? (b >> 4) : (b & 15);
    return from_f32<T>(NF4_CODEBOOK[q] * scales[(size_t)(k / blk) * ld + l]);
  }
  __device__ __forceinline__ float operator()(int k, int l) const { return to_f32(value(k, l)); }
  __host__ __device__ Nf4W shift(size_t) const { return *this; }
};

// ---------------------------------------------------------------------------
// Tiles
// ---------------------------------------------------------------------------

// Geometry of one thread block: a BM x BN output tile, BK deep per step of
// the K loop; each of the THREADS threads owns TM rows x TN columns. A
// thread's columns are strided by COLS = BN / TN, so neighbouring threads
// touch neighbouring columns: coalesced global stores and conflict-free
// shared-memory reads.
template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int COLS = BN / TN;
  static constexpr int THREADS = (BM / TM) * COLS;
};

// Decode (at most 16 rows): few rows, a deep K step. (A tile of 8 x 256 with
// 4 x 4 per thread measured 2.6x slower in bf16 on the decode shapes.)
using ThinTile = Tile<16, 64, 64, 2, 2>;
// Prefill and anything with more rows.
using WideTile = Tile<64, 64, 16, 4, 4>;

// The blocks the card should have in flight: two per SM of an H100.
constexpr int TARGET_BLOCKS = 2 * 132;
constexpr int MAX_SPLITS = 32;

// Split-K plan: when the output tiles alone give too few blocks to keep the
// card's memory busy, the K loop is cut into `splits` ranges of `steps` BK
// steps each; every range writes f32 partial sums and a second kernel adds
// them in a fixed order (deterministic, no atomics).
struct SplitK {
  int splits, steps;
};

// K steps cut into s ranges, s clamped to [1, cap] and to at least 4 K
// steps a range: the ranges and the K steps each (the fused plans' rule,
// for their own choice and for a caller's).
__host__ __device__ inline SplitK k_ranges(int ksteps, int s, int cap) {
  s = s < cap ? s : cap;
  s = s < ksteps / 4 ? s : ksteps / 4;
  s = s > 1 ? s : 1;
  const int steps = (ksteps + s - 1) / s;
  return {(ksteps + steps - 1) / steps, steps};
}

__host__ __device__ inline SplitK split_k(int blocks, int K, int BK) {
  const int ksteps = (K + BK - 1) / BK;
  int s = (TARGET_BLOCKS + blocks - 1) / blocks;
  s = s < MAX_SPLITS ? s : MAX_SPLITS;
  const int half = (ksteps + 1) / 2;  // keep at least two steps per range
  s = s < half ? s : half;
  s = s > 1 ? s : 1;
  const int steps = (ksteps + s - 1) / s;
  return {(ksteps + steps - 1) / steps, steps};
}

// Register staging of one K step's tiles: every thread first issues all of
// its global loads (independent, so they overlap in flight), then writes
// them to shared memory. Loading step k+1 into registers while step k is
// computed from shared memory hides the load latency behind the FMAs.
//   x tile: rows [m0, m0+BM) x k in [k0, k0+BK) of the (rows x K) operand,
//           into xs[BK][BM+1], transposed (the +1 keeps the transposing
//           stores free of bank conflicts);
//   w tile: k in [k0, k0+BK) x columns [l0, l0+BN) of the (K x L) operand,
//           into ws[BK][BN+1].
// Entries with k >= kend (the end of this block's K range), rows >= `rows`
// or columns >= L are 0. The element a thread loads follows the operand's
// adjacent index (FAST_I), so a transposed view loads as coalesced as a
// row-major one.
template <class TL, class XS, class WS>
struct Stager {
  static constexpr int XN = (TL::BM * TL::BK + TL::THREADS - 1) / TL::THREADS;
  static constexpr int WN = (TL::BK * TL::BN + TL::THREADS - 1) / TL::THREADS;
  float xr[XN], wr[WN];

  static __device__ __forceinline__ void x_at(int i, int& r, int& kk) {
    if (XS::FAST_I) { r = i % TL::BM; kk = i / TL::BM; } else { r = i / TL::BK; kk = i % TL::BK; }
  }
  static __device__ __forceinline__ void w_at(int i, int& kk, int& c) {
    if (WS::FAST_I) { kk = i % TL::BK; c = i / TL::BK; } else { kk = i / TL::BN; c = i % TL::BN; }
  }

  __device__ __forceinline__ void load(const XS& x, int rows, int m0, const WS& w, int L, int l0,
                                       int k0, int kend) {
#pragma unroll
    for (int u = 0; u < XN; ++u) {
      const int i = threadIdx.x + u * TL::THREADS;
      int r, kk;
      x_at(i, r, kk);
      const int gm = m0 + r, gk = k0 + kk;
      xr[u] = (i < TL::BM * TL::BK && gm < rows && gk < kend) ? x(gm, gk) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < WN; ++u) {
      const int i = threadIdx.x + u * TL::THREADS;
      int kk, c;
      w_at(i, kk, c);
      const int gk = k0 + kk, gl = l0 + c;
      wr[u] = (i < TL::BK * TL::BN && gk < kend && gl < L) ? w(gk, gl) : 0.f;
    }
  }

  __device__ __forceinline__ void store(float (*xs)[TL::BM + 1], float (*ws)[TL::BN + 1]) const {
#pragma unroll
    for (int u = 0; u < XN; ++u) {
      const int i = threadIdx.x + u * TL::THREADS;
      int r, kk;
      x_at(i, r, kk);
      if (i < TL::BM * TL::BK) xs[kk][r] = xr[u];
    }
#pragma unroll
    for (int u = 0; u < WN; ++u) {
      const int i = threadIdx.x + u * TL::THREADS;
      int kk, c;
      w_at(i, kk, c);
      if (i < TL::BK * TL::BN) ws[kk][c] = wr[u];
    }
  }
};

// acc[i][j] += sum over the staged step of xs[kk][row i] * ws[kk][column j].
template <class TL>
__device__ __forceinline__ void fma_step(float (&acc)[TL::TM][TL::TN], float (*xs)[TL::BM + 1],
                                         float (*ws)[TL::BN + 1], int tr, int tc) {
#pragma unroll
  for (int kk = 0; kk < TL::BK; ++kk) {
    float xv[TL::TM], wv[TL::TN];
#pragma unroll
    for (int i = 0; i < TL::TM; ++i) xv[i] = xs[kk][tr * TL::TM + i];
#pragma unroll
    for (int j = 0; j < TL::TN; ++j) wv[j] = ws[kk][tc + j * TL::COLS];
#pragma unroll
    for (int i = 0; i < TL::TM; ++i)
#pragma unroll
      for (int j = 0; j < TL::TN; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
  }
}

// out[n] = scale[n] * (x[n] @ w[n]) over one K range per block: x (N, M, K)
// and w (N, K, L) read through their sources (adapter n's matrices start
// n * M * K and n * K * L elements in), out (N, M, L) row-major. Grid
// (L tiles, M tiles, N * splits); block z = s * N + n covers K steps
// [s * steps, (s + 1) * steps). With `part` the block writes its f32
// partial sums to part[s][n][m][l] (a second kernel adds the ranges in
// order); without, it writes cast(acc * scale[n]) to out (scale may be
// null: 1). Tiles are staged through registers, the next step's loads in
// flight while the current step is multiplied.
template <class TL, typename T, class XS, class WS>
__global__ void __launch_bounds__(TL::THREADS)
gemm_kernel(XS x, WS w, const float* __restrict__ scale, T* __restrict__ out,
            float* __restrict__ part, int N, int M, int K, int L, int steps) {
  __shared__ float xs[TL::BK][TL::BM + 1];
  __shared__ float ws[TL::BK][TL::BN + 1];
  const int n = blockIdx.z % N, s = blockIdx.z / N;
  const int m0 = blockIdx.y * TL::BM, l0 = blockIdx.x * TL::BN;
  const int kb = s * steps * TL::BK, ke = min(K, kb + steps * TL::BK);
  const XS xn = x.shift((size_t)n * M * K);
  const WS wn = w.shift((size_t)n * K * L);
  const int tr = threadIdx.x / TL::COLS, tc = threadIdx.x % TL::COLS;

  float acc[TL::TM][TL::TN];
#pragma unroll
  for (int i = 0; i < TL::TM; ++i)
#pragma unroll
    for (int j = 0; j < TL::TN; ++j) acc[i][j] = 0.f;

  Stager<TL, XS, WS> st;
  st.load(xn, M, m0, wn, L, l0, kb, ke);
  for (int k0 = kb; k0 < ke; k0 += TL::BK) {
    st.store(xs, ws);
    __syncthreads();
    if (k0 + TL::BK < ke) st.load(xn, M, m0, wn, L, l0, k0 + TL::BK, ke);
    fma_step<TL>(acc, xs, ws, tr, tc);
    __syncthreads();
  }

  const float sc = scale ? scale[n] : 1.f;
#pragma unroll
  for (int i = 0; i < TL::TM; ++i) {
    const int gm = m0 + tr * TL::TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TL::TN; ++j) {
      const int gl = l0 + tc + j * TL::COLS;
      if (gl >= L) continue;
      const size_t e = ((size_t)n * M + gm) * L + gl;
      if (part)
        part[(size_t)s * N * M * L + e] = acc[i][j];
      else
        out[e] = from_f32<T>(acc[i][j] * sc);
    }
  }
}

// The tile for an (N, M, K) x (N, K, L) call: thin for decode's few rows.
inline bool thin_rows(int m) { return m <= ThinTile::BM; }

template <class TL>
inline SplitK gemm_plan(int n, int m, int k, int l) {
  return split_k(n * ((m + TL::BM - 1) / TL::BM) * ((l + TL::BN - 1) / TL::BN), k, TL::BK);
}

inline SplitK gemm_plan_for(int n, int m, int k, int l) {
  return thin_rows(m) ? gemm_plan<ThinTile>(n, m, k, l) : gemm_plan<WideTile>(n, m, k, l);
}

// Launch gemm_kernel with the tile and split plan of gemm_plan_for.
template <typename T, class XS, class WS>
inline void launch_gemm(XS x, WS w, const float* scale, T* out, float* part, int n, int m, int k,
                        int l, cudaStream_t stream) {
  const SplitK sk = gemm_plan_for(n, m, k, l);
  if (thin_rows(m)) {
    const dim3 grid((l + ThinTile::BN - 1) / ThinTile::BN, (m + ThinTile::BM - 1) / ThinTile::BM,
                    n * sk.splits);
    gemm_kernel<ThinTile, T, XS, WS><<<grid, ThinTile::THREADS, 0, stream>>>(
        x, w, scale, out, part, n, m, k, l, sk.steps);
  } else {
    const dim3 grid((l + WideTile::BN - 1) / WideTile::BN, (m + WideTile::BM - 1) / WideTile::BM,
                    n * sk.splits);
    gemm_kernel<WideTile, T, XS, WS><<<grid, WideTile::THREADS, 0, stream>>>(
        x, w, scale, out, part, n, m, k, l, sk.steps);
  }
}

// Returned when a TMA descriptor cannot be encoded: ERR_TENSOR_MAP + the
// driver's CUresult (ERR_TENSOR_MAP alone: no cuTensorMapEncodeTiled).
constexpr int ERR_TENSOR_MAP = 100000;

}  // namespace plora

extern "C" const char* plora_error_string(int code) {
  if (code >= plora::ERR_TENSOR_MAP) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - plora::ERR_TENSOR_MAP);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
