// packed_matmul.cu's PATH_F32SKINNY ("f32skinny"): out[n] = scale[n] * (x[n] @ w[n])
// for f32 calls with more than 16 rows per adapter (training and prefill),
// where one of the product's two outer sizes is a LoRA rank. It replaces,
// for these shapes, the Pallas TPU kernel src/repro/kernels/packed_matmul.py
// (packed_matmul -> pl.pallas_call at :89, _matmul_kernel) in its f32
// uses: the forward delta's two grouped products and the backward's cases 2
// and 4 on transposed weights read in place. Two shape classes, each one
// launch with no workspace and no atomics:
//
//   narrow  -- L <= 128, K long: xA (x @ A) and case 2 (g_s @ B^T, B^T read
//              from B's (r x K) storage). A block owns FN_BM = 16 rows by the
//              whole width L (8, 16, 32, 64 or 128: no masked columns beyond
//              the rank's width class) for one range of K. x streams through
//              a ring of FN_STAGES stages of dynamic shared memory by 16-byte
//              cp.async (FN_STAGES - 1 stages in flight), w's FN_BK x BL
//              slice beside it; each thread holds 4 (or 8) rows x 4 columns
//              of f32 sums in registers and reads its operands as float4
//              along k (w^T's columns are k-contiguous, so both layouts read
//              4 x 4 blocks). When the width leaves threads over, the block's
//              threads split each stage's k among k groups, added in group
//              order. The K ranges of one row tile form a thread-block
//              cluster, whose blocks add their partial sums in rank order
//              through distributed shared memory (as skinny.cuh's narrow
//              kernel does in bf16), then scale once.
//   short K -- K = r <= 128, L wide: (xA) @ B and case 4 (d(xA) @ A^T, A^T
//              read from A's (L x r) storage). One wave of resident blocks,
//              each owning FS_BM = 64 rows of one adapter and a run of
//              FS_BN = 64-column tiles: its (64 x r) x tile is loaded into
//              shared memory once, w's (r x 64) strips stream through a ring
//              by cp.async (A^T's strips arrive as [l][k], r-contiguous, and
//              are transposed in shared memory), each thread forms 4 rows x
//              4 columns with f32 FMAs in k order, scales and writes them as
//              16-byte stores.
//
// What bounds both on an H100: bytes at 3.35 TB/s. Narrow reads x (M x K
// f32) once: at r = 16 one 16-byte load of x feeds 64 FFMAs, so the FP32
// pipes (67 TFLOP/s) are not the limit; the design keeps 3 stages of x in
// flight on every SM and reads shared memory as float4 (8 loads a 64-FMA
// step). Short K writes the (M x L) f32 output once (77.6 MB at qwen25-7b's
// gate/up with 1,024 rows): coalesced 16-byte stores from every SM at once.
//
// Rounding: f32 sums in a fixed order, then the f32 scale -- the TPU
// kernel's (its one cast is the identity in f32); no TF32. Every call gives
// the same bits.
#pragma once

#include <cooperative_groups.h>

#include "skinny.cuh"

namespace plora {

// (the plan's constants, FN_BM, FN_BK and the split limits, are in
// skinny.cuh beside skinny_plan)
constexpr int FN_THREADS = 128, FN_STAGES = 4;
constexpr int FN_XP = FN_BK + 4;  // x tile row pitch (floats): an odd number of 16-byte units
constexpr int FS_THREADS = 256, FS_BM = 64, FS_BN = 64, FS_STAGES = 3;

// the q-th element of a float4 (q a constant after unrolling)
__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// --- narrow class ------------------------------------------------------------

template <int BL, bool TW>
struct FNarrow {
  static constexpr int TM = BL == 128 ? 8 : 4;          // rows a thread
  static constexpr int RG = FN_BM / TM;                 // row groups
  static constexpr int CG = BL / 4;                     // column groups, 4 columns each
  static constexpr int KG = FN_THREADS / (RG * CG);     // k groups
  static constexpr int KK = FN_BK / KG;                 // k a group takes of each stage
  static constexpr int X_ELEMS = FN_BM * FN_XP;         // [m][k]
  static constexpr int WP = TW ? FN_BK + 4 : BL;        // w's pitch: [l][k] (TW) or [k][l]
  static constexpr int W_ELEMS = TW ? BL * WP : FN_BK * BL;
  static constexpr int STAGE = X_ELEMS + W_ELEMS;
  static constexpr int RED = KG * FN_BM * BL;           // the k groups' sums
  static constexpr int SMEM = (FN_STAGES * STAGE > RED ? FN_STAGES * STAGE : RED) * 4;
  static_assert(KG >= 1 && KG * RG * CG == FN_THREADS && KK % 4 == 0, "narrow f32 geometry");
};

// Grid (row tiles, N, splits), clusters of (1, 1, splits). Block (t, n, s)
// sums rows [16 t, 16 t + 16) of x[n] @ w[n] over K steps [s * steps,
// (s + 1) * steps) of FN_BK. Thread (kg, rg, cg) owns rows rg + i * RG and
// columns cg * 4 + j (w row-major) or cg + j * CG (TW), over k group kg's
// share of each stage: one k group's float4 reads of shared memory hit
// distinct banks (x's and w^T's row pitches are odd in 16-byte units; a
// row of w is read whole).
template <int BL, bool TW>
__global__ void __launch_bounds__(FN_THREADS)
f32_narrow_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ out, int M, int K, int L,
                  int steps) {
  using C = FNarrow<BL, TW>;
  extern __shared__ __align__(16) float fsm[];
  const int n = blockIdx.y, s = blockIdx.z, m0 = blockIdx.x * FN_BM;
  const int kb = s * steps * FN_BK, ke = min(K, kb + steps * FN_BK);
  const int nsteps = (ke - kb + FN_BK - 1) / FN_BK;
  const float* xn = x + (size_t)n * M * K;
  const float* wn = w + (size_t)n * K * L;
  const int tid = threadIdx.x;
  const int kg = tid / (C::RG * C::CG), rg = (tid / C::CG) % C::RG, cg = tid % C::CG;

  // one stage: x rows [m0, m0 + BM) and w's k rows [k0, k0 + BK); rows >= M,
  // k >= ke and columns >= L read as 0 (K and L are multiples of 4, so a
  // 16-byte copy is wholly inside or outside)
  auto load = [&](int stage, int k0) {
    float* xs = fsm + stage * C::STAGE;
    float* ws = xs + C::X_ELEMS;
    constexpr int XC = FN_BM * FN_BK / 4;
#pragma unroll
    for (int u = 0; u < XC / FN_THREADS; ++u) {
      const int c = tid + u * FN_THREADS, r = c / (FN_BK / 4), kc = (c % (FN_BK / 4)) * 4;
      const bool ok = m0 + r < M && k0 + kc < ke;
      cp_async16(xs + r * FN_XP + kc, ok ? xn + (size_t)(m0 + r) * K + k0 + kc : xn, ok);
    }
    constexpr int WC = FN_BK * BL / 4;
#pragma unroll
    for (int u = 0; u < (WC + FN_THREADS - 1) / FN_THREADS; ++u) {
      const int c = tid + u * FN_THREADS;
      if (WC % FN_THREADS != 0 && c >= WC) break;
      if (TW) {  // w stored (L, K): column l of the tile, k contiguous
        const int l = c / (FN_BK / 4), kc = (c % (FN_BK / 4)) * 4;
        const bool ok = l < L && k0 + kc < ke;
        cp_async16(ws + l * C::WP + kc, ok ? wn + (size_t)l * K + k0 + kc : wn, ok);
      } else {
        const int k = c / (BL / 4), lc = (c % (BL / 4)) * 4;
        const bool ok = k0 + k < ke && lc < L;
        cp_async16(ws + k * BL + lc, ok ? wn + (size_t)(k0 + k) * L + lc : wn, ok);
      }
    }
  };

  float acc[C::TM][4];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < FN_STAGES - 1; ++st) {
    if (st < nsteps) load(st, kb + st * FN_BK);
    cp_async_commit();
  }
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<FN_STAGES - 2>();  // step t's copies have landed (this thread's) ...
    __syncthreads();                 // ... and everyone's; step t - 1's stage is free
    const int nt = t + FN_STAGES - 1;
    if (nt < nsteps) load(nt % FN_STAGES, kb + nt * FN_BK);
    cp_async_commit();
    const float* xs = fsm + (t % FN_STAGES) * C::STAGE;
    const float* ws = xs + C::X_ELEMS;
#pragma unroll
    for (int q4 = 0; q4 < C::KK / 4; ++q4) {
      const int kk = kg * C::KK + q4 * 4;
      float4 xv[C::TM], wv[4];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + (rg + i * C::RG) * FN_XP + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)  // TW: w^T's column j, k .. k + 3; else w's row k + j
        wv[j] = TW ? *reinterpret_cast<const float4*>(ws + (cg + j * C::CG) * C::WP + kk)
                   : *reinterpret_cast<const float4*>(ws + (kk + j) * BL + cg * 4);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < C::TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(lane4(xv[i], q), TW ? lane4(wv[j], q) : lane4(wv[q], j), acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // the k groups' sums [KG][BM][BL], then the block's: groups added in order
  __syncthreads();  // the ring is consumed: the sums take its place
  float* red = fsm;
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(kg * FN_BM + rg + i * C::RG) * BL + (TW ? cg + j * C::CG : cg * 4 + j)] = acc[i][j];
  __syncthreads();
  const float sc = scale ? scale[n] : 1.f;
  float* on = out + (size_t)n * M * L;
  const int cs = (int)gridDim.z;
  for (int e = tid; e < FN_BM * BL; e += FN_THREADS) {
    float v = red[e];
#pragma unroll
    for (int g = 1; g < C::KG; ++g) v += red[g * FN_BM * BL + e];
    const int r = e / BL, c = e % BL;
    if (cs > 1)
      red[e] = v;
    else if (m0 + r < M && c < L)  // one K range: the block's sums are final
      on[(size_t)(m0 + r) * L + c] = v * sc;
  }
  if (cs == 1) return;
  namespace cg_ns = cooperative_groups;
  cg_ns::cluster_group cluster = cg_ns::this_cluster();
  cluster.sync();  // every block's sums are written (and every block has started)
  for (int e = s * FN_THREADS + tid; e < FN_BM * BL; e += cs * FN_THREADS) {
    const int r = e / BL, c = e % BL;
    if (m0 + r >= M || c >= L) continue;
    float v[FN_MAX_SPLITS];  // every block's sum in flight at once, then added in rank order
#pragma unroll
    for (int q = 0; q < FN_MAX_SPLITS; ++q)
      v[q] = q < cs ? cluster.map_shared_rank(red, q)[e] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < FN_MAX_SPLITS; ++q)
      if (q < cs) sum += v[q];
    on[(size_t)(m0 + r) * L + c] = sum * sc;
  }
  cluster.sync();  // no block leaves while another still reads its sums
}

// --- short-K class -------------------------------------------------------------

template <int RK, bool TW>
struct FShortK {
  static constexpr int XP = RK + 4;                    // x tile pitch: [m][k]
  static constexpr int X_ELEMS = FS_BM * XP;
  static constexpr int SP = TW ? RK + 4 : FS_BN;       // a ring stage's pitch: [l][k] (TW) or [k][l]
  static constexpr int S_ELEMS = TW ? FS_BN * SP : RK * FS_BN;
  static constexpr int T_ELEMS = TW ? RK * FS_BN : 0;  // TW: the stage transposed to [k][l]
  static constexpr int SMEM = (X_ELEMS + FS_STAGES * S_ELEMS + T_ELEMS) * 4;
  static_assert(SMEM <= 232448, "short-K f32 shared memory");
};

// Grid (column groups, row tiles, N). Block (g, t, n) computes rows [64 t,
// 64 t + 64) of adapter n for the 64-column tiles [g * tpb, min((g + 1) *
// tpb, tiles)). Thread (tr, tc) owns rows tr + 16 i and columns 4 tc .. 4 tc
// + 3 of a tile. k >= K and rows >= M read as 0; RK is K's width class.
template <int RK, bool TW>
__global__ void __launch_bounds__(FS_THREADS)
f32_short_k_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ out, int M, int K, int L,
                   int tpb) {
  using C = FShortK<RK, TW>;
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;
  float* ring = xs + C::X_ELEMS;
  float* wt = ring + FS_STAGES * C::S_ELEMS;  // TW only
  const int n = blockIdx.z, m0 = blockIdx.y * FS_BM;
  const int tiles = (L + FS_BN - 1) / FS_BN;
  const int j0 = blockIdx.x * tpb, nj = min(tiles, j0 + tpb) - j0;
  const float* xn = x + (size_t)n * M * K;
  const float* wn = w + (size_t)n * K * L;
  float* on = out + (size_t)n * M * L;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;

  constexpr int XC = FS_BM * RK / 4;
#pragma unroll
  for (int u = 0; u < (XC + FS_THREADS - 1) / FS_THREADS; ++u) {
    const int c = tid + u * FS_THREADS;
    if (XC % FS_THREADS != 0 && c >= XC) break;
    const int r = c / (RK / 4), kc = (c % (RK / 4)) * 4;
    const bool ok = m0 + r < M && kc < K;
    cp_async16(xs + r * C::XP + kc, ok ? xn + (size_t)(m0 + r) * K + kc : xn, ok);
  }
  // the (r x 64) strip of w at columns [l0, l0 + 64)
  auto load = [&](int stage, int l0) {
    float* sb = ring + stage * C::S_ELEMS;
    constexpr int WC = RK * FS_BN / 4;
#pragma unroll
    for (int u = 0; u < (WC + FS_THREADS - 1) / FS_THREADS; ++u) {
      const int c = tid + u * FS_THREADS;
      if (WC % FS_THREADS != 0 && c >= WC) break;
      if (TW) {  // w stored (L, K): column l of the strip, k contiguous
        const int l = c / (RK / 4), kc = (c % (RK / 4)) * 4;
        const bool ok = l0 + l < L && kc < K;
        cp_async16(sb + l * C::SP + kc, ok ? wn + (size_t)(l0 + l) * K + kc : wn, ok);
      } else {
        const int k = c / (FS_BN / 4), lc = (c % (FS_BN / 4)) * 4;
        const bool ok = k < K && l0 + lc < L;
        cp_async16(sb + k * FS_BN + lc, ok ? wn + (size_t)k * L + l0 + lc : wn, ok);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < FS_STAGES - 1; ++st) {
    if (st < nj) load(st, (j0 + st) * FS_BN);
    cp_async_commit();  // group 0 also carries the x tile
  }
  const float sc = scale ? scale[n] : 1.f;
  for (int t = 0; t < nj; ++t) {
    cp_async_wait<FS_STAGES - 2>();
    __syncthreads();  // tile t's strip is everyone's; tile t - 1's stage (and wt) are free
    const int nt = t + FS_STAGES - 1;
    if (nt < nj) load(nt % FS_STAGES, (j0 + nt) * FS_BN);
    cp_async_commit();
    const float* ws = ring + (t % FS_STAGES) * C::S_ELEMS;
    if (TW) {  // [l][k] -> [k][l]: neighbouring threads take neighbouring l
      constexpr int TC = RK * FS_BN / 4;
#pragma unroll
      for (int u = 0; u < (TC + FS_THREADS - 1) / FS_THREADS; ++u) {
        const int c = tid + u * FS_THREADS;
        if (TC % FS_THREADS != 0 && c >= TC) break;
        const int l = c % FS_BN, kc = (c / FS_BN) * 4;
        const float4 v = *reinterpret_cast<const float4*>(ws + l * C::SP + kc);
        wt[(kc + 0) * FS_BN + l] = v.x;
        wt[(kc + 1) * FS_BN + l] = v.y;
        wt[(kc + 2) * FS_BN + l] = v.z;
        wt[(kc + 3) * FS_BN + l] = v.w;
      }
      __syncthreads();
      ws = wt;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int k = 0; k < RK; k += 4) {
      float4 xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + (tr + 16 * i) * C::XP + k);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wv[q] = *reinterpret_cast<const float4*>(ws + (k + q) * FS_BN + tc * 4);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(lane4(xv[i], q), lane4(wv[q], j), acc[i][j]);
    }
    const int gl = (j0 + t) * FS_BN + tc * 4;
    if (gl < L) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gm = m0 + tr + 16 * i;
        if (gm < M)
          *reinterpret_cast<float4*>(on + (size_t)gm * L + gl) =
              make_float4(acc[i][0] * sc, acc[i][1] * sc, acc[i][2] * sc, acc[i][3] * sc);
      }
    }
  }
  cp_async_wait<0>();
}

// --- launch --------------------------------------------------------------------

template <int BL, bool TW>
inline cudaError_t launch_f32_narrow(const float* x, const float* w, const float* scale,
                                     float* out, int n, int m, int k, int l, const SkinnyPlan& p,
                                     cudaStream_t stream) {
  using C = FNarrow<BL, TW>;
  static PerDevice once;
  const cudaError_t attr = (cudaError_t)once.get([] {
    return (int)cudaFuncSetAttribute(f32_narrow_kernel<BL, TW>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  });
  if (attr != cudaSuccess) return attr;
  // the K ranges of one row tile form one cluster (1 x 1 x splits)
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = p.splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((m + FN_BM - 1) / FN_BM, n, p.splits);
  cfg.blockDim = dim3(FN_THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, f32_narrow_kernel<BL, TW>, x, w, scale, out, m, k, l, p.steps);
}

template <int RK, bool TW>
inline cudaError_t launch_f32_short_k(const float* x, const float* w, const float* scale,
                                      float* out, int n, int m, int k, int l,
                                      cudaStream_t stream) {
  using C = FShortK<RK, TW>;
  // resident blocks per SM at this kernel's registers and shared memory
  static PerDevice occupancy;
  const int per_sm = occupancy.get([] {
    if (cudaFuncSetAttribute(f32_short_k_kernel<RK, TW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM) != cudaSuccess)
      return 0;
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, f32_short_k_kernel<RK, TW>, FS_THREADS,
                                                  C::SMEM);
    return b;
  });
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  // one wave of resident blocks, each walking a run of column tiles
  const int rows = (m + FS_BM - 1) / FS_BM, tiles = (l + FS_BN - 1) / FS_BN;
  const long long target = (long long)SMS * per_sm;
  int tpb = (int)(((long long)n * rows * tiles + target - 1) / target);
  tpb = tpb < tiles ? tpb : tiles;
  while (tpb < tiles && (long long)n * rows * ((tiles + tpb - 1) / tpb) > target) ++tpb;
  const dim3 grid((tiles + tpb - 1) / tpb, rows, n);
  f32_short_k_kernel<RK, TW><<<grid, FS_THREADS, C::SMEM, stream>>>(x, w, scale, out, m, k, l,
                                                                     tpb);
  return cudaSuccess;
}

template <bool TW>
inline cudaError_t launch_f32_tw(const float* x, const float* w, const float* scale, float* out,
                                 int n, int m, int k, int l, const SkinnyPlan& p,
                                 cudaStream_t st) {
  if (p.cls == CLASS_NARROW) {
    switch (p.width) {
      case 8: return launch_f32_narrow<8, TW>(x, w, scale, out, n, m, k, l, p, st);
      case 16: return launch_f32_narrow<16, TW>(x, w, scale, out, n, m, k, l, p, st);
      case 32: return launch_f32_narrow<32, TW>(x, w, scale, out, n, m, k, l, p, st);
      case 64: return launch_f32_narrow<64, TW>(x, w, scale, out, n, m, k, l, p, st);
      default: return launch_f32_narrow<128, TW>(x, w, scale, out, n, m, k, l, p, st);
    }
  }
  switch (p.width) {
    case 8: return launch_f32_short_k<8, TW>(x, w, scale, out, n, m, k, l, st);
    case 16: return launch_f32_short_k<16, TW>(x, w, scale, out, n, m, k, l, st);
    case 32: return launch_f32_short_k<32, TW>(x, w, scale, out, n, m, k, l, st);
    case 64: return launch_f32_short_k<64, TW>(x, w, scale, out, n, m, k, l, st);
    default: return launch_f32_short_k<128, TW>(x, w, scale, out, n, m, k, l, st);
  }
}

// One call on the f32skinny path: x row-major, w row-major or (trans_w)
// stored (N, L, K). Refuses (cudaErrorInvalidValue) grids past CUDA's
// limits rather than launching part of them.
inline cudaError_t launch_f32skinny(const float* x, const float* w, const float* scale,
                                    float* out, int n, int m, int k, int l, bool tw,
                                    const SkinnyPlan& p, cudaStream_t st) {
  if (n > 65535 || (m + FS_BM - 1) / FS_BM > 65535) return cudaErrorInvalidValue;
  return tw ? launch_f32_tw<true>(x, w, scale, out, n, m, k, l, p, st)
            : launch_f32_tw<false>(x, w, scale, out, n, m, k, l, p, st);
}

}  // namespace plora
