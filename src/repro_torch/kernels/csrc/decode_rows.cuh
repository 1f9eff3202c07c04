// packed_matmul.cu's PATH_DECODE: out[n] = scale[n] * (x[n] @ w[n]) for bf16
// calls with at most 16 rows per adapter (decode: 8 adapters x 1 token),
// where one of the product's two outer sizes is a LoRA rank. Two shape
// classes, each one launch with no workspace and no atomics:
//
//   narrow  -- L <= 128, K long: xA = x @ A. Block (0, n, s) streams the s-th
//              of S ranges of A[n]'s K rows once: 16-byte cp.async copies
//              into a ring of DR_STAGES stages of 16 KB, DR_STAGES - 1 in
//              flight, with the matching x columns beside them. Each stage
//              is (16 k x 16 l) pieces of A; a warp reads a piece as A^T by
//              ldmatrix.trans and multiplies it by x^T with mma.sync
//              m16n8k16 (x's rows are mma's n = 8; 16 rows take two), f32
//              sums in registers. Then the warps' sums are added in warp
//              order, and the S blocks of the thread-block cluster add
//              theirs in rank order through distributed shared memory; each
//              block scales and casts a share of the output. S fills the
//              card (N x S blocks, S <= DR_MAX_SPLITS).
//   short K -- K = r <= 128, L wide: (xA) @ B. Block (j, n) owns a strip of
//              `vb` 8-column vectors of adapter n's output: it issues every
//              16-byte cp.async copy of B[n]'s strip (K rows) at once, stages
//              x[n] (M x K) in shared memory as f32, and forms
//              cast(scale[n] * sum_q x[m][q] * B[q][col]) with f32 FMAs in q
//              order, one thread per row and vector; 16-byte stores. The
//              strips fill the card in one wave (DR_SLOTS blocks, one per
//              SM, each strip at least DR_MIN_COPIES vectors of B).
//
// The two passes of one LoRA delta run as a pair (plora_packed_lora_delta):
// the narrow pass writes xA in bf16 and lets its dependent start
// (griddepcontrol.launch_dependents); the short-K pass is a programmatic
// dependent launch that copies its strip of B meanwhile and waits
// (griddepcontrol.wait) before it reads x -- before that it reads only B and
// writes nothing. A single call never launches as a dependent, so its wait
// returns at once.
//
// What bounds both on an H100: bytes, and at qwen25-7b's decode sizes the
// fixed costs (launch, one memory round trip, the cluster's sums): a layer's
// fourteen calls read ~23 MB (7.3 us at 3.35 TB/s). Rounding: f32 sums in a
// fixed order, then the f32 scale, then one round-to-nearest-even cast, the
// TPU kernel's; every call gives the same bits, and a row's bits do not
// depend on how many rows the call has.
#pragma once

#include <cooperative_groups.h>

#include "skinny.cuh"

namespace plora {

// (the plan's constants, DR_MAX_SPLITS, DR_SLOTS and DR_MAX_STRIP, are in
// skinny.cuh beside skinny_plan)
constexpr int DR_THREADS = 256, DR_WARPS = DR_THREADS / 32;
constexpr int DR_STAGE_ELEMS = 8192;  // A elements of a narrow stage (16 KB)
constexpr int DR_STAGES = 4;          // the narrow ring: 3 stages in flight

// Programmatic dependent launch (PTX griddepcontrol); both are no-ops in a
// grid that was not launched as, or has no, dependent.
__device__ __forceinline__ void dr_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void dr_wait_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// --- narrow class --------------------------------------------------------------

template <int BL, int RM>
struct DecNarrow {
  static constexpr int BK = DR_STAGE_ELEMS / BL;  // K rows of a stage
  static constexpr int CH = BL / 8;               // 16-byte chunks of an A row
  static constexpr int XP = BK + 8;               // staged x row pitch (bf16)
  static constexpr int W_ELEMS = BK * BL, X_ELEMS = RM * XP;
  static constexpr int STAGE = W_ELEMS + X_ELEMS;
  static constexpr int CT = BL / 16;              // 16-column tiles
  static constexpr int KW = DR_WARPS / CT;        // warps along K per column tile
  static constexpr int RN = RM / 8;               // mma n-tiles of x's rows
  static constexpr int RING = DR_STAGES * STAGE * 2;
  static constexpr int SUMS = (DR_WARPS * RM * 16 + RM * BL) * 4;
  static constexpr int SMEM = RING > SUMS ? RING : SUMS;
  static_assert(BK % 16 == 0 && DR_WARPS % CT == 0, "narrow geometry");

  // where chunk c of stage row k lies: the chunk index XOR-ed with the row's
  // low bits, so the 8 rows one ldmatrix reads hit 8 different bank groups
  static __device__ __forceinline__ int at(int k, int c) {
    const int sw = CH >= 8 ? (k & 7) : ((k / (8 / CH)) & (CH - 1));
    return k * BL + ((c ^ sw) << 3);
  }
};

// Grid (1, N, S), clusters of (1, 1, S). Block (0, n, s) sums x[n] @ A[n] over
// K rows [s * rows, min(K, (s + 1) * rows)), BK rows a stage. Warp w owns
// column tile w % CT and every KW-th 16-row piece of a stage from w / CT.
template <int BL, int RM>
__global__ void __launch_bounds__(DR_THREADS, 1)
decode_narrow_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const float* __restrict__ scale, bf16* __restrict__ out, int M, int K, int L,
                     int rows) {
  using C = DecNarrow<BL, RM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  dr_launch_dependents();  // a paired (xA)B pass may start: it reads xA only after waiting

  const int n = blockIdx.y, s = blockIdx.z;
  const int kb = s * rows, ke = min(K, kb + rows);
  const int nsteps = (ke - kb + C::BK - 1) / C::BK;
  const bf16* xn = x + (size_t)n * M * K;
  const bf16* wn = w + (size_t)n * K * L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // x's rows past M stay zero in every stage the range uses (mma reads RM
  // rows), 16 bytes a store
  constexpr int XV = C::XP / 8;  // 16-byte vectors of a staged x row
  const int zs = min(nsteps, DR_STAGES), zv = (RM - M) * XV;
  for (int e = tid; e < zs * zv; e += DR_THREADS)
    *reinterpret_cast<uint4*>(smem + (e / zv) * C::STAGE + C::W_ELEMS + M * C::XP +
                              8 * (e % zv)) = make_uint4(0, 0, 0, 0);

  auto load = [&](int stage, int k0) {
    bf16* ws = smem + stage * C::STAGE;
    bf16* xs = ws + C::W_ELEMS;
#pragma unroll
    for (int u = 0; u < C::BK * C::CH / DR_THREADS; ++u) {
      const int e = tid + u * DR_THREADS, k = e / C::CH, c = e % C::CH;
      const bool ok = k0 + k < ke && c * 8 < L;
      cp_async16(ws + C::at(k, c), ok ? wn + (size_t)(k0 + k) * L + c * 8 : wn, ok);
    }
    for (int e = tid; e < M * (C::BK / 8); e += DR_THREADS) {
      const int r = e / (C::BK / 8), kc = (e % (C::BK / 8)) * 8;
      const bool ok = k0 + kc < ke;
      cp_async16(xs + r * C::XP + kc, ok ? xn + (size_t)r * K + k0 + kc : xn, ok);
    }
  };

  const int ct = warp % C::CT, kw = warp / C::CT;
  const int g = lane >> 2, q = lane & 3, lj = lane >> 3, lr = lane & 7;
  float d[C::RN][4];
#pragma unroll
  for (int rb = 0; rb < C::RN; ++rb)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[rb][e] = 0.f;

#pragma unroll
  for (int st = 0; st < DR_STAGES - 1; ++st) {
    if (st < nsteps) load(st, kb + st * C::BK);
    cp_async_commit();
  }
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<DR_STAGES - 2>();  // step t's copies have landed (this thread's) ...
    __syncthreads();                 // ... and everyone's; step t - 1's stage is free
    const int nt = t + DR_STAGES - 1;
    if (nt < nsteps) load(nt % DR_STAGES, kb + nt * C::BK);
    cp_async_commit();
    const bf16* ws = smem + (t % DR_STAGES) * C::STAGE;
    const bf16* xs = ws + C::W_ELEMS;
#pragma unroll
    for (int kt = kw; kt < C::BK / 16; kt += C::KW) {
      // A^T's piece (16 l x 16 k): matrices (k, l) (k, l+8) (k+8, l) (k+8, l+8), transposed
      uint32_t a[4];
      ldsm_x4<true>(a, ws + C::at(kt * 16 + 8 * (lj >> 1) + lr, 2 * ct + (lj & 1)));
#pragma unroll
      for (int rb = 0; rb < C::RN; ++rb) {  // x^T: k 2q, 2q + 1 (+ 8) of row 8 rb + g
        const bf16* xr = xs + (rb * 8 + g) * C::XP + kt * 16 + 2 * q;
        mma_bf16(d[rb], a, *reinterpret_cast<const uint32_t*>(xr),
                 *reinterpret_cast<const uint32_t*>(xr + 8));
      }
    }
  }
  cp_async_wait<0>();

  // d[rb][e]: column 16 ct + g + 8 (e / 2), row 8 rb + 2 q + e % 2. The
  // warps' sums [warp][RM][16], then the block's [M][BL], a column's warps
  // in order.
  __syncthreads();  // the ring is consumed: the sums take its place
  float* wsum = reinterpret_cast<float*>(smem_raw);
  float* part = wsum + DR_WARPS * RM * 16;
#pragma unroll
  for (int rb = 0; rb < C::RN; ++rb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wsum[(warp * RM + rb * 8 + 2 * q + (e & 1)) * 16 + g + 8 * (e >> 1)] = d[rb][e];
  __syncthreads();
  const float sc = scale ? scale[n] : 1.f;
  bf16* on = out + (size_t)n * M * L;
  const int cs = (int)gridDim.z;
  for (int e = tid; e < M * BL; e += DR_THREADS) {
    const int r = e / BL, c = e % BL;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < C::KW; ++j) v += wsum[((c / 16 + j * C::CT) * RM + r) * 16 + c % 16];
    if (cs > 1)
      part[e] = v;
    else if (c < L)  // one K range: the block's sums are final
      on[r * L + c] = __float2bfloat16_rn(v * sc);
  }
  if (cs == 1) return;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's sums are written
  for (int e = s * DR_THREADS + tid; e < M * BL; e += cs * DR_THREADS) {
    if (e % BL >= L) continue;
    float v[DR_MAX_SPLITS];  // every block's sum in flight at once, then added in rank order
#pragma unroll
    for (int j = 0; j < DR_MAX_SPLITS; ++j)
      v[j] = j < cs ? cluster.map_shared_rank(part, j)[e] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < DR_MAX_SPLITS; ++j)
      if (j < cs) sum += v[j];
    on[(e / BL) * L + e % BL] = __float2bfloat16_rn(sum * sc);
  }
  cluster.sync();  // no block leaves while another still reads its sums
}

// --- short-K class -------------------------------------------------------------

// Grid (strips, N). Block (j, n) computes out[n][m][8 v .. 8 v + 8) for every
// row m < M and vector v in [j * vb, min(L / 8, (j + 1) * vb)).
__global__ void __launch_bounds__(DR_THREADS)
decode_short_k_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const float* __restrict__ scale, bf16* __restrict__ out, int M, int K, int L,
                      int vb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* ws = reinterpret_cast<uint4*>(smem_raw);      // [K][vb]
  float* xs = reinterpret_cast<float*>(ws + K * vb);  // [M][K]
  const int n = blockIdx.y, v0 = blockIdx.x * vb, nv = L / 8;
  const int tid = threadIdx.x;
  const bf16* wn = w + (size_t)n * K * L;
  for (int e = tid; e < K * vb; e += DR_THREADS) {
    const int q = e / vb, v = v0 + e % vb;
    const bool ok = v < nv;
    cp_async16(ws + e, ok ? wn + (size_t)q * L + 8 * v : wn, ok);
  }
  cp_async_commit();
  dr_wait_prerequisites();  // x may be the paired xA pass's output
  const float sc = scale ? scale[n] : 1.f;
  const uint4* xn = reinterpret_cast<const uint4*>(x + (size_t)n * M * K);
  for (int e = tid; e < M * K / 8; e += DR_THREADS) {
    const uint4 u = xn[e];
    const uint32_t p[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xs[8 * e + 2 * i] = __uint_as_float(p[i] << 16);
      xs[8 * e + 2 * i + 1] = __uint_as_float(p[i] & 0xffff0000u);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  bf16* on = out + (size_t)n * M * L;
  for (int u = tid; u < M * vb; u += DR_THREADS) {
    const int m = u / vb, v = v0 + u % vb;
    if (v >= nv) continue;
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    const float* xr = xs + m * K;
    const uint4* wc = ws + u % vb;
#pragma unroll 4
    for (int qq = 0; qq < K; ++qq) {
      const uint4 b = wc[qq * vb];
      const uint32_t p[4] = {b.x, b.y, b.z, b.w};
      const float xv = xr[qq];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[2 * i] = fmaf(xv, __uint_as_float(p[i] << 16), acc[2 * i]);
        acc[2 * i + 1] = fmaf(xv, __uint_as_float(p[i] & 0xffff0000u), acc[2 * i + 1]);
      }
    }
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(acc[2 * i] * sc, acc[2 * i + 1] * sc);
      o[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(on + (size_t)m * L + 8 * v) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// --- launch --------------------------------------------------------------------

template <int BL, int RM>
inline cudaError_t launch_decode_narrow(const bf16* x, const bf16* w, const float* scale,
                                        bf16* out, int n, int m, int k, int l,
                                        const SkinnyPlan& p, cudaStream_t stream) {
  using C = DecNarrow<BL, RM>;
  static PerDevice once;
  const cudaError_t attr = (cudaError_t)once.get([] {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_narrow_kernel<BL, RM>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess || DR_MAX_SPLITS <= 8) return (int)e;
    return (int)cudaFuncSetAttribute(decode_narrow_kernel<BL, RM>,
                                     cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  });
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = p.splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, n, p.splits);
  cfg.blockDim = dim3(DR_THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_narrow_kernel<BL, RM>, x, w, scale, out, m, k, l,
                            p.steps);
}

template <int RM>
inline cudaError_t launch_decode_narrow_bl(const bf16* x, const bf16* w, const float* scale,
                                           bf16* out, int n, int m, int k, int l,
                                           const SkinnyPlan& p, cudaStream_t st) {
  switch (p.width) {
    case 16: return launch_decode_narrow<16, RM>(x, w, scale, out, n, m, k, l, p, st);
    case 32: return launch_decode_narrow<32, RM>(x, w, scale, out, n, m, k, l, p, st);
    case 64: return launch_decode_narrow<64, RM>(x, w, scale, out, n, m, k, l, p, st);
    default: return launch_decode_narrow<128, RM>(x, w, scale, out, n, m, k, l, p, st);
  }
}

// `dependent`: a programmatic dependent launch of the kernel before it on
// `stream` (the pair's xA pass)
inline cudaError_t launch_decode_short_k(const bf16* x, const bf16* w, const float* scale,
                                         bf16* out, int n, int m, int k, int l,
                                         const SkinnyPlan& p, bool dependent,
                                         cudaStream_t stream) {
  static PerDevice once;
  const cudaError_t attr = (cudaError_t)once.get([] {
    return (int)cudaFuncSetAttribute(decode_short_k_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     DR_MAX_STRIP + (MMA_MIN_ROWS - 1) * MMA_MAX_RANK * 4);
  });
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, n, 1);
  cfg.blockDim = dim3(DR_THREADS);
  cfg.dynamicSmemBytes = k * p.steps * 16 + m * k * 4;
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = dependent ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, decode_short_k_kernel, x, w, scale, out, m, k, l, p.steps);
}

// One call on the decode path (not a dependent launch).
inline cudaError_t launch_decode_rows(const bf16* x, const bf16* w, const float* scale, bf16* out,
                                      int n, int m, int k, int l, const SkinnyPlan& p,
                                      cudaStream_t st) {
  if (n > 65535) return cudaErrorInvalidValue;
  if (p.cls == CLASS_SHORT_K)
    return launch_decode_short_k(x, w, scale, out, n, m, k, l, p, false, st);
  return m <= 8 ? launch_decode_narrow_bl<8>(x, w, scale, out, n, m, k, l, p, st)
                : launch_decode_narrow_bl<16>(x, w, scale, out, n, m, k, l, p, st);
}

}  // namespace plora
