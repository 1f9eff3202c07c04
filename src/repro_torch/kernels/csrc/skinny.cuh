// Tensor-core kernels of packed_matmul.cu for bf16 calls with more than 16
// rows per adapter (training and prefill): out[n] = scale[n] * (x[n] @ w[n]),
// where one of the product's two outer sizes is a LoRA rank; and the plan of
// every packed_matmul call (skinny_plan), which sends bf16 calls of at most
// 16 rows per adapter to decode_rows.cuh and f32 calls of more than 16 to
// fskinny.cuh. Two shape classes of one design:
//
//   narrow  -- L <= 128, K long: xA (x @ A), case 2 (g_s @ B^T, B^T read in
//              place) and case 3 (x^T @ d(xA), x^T read in place). A block
//              owns BM = 64 rows by the whole width L (rounded up to a power
//              of two >= 16), and K is split across the blocks of one
//              thread-block cluster (up to 8); the cluster adds its blocks'
//              f32 partial sums through
//              distributed shared memory in a fixed order, then scales and
//              casts once -- one launch, no workspace.
//   short K -- K = r <= 128, L > 128: (xA) @ B and case 4 (d(xA) @ A^T, A^T
//              read in place). A block owns BM = 128 rows of one adapter and
//              a run of 128-column tiles: the (128 x r) x tile is loaded
//              once, the (r x 128) w tiles stream through a ring; each tile
//              is one product, scaled in f32, cast once and stored through a
//              per-warp staging buffer as 16-byte vectors. No split.
//
// What bounds both on an H100: bytes. xA and case 2 read a (tokens x d)
// operand once at ~r FLOP per element (16 FLOP/byte at r = 16, against the
// ~295 FLOP/byte ridge); (xA)B and case 4 write a (tokens x d) output from
// a K = r contraction. So the design is about bytes in flight and blocks
// on every SM, not tensor-core rate: operands come in by 16-byte cp.async
// (zero-filled past every ragged edge) into a ring of STAGES shared-memory
// stages, the next stages' loads in flight while the current one is
// multiplied; mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix
// (.trans for an operand stored the other way) does the arithmetic.
// Shared-memory rows are padded to an odd number of 16-byte units, so the
// eight rows one ldmatrix reads fall in eight different bank groups.
//
// Rounding: f32 sums, then the f32 scale, then one round-to-nearest-even
// cast to bf16 -- the TPU kernel's. Split K stays deterministic.
#pragma once

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "tile.cuh"

namespace plora {

using bf16 = __nv_bfloat16;

// --- PTX: asynchronous copies, ldmatrix, mma.sync ---------------------------

// 16 bytes global -> shared, bypassing L1; zero-filled (nothing read) when
// !pred, so a ragged edge needs no separate clearing pass.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane i gives the address of row (i % 8) of matrix
// i / 8. TRANS: each matrix transposed on the way into registers.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --- shared-memory operand tiles ---------------------------------------------

// Row pitch (elements) of a shared tile whose rows hold R bf16: an odd
// number of 16-byte units, so ldmatrix's eight row reads hit eight
// different groups of banks.
__host__ __device__ constexpr int pitch(int r) { return ((r / 8) | 1) * 8; }

// The x operand's tile: rows [m0, m0 + BM) x k in [k0, k0 + BK).
//   !TX: x stored (M, K), tile [BM][pitch(BK)];  TX: x stored (K, M) (the
//   transposed view x^T of case 3), tile [BK][pitch(BM)].
template <int BM, int BK, bool TX>
struct XTile {
  static constexpr int ELEMS = TX ? BK * pitch(BM) : BM * pitch(BK);
  static constexpr int CHUNKS = BM * BK / 8;  // 16-byte copies per tile

  // copies c = tid, tid + threads, ...; rows >= M and k >= kend read as 0
  template <int THREADS>
  static __device__ __forceinline__ void load(bf16* s, const bf16* x, int M, int K, int m0, int k0,
                                              int kend) {
#pragma unroll
    for (int u = 0; u < (CHUNKS + THREADS - 1) / THREADS; ++u) {
      const int c = threadIdx.x + u * THREADS;
      if (CHUNKS % THREADS != 0 && c >= CHUNKS) break;
      int r, kk;  // tile row (m) and column (k) of the chunk's first element
      if (TX) { kk = c / (BM / 8); r = (c % (BM / 8)) * 8; } else { r = c / (BK / 8); kk = (c % (BK / 8)) * 8; }
      const int gm = m0 + r, gk = k0 + kk;
      const bool ok = gm < M && gk < kend;
      const bf16* src = ok ? (TX ? x + (size_t)gk * M + gm : x + (size_t)gm * K + gk) : x;
      cp_async16(TX ? s + kk * pitch(BM) + r : s + r * pitch(BK) + kk, src, ok);
    }
  }

  // the A fragment of m16n8k16 for tile rows [mr, mr + 16) x k [kk, kk + 16)
  static __device__ __forceinline__ void frag(uint32_t (&a)[4], const bf16* s, int mr, int kk) {
    const int lane = threadIdx.x & 31;
    if (TX) {  // stored [k][m]: matrices (k, m) (k, m+8) (k+8, m) (k+8, m+8), transposed
      const int i = lane & 7, j = lane >> 3;
      ldsm_x4<true>(a, s + (kk + i + (j >> 1) * 8) * pitch(BM) + mr + (j & 1) * 8);
    } else {  // stored [m][k]: matrices (m, k) (m+8, k) (m, k+8) (m+8, k+8)
      ldsm_x4<false>(a, s + (mr + (lane & 15)) * pitch(BK) + kk + (lane >> 4) * 8);
    }
  }
};

// The w operand's tile: k in [k0, k0 + BK) x columns [l0, l0 + BN).
//   !TW: w stored (K, L), tile [BK][pitch(BN)];  TW: w stored (L, K) (the
//   transposed views B^T, A^T of cases 2 and 4), tile [BN][pitch(BK)].
template <int BK, int BN, bool TW>
struct WTile {
  static constexpr int ELEMS = TW ? BN * pitch(BK) : BK * pitch(BN);
  static constexpr int CHUNKS = BK * BN / 8;

  template <int THREADS>
  static __device__ __forceinline__ void load(bf16* s, const bf16* w, int K, int L, int k0, int l0,
                                              int kend) {
#pragma unroll
    for (int u = 0; u < (CHUNKS + THREADS - 1) / THREADS; ++u) {
      const int c = threadIdx.x + u * THREADS;
      if (CHUNKS % THREADS != 0 && c >= CHUNKS) break;
      int kk, cl;
      if (TW) { cl = c / (BK / 8); kk = (c % (BK / 8)) * 8; } else { kk = c / (BN / 8); cl = (c % (BN / 8)) * 8; }
      const int gk = k0 + kk, gl = l0 + cl;
      const bool ok = gk < kend && gl < L;
      const bf16* src = ok ? (TW ? w + (size_t)gl * K + gk : w + (size_t)gk * L + gl) : w;
      cp_async16(TW ? s + cl * pitch(BK) + kk : s + kk * pitch(BN) + cl, src, ok);
    }
  }

  // B fragments of two m16n8k16 products: columns [nc, nc + 8) into b[0],
  // b[1] and [nc + 8, nc + 16) into b[2], b[3], k in [kk, kk + 16)
  static __device__ __forceinline__ void frag(uint32_t (&b)[4], const bf16* s, int nc, int kk) {
    const int lane = threadIdx.x & 31, i = lane & 7, j = lane >> 3;
    if (TW)  // stored [n][k]: matrices (n, k) (n, k+8) (n+8, k) (n+8, k+8)
      ldsm_x4<false>(b, s + (nc + i + (j >> 1) * 8) * pitch(BK) + kk + (j & 1) * 8);
    else  // stored [k][n]: matrices (k, n) (k+8, n) (k, n+8) (k+8, n+8), transposed
      ldsm_x4<true>(b, s + (kk + i + (j & 1) * 8) * pitch(BN) + nc + (j >> 1) * 8);
  }
};

// --- the plan ------------------------------------------------------------------

enum { PATH_FMA = 0, PATH_MMA = 1, PATH_DECODE = 2, PATH_F32SKINNY = 3 };
enum { CLASS_NARROW = 0, CLASS_SHORT_K = 1 };

constexpr int SMS = 132;  // an H100 SXM's SMs
constexpr int MMA_MIN_ROWS = 17;  // decode's <= 16 rows take decode_rows.cuh's kernels
constexpr int MMA_MAX_RANK = 128;
// the decode path (decode_rows.cuh): K ranges of the narrow class's cluster,
// at most; A bytes per range, at least; short-K blocks in one wave (one per
// SM); bytes of a short-K block's strip of B, at most; its 16-byte copies,
// at least (chosen by measurement at qwen25-7b's decode shapes, PERF.md)
constexpr int DR_MAX_SPLITS = 8;  // the portable cluster size
constexpr int DR_MIN_RANGE_BYTES = 8192;
constexpr int DR_SLOTS = SMS;
constexpr int DR_MAX_STRIP = 65536;
constexpr int DR_MIN_COPIES = 128;

// narrow class: 64 rows x the width, 64 deep per stage, 4 warps
constexpr int NW_BM = 64, NW_BK = 64, NW_THREADS = 128, NW_STAGES = 4;
constexpr int NW_TARGET_BLOCKS = 4 * SMS;
constexpr int NW_MIN_STEPS = 4;      // K steps per range, at least
constexpr int NW_MAX_SPLITS = 8;     // a cluster's blocks: the portable cluster size
// short-K class: 128 x 128 tiles, 8 warps as 4 (rows) x 2 (columns)
constexpr int SK_BM = 128, SK_BN = 128, SK_THREADS = 256, SK_STAGES = 3;
// the f32skinny path's narrow class (fskinny.cuh): 16 rows x the width, 64
// deep per stage (16 rows a block ran a layer's launcher calls 4 % faster
// than 32, PERF.md); K split over a cluster of up to 8 blocks, at least
// FN_MIN_STEPS stages each, until about two blocks an SM
constexpr int FN_BM = 16, FN_BK = 64;
constexpr int FN_TARGET_BLOCKS = 2 * SMS;
constexpr int FN_MIN_STEPS = 4;
constexpr int FN_MAX_SPLITS = 8;  // the portable cluster size

struct SkinnyPlan {
  int path, cls, width;  // width: L (narrow) or K (short K) rounded up to 16, 32, 64 or 128
  // "mma", narrow: K ranges (the cluster's blocks) and NW_BK steps per range;
  // "decode": see decode_rows_plan
  int splits, steps;
};

__host__ __device__ inline int width_class(int v) {
  return v <= 16 ? 16 : v <= 32 ? 32 : v <= 64 ? 64 : 128;
}

// The decode path's geometry, in skinny_plan's SkinnyPlan: narrow -- splits
// K ranges (the cluster) of `steps` rows each (a multiple of 16), enough
// blocks for the card; short K -- `splits` strips per adapter of `steps`
// 8-column vectors each, one wave of DR_SLOTS blocks.
__host__ __device__ inline SkinnyPlan decode_rows_plan(int n, int k, int l, bool narrow) {
  if (narrow) {
    const int bl = width_class(l);
    const int min_rows = DR_MIN_RANGE_BYTES / (2 * bl);
    int s = (SMS + n - 1) / n;
    s = s < k / min_rows ? s : k / min_rows;
    s = s < DR_MAX_SPLITS ? s : DR_MAX_SPLITS;
    s = s > 1 ? s : 1;
    const int rows = ((k + s - 1) / s + 15) / 16 * 16;
    return {PATH_DECODE, CLASS_NARROW, bl, (k + rows - 1) / rows, rows};
  }
  const int nv = l / 8;
  const int per = DR_SLOTS / n > 1 ? DR_SLOTS / n : 1;  // blocks per adapter
  const int cap = DR_MAX_STRIP / (16 * k);
  int vb = (nv + per - 1) / per;
  vb = vb > (DR_MIN_COPIES + k - 1) / k ? vb : (DR_MIN_COPIES + k - 1) / k;
  vb = vb < cap ? vb : cap;
  vb = vb > 1 ? vb : 1;
  return {PATH_DECODE, CLASS_SHORT_K, width_class(k), (nv + vb - 1) / vb, vb};
}

// The narrow class's K ranges (the cluster's blocks) and steps of `bk` per
// range: ranges until `target` blocks, each at least `min_steps` steps long,
// at most `max_splits`.
__host__ __device__ inline SkinnyPlan narrow_plan(int path, int width, int tiles, int k, int bk,
                                                  int target, int min_steps, int max_splits) {
  const int ksteps = (k + bk - 1) / bk;
  int s = (target + tiles - 1) / tiles;
  s = s < ksteps / min_steps ? s : ksteps / min_steps;
  s = s < max_splits ? s : max_splits;
  s = s > 1 ? s : 1;
  const int steps = (ksteps + s - 1) / s;
  return {path, CLASS_NARROW, width, (ksteps + steps - 1) / steps, steps};
}

// The plan of one call: reads only shapes, dtype, the two layouts and
// whether x, w and out are 16-byte aligned. dtype: 0 f32, 1 bf16. bf16 with
// both operands row-major, every size a multiple of 8 and L or K a rank:
// at most 16 rows per adapter "decode" (decode_rows.cuh), more "mma" (the
// kernels below, which also read transposed operands). f32 with more than
// 16 rows per adapter, x row-major, K and L multiples of 4 and L or K a
// rank: "f32skinny" (fskinny.cuh; w row-major or transposed). Else "fma".
__host__ __device__ inline SkinnyPlan skinny_plan(int n, int m, int k, int l, int dtype, bool tx,
                                                  bool tw, bool aligned) {
  SkinnyPlan p{PATH_FMA, 0, 0, 1, 0};
  if (dtype == 0) {
    if (m < MMA_MIN_ROWS || tx || !aligned || k % 4 != 0 || l % 4 != 0) return p;
    if (l <= MMA_MAX_RANK)
      return narrow_plan(PATH_F32SKINNY, l <= 8 ? 8 : width_class(l),
                         n * ((m + FN_BM - 1) / FN_BM), k, FN_BK, FN_TARGET_BLOCKS, FN_MIN_STEPS,
                         FN_MAX_SPLITS);
    if (k <= MMA_MAX_RANK)
      return {PATH_F32SKINNY, CLASS_SHORT_K, k <= 8 ? 8 : width_class(k), 1, 0};
    return p;
  }
  // every leading dimension and adapter stride a multiple of 8 elements
  const bool lds = k % 8 == 0 && l % 8 == 0 && (!tx || m % 8 == 0);
  if (dtype != 1 || !aligned || !lds) return p;
  if (m < MMA_MIN_ROWS) {
    if (tx || tw || (l > MMA_MAX_RANK && k > MMA_MAX_RANK)) return p;
    return decode_rows_plan(n, k, l, l <= MMA_MAX_RANK);
  }
  if (l <= MMA_MAX_RANK)
    return narrow_plan(PATH_MMA, width_class(l), n * ((m + NW_BM - 1) / NW_BM), k, NW_BK,
                       NW_TARGET_BLOCKS, NW_MIN_STEPS, NW_MAX_SPLITS);
  if (k <= MMA_MAX_RANK) return {PATH_MMA, CLASS_SHORT_K, width_class(k), 1, 0};
  return p;  // both outer sizes and K large (case 1 at a long rank): FMA
}

// --- narrow class ------------------------------------------------------------

template <int BL, bool TX, bool TW>
struct Narrow {
  using XT = XTile<NW_BM, NW_BK, TX>;
  using WT = WTile<NW_BK, BL, TW>;
  static constexpr int STAGE = XT::ELEMS + WT::ELEMS;
  static constexpr int SMEM = NW_STAGES * STAGE * (int)sizeof(bf16);
  static constexpr int RP = BL + 4;  // row pitch (f32) of the partial sums
  static_assert(NW_BM * RP * 4 <= SMEM, "the partial sums reuse the ring");
};

// Grid (row tiles, N, splits), clusters of (1, 1, splits). Block (t, n, s)
// computes rows [64 t, 64 t + 64) of adapter n over K steps [s * steps,
// (s + 1) * steps); warp w owns 16 of the rows and all BL columns. One
// range (splits == 1) writes cast(acc * scale[n]) to out itself; otherwise
// every block leaves its f32 partial sums in its shared memory, and block
// s then adds, for its share of the tile's elements, the partials of
// blocks 0, 1, ..., splits - 1 in that order, scales and casts.
template <int BL, bool TX, bool TW>
__global__ void __launch_bounds__(NW_THREADS, 4)
narrow_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
              const float* __restrict__ scale, bf16* __restrict__ out, int M, int K, int L,
              int steps) {
  using C = Narrow<BL, TX, TW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int n = blockIdx.y, s = blockIdx.z, m0 = blockIdx.x * NW_BM;
  const int kb = s * steps * NW_BK, ke = min(K, kb + steps * NW_BK);
  const int nsteps = (ke - kb + NW_BK - 1) / NW_BK;
  const bf16* xn = x + (size_t)n * M * K;
  const bf16* wn = w + (size_t)n * K * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  auto load = [&](int stage, int k0) {
    bf16* st = smem + stage * C::STAGE;
    C::XT::template load<NW_THREADS>(st, xn, M, K, m0, k0, ke);
    C::WT::template load<NW_THREADS>(st + C::XT::ELEMS, wn, K, L, k0, 0, ke);
  };

  float acc[BL / 8][4];
#pragma unroll
  for (int j = 0; j < BL / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < NW_STAGES - 1; ++st) {
    if (st < nsteps) load(st, kb + st * NW_BK);
    cp_async_commit();
  }
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<NW_STAGES - 2>();  // step t's copies have landed (this thread's) ...
    __syncthreads();                 // ... and everyone's; step t-1's stage is free
    const int nt = t + NW_STAGES - 1;
    if (nt < nsteps) load(nt % NW_STAGES, kb + nt * NW_BK);
    cp_async_commit();
    const bf16* xs = smem + (t % NW_STAGES) * C::STAGE;
    const bf16* ws = xs + C::XT::ELEMS;
#pragma unroll
    for (int kk = 0; kk < NW_BK; kk += 16) {
      uint32_t a[4];
      C::XT::frag(a, xs, warp * 16, kk);
#pragma unroll
      for (int nc = 0; nc < BL; nc += 16) {
        uint32_t b[4];
        C::WT::frag(b, ws, nc, kk);
        mma_bf16(acc[nc / 8], a, b[0], b[1]);
        mma_bf16(acc[nc / 8 + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  const float sc = scale ? scale[n] : 1.f;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  bf16* on = out + (size_t)n * M * L;
  if (gridDim.z == 1) {  // one K range: the sums are final
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + warp * 16 + g + h * 8;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < BL / 8; ++j) {
        const int gl = j * 8 + c2;
        if (gl < L)
          *reinterpret_cast<__nv_bfloat162*>(on + (size_t)gm * L + gl) =
              __floats2bfloat162_rn(acc[j][2 * h] * sc, acc[j][2 * h + 1] * sc);
      }
    }
    return;
  }
  __syncthreads();  // every warp is done with the ring: the partials take its place
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < BL / 8; ++j)
      *reinterpret_cast<float2*>(red + (warp * 16 + g + h * 8) * C::RP + j * 8 + c2) =
          make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partials are written (and every block has started)
  const int cs = (int)gridDim.z;
  for (int e = s * NW_THREADS + threadIdx.x; e < NW_BM * BL; e += cs * NW_THREADS) {
    const int r = e / BL, c = e % BL;
    float v[NW_MAX_SPLITS];  // every block's partial in flight at once, then added in order
#pragma unroll
    for (int q = 0; q < NW_MAX_SPLITS; ++q)
      v[q] = q < cs ? cluster.map_shared_rank(red, q)[r * C::RP + c] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < NW_MAX_SPLITS; ++q)
      if (q < cs) sum += v[q];
    if (m0 + r < M && c < L) on[(size_t)(m0 + r) * L + c] = __float2bfloat16_rn(sum * sc);
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

// --- short-K class -------------------------------------------------------------

template <int RK, bool TX, bool TW>
struct ShortK {
  using XT = XTile<SK_BM, RK, TX>;
  using WT = WTile<RK, SK_BN, TW>;
  static constexpr int WARP_ROWS = SK_BM / 4, WARP_COLS = SK_BN / 2;  // 32 x 64 per warp
  static constexpr int STG = WARP_ROWS * pitch(WARP_COLS);  // a warp's output staging
  static constexpr int SMEM =
      (XT::ELEMS + SK_STAGES * WT::ELEMS + (SK_THREADS / 32) * STG) * (int)sizeof(bf16);
};

// Grid (column groups, row tiles, N). Block (g, t, n) computes rows
// [128 t, 128 t + 128) of adapter n for the 128-column tiles [g * tpb,
// min((g + 1) * tpb, tiles)): its x tile is loaded once, the w tiles come
// through a ring of SK_STAGES stages, and each output tile is written
// through the warps' staging buffers as 16-byte stores.
template <int RK, bool TX, bool TW>
__global__ void __launch_bounds__(SK_THREADS, 2)
short_k_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const float* __restrict__ scale, bf16* __restrict__ out, int M, int K, int L,
               int tpb) {
  using C = ShortK<RK, TX, TW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = xs + C::XT::ELEMS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* stg = ring + SK_STAGES * C::WT::ELEMS + warp * C::STG;
  const int n = blockIdx.z, m0 = blockIdx.y * SK_BM;
  const int tiles = (L + SK_BN - 1) / SK_BN;
  const int j0 = blockIdx.x * tpb, nj = min(tiles, j0 + tpb) - j0;
  const bf16* xn = x + (size_t)n * M * K;
  const bf16* wn = w + (size_t)n * K * L;
  bf16* on = out + (size_t)n * M * L;
  const float sc = scale ? scale[n] : 1.f;
  const int wr = (warp % 4) * C::WARP_ROWS, wc = (warp / 4) * C::WARP_COLS;

  C::XT::template load<SK_THREADS>(xs, xn, M, K, m0, 0, K);
#pragma unroll
  for (int st = 0; st < SK_STAGES - 1; ++st) {
    if (st < nj) C::WT::template load<SK_THREADS>(ring + st * C::WT::ELEMS, wn, K, L, 0, (j0 + st) * SK_BN, K);
    cp_async_commit();  // group 0 also carries the x tile
  }
  for (int t = 0; t < nj; ++t) {
    cp_async_wait<SK_STAGES - 2>();
    __syncthreads();
    const int nt = t + SK_STAGES - 1;
    if (nt < nj)
      C::WT::template load<SK_THREADS>(ring + (nt % SK_STAGES) * C::WT::ELEMS, wn, K, L, 0,
                                       (j0 + nt) * SK_BN, K);
    cp_async_commit();

    const bf16* ws = ring + (t % SK_STAGES) * C::WT::ELEMS;
    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < RK; kk += 16) {
      uint32_t a[2][4];
      C::XT::frag(a[0], xs, wr, kk);
      C::XT::frag(a[1], xs, wr + 16, kk);
#pragma unroll
      for (int nc = 0; nc < C::WARP_COLS; nc += 16) {
        uint32_t b[4];
        C::WT::frag(b, ws, wc + nc, kk);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][nc / 8], a[i], b[0], b[1]);
          mma_bf16(acc[i][nc / 8 + 1], a[i], b[2], b[3]);
        }
      }
    }

    // scale in f32, one cast, into the warp's staging rows ...
    const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(stg + (i * 16 + g + h * 8) * pitch(C::WARP_COLS) +
                                             j * 8 + c2) =
              __floats2bfloat162_rn(acc[i][j][2 * h] * sc, acc[i][j][2 * h + 1] * sc);
    __syncwarp();
    // ... then out as 16-byte stores: 8 lanes cover one 64-column row
    const int l0 = (j0 + t) * SK_BN + wc;
#pragma unroll
    for (int it = 0; it < C::WARP_ROWS / 4; ++it) {
      const int r = it * 4 + (lane >> 3), cc = (lane & 7) * 8;
      const int gm = m0 + wr + r, gl = l0 + cc;
      if (gm < M && gl < L)
        *reinterpret_cast<uint4*>(on + (size_t)gm * L + gl) =
            *reinterpret_cast<const uint4*>(stg + r * pitch(C::WARP_COLS) + cc);
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

}  // namespace plora
