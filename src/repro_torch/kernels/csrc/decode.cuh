// The fused base + LoRA delta at decode rows: fused.cuh's PATH_DECODE, a
// weight-streaming kernel for at most 16 rows in all (decode: 8 adapters
// x 1 token). y[g] = x[g] @ W + scale[n] * (x[g] @ A[n]) @ B[n], row g of
// adapter n = g / M.
//
// Replaces, at these rows, the Pallas TPU kernel src/repro/kernels/fused.py
// (fused_matmul -> _fused_kernel, and _fused_kernel_q for a quantized W).
// Included by fused.cuh after its dequantization helpers (deq_int8,
// deq_nf4, load_f8), which the quantized sources below use.
//
// What bounds it on an H100: bytes. Each row multiplies the whole of W, so
// a call does 2 * rows FLOP per weight element (8 FLOP per byte at 8 rows,
// against the ~295 of the bf16 ridge): its time is W read once from HBM
// (qwen25-7b's gate/up: 136 MB, 40 us at 3.35 TB/s). So the design reads
// every byte of W once, in 16-byte asynchronous copies, keeps as many bytes
// in flight as shared memory holds, and keeps the arithmetic and everything
// else off that stream:
//  * Launch 2, the main kernel. Block (strip, 0, s) owns 8 * CT output
//    columns (a strip) and the s-th of S ranges of K. Each step its 256
//    threads copy a tile of 2 * KT rows (KT = 256 / CT) of the strip, one row
//    pair of 8 columns (two 16-byte vectors) each, by cp.async into a ring of
//    DEC_STAGES shared-memory stages, DEC_STAGES - 1 steps ahead; a quantized
//    W's codes are dequantized in place when they land. The tile is 16
//    pieces of W^T of 16 columns x 16 rows; each warp loads two by
//    ldmatrix.trans and multiplies them with mma.sync m16n8k16 against x^T
//    (the 8 rows of x are mma's n = 8; 16 rows take two), f32 sums in
//    registers. With FMAs instead, 8 rows cost 64 instructions per 16 bytes
//    of W and the kernel was bound by issue, not bytes (int8, at half the
//    bytes, ran no faster than dense). x is staged in shared memory as bf16,
//    in chunks along K. Then the warps' sums are added in warp order, and the
//    S blocks of the thread-block cluster (S <= 8, the portable size) add
//    theirs in rank order through distributed shared memory. Each block of
//    the cluster then finishes a share of the strip's outputs:
//    y = cast(base + scale[n] * sum_q xA[g][q] * B[n][q][col]), f32 FMAs in
//    q order and one cast, the Pallas kernel's rounding points.
//  * Launch 1, the xA pass: xA[n] = x[n] @ A[n] for every adapter (block
//    (0, n, s)), f32 FMAs over per-thread rings of A, the sums never rounded,
//    into a buffer of rows x r f32 that launch 2 reads (the wrapper keeps it
//    behind y, in y's own allocation). Launch 2 is a programmatic dependent
//    launch: its blocks start streaming W while launch 1 runs and wait for
//    xA only where they read it. Computing xA in every strip's cluster
//    instead would re-read all of A once per strip: as many bytes as W
//    itself at q/o/down.
//  The strip width and the split fill the card in one wave (decode_geom):
//  qwen25-7b's gate/up 256 columns x 3 ranges (222 blocks), q/o and down 128
//  x 8 (224), k/v 32 x 7 (112). No workspace beyond xA, no atomics: every sum
//  is taken in a fixed order, so a call gives the same bits every time, and
//  a quantized call is bit-equal to the dense call on the dequantized W (the
//  plan reads only shapes; the pieces hold the same bf16 values).
#pragma once

#include <cooperative_groups.h>

namespace plora {

// Every launcher below caches its kernel's shared-memory attribute in a
// function-local static. fused.cu and fused_q.cu are built into libraries of
// their own that one process loads side by side, and the dynamic loader
// makes one copy of such a static (a template's, of vague linkage) serve
// both, so the second library's kernel would never get its attribute: the
// decode path has internal linkage in each library.
namespace {

constexpr int DEC_THREADS = 256, DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_MAX_ROWS = 16;
constexpr int DEC_MAX_SPLITS = 8;      // a cluster's blocks: the portable cluster size
constexpr int DEC_SLOTS = 2 * 132;     // resident main-kernel blocks: two per SM of an H100 SXM
constexpr int DEC_MIN_PAIRS = 4;       // row pairs per k thread, at least
constexpr int DEC_X_BYTES = 32768;     // one staged chunk of x
constexpr int DEC_STAGES = 8;          // the main kernel's ring: 7 stages in flight
constexpr int DEC_XA_STAGES = 4;       // the xA pass's: 3 in flight
// a ring stage: each thread's row pair, two 16-byte slots
constexpr int DEC_STAGE_BYTES = 2 * DEC_THREADS * 16;

// ---------------------------------------------------------------------------
// PTX: asynchronous copies, dependent launch, ldmatrix, mma.sync
// ---------------------------------------------------------------------------

// W is read once, by asynchronous copies into shared memory: 16 bytes
// through L2 only (.cg), or 8 bytes (.ca, the smallest vector of codes)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
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

// Programmatic dependent launch: the xA pass lets the main kernel start
// (its blocks stream W meanwhile), and the main kernel waits for the xA
// pass's writes only where it reads them
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// four 8 x 8 b16 matrices, transposed; lane l gives the address of row l % 8
// of matrix l / 8
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d (16 x 8, f32) += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bf16 (one 16-byte vector) widened to f32, exactly
__device__ __forceinline__ void widen8(uint4 v, float (&w)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(u[i] << 16);
    w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// acc[g][c] += x[g][k] * W[k][c] for the pair's rows k = 2p, then 2p + 1;
// xp: staged x at row 0, column 2p of the chunk (row pitch PITCH floats)
template <int RM, int PITCH>
__device__ __forceinline__ void fma_pair(float (&acc)[RM][8], const float* xp, uint4 lo,
                                         uint4 hi) {
  float wl[8], wh[8];
  widen8(lo, wl);
  widen8(hi, wh);
#pragma unroll
  for (int g = 0; g < RM; ++g) {
    const float2 xv = *reinterpret_cast<const float2*>(xp + g * PITCH);
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[g][c] = fmaf(xv.x, wl[c], acc[g][c]);
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[g][c] = fmaf(xv.y, wh[c], acc[g][c]);
  }
}

// 8 bf16 from p[0..8) where fewer than 8 columns remain (avail), zero past them
__device__ __forceinline__ uint4 gather8(const bf16* p, int avail) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = 2 * i < avail ? __bfloat16_as_ushort(p[2 * i]) : 0u;
    const uint32_t hi = 2 * i + 1 < avail ? __bfloat16_as_ushort(p[2 * i + 1]) : 0u;
    u[i] = lo | (hi << 16);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// ---------------------------------------------------------------------------
// W sources: a row pair (rows 2p, 2p + 1) of a thread's 8 columns, copied
// into the thread's two 16-byte slots of a ring stage (`issue`), and read
// back as two bf16 vectors (`expand`, which dequantizes codes: CODES).
// ---------------------------------------------------------------------------

// The dense row-major bf16 W of `ld` columns (a multiple of 8, 16-byte
// aligned rows)
struct DecDense {
  const bf16* p;
  int ld;
  static constexpr bool CODES = false;
  __device__ __forceinline__ void setup(int, bool, const float*) {}
  __device__ __forceinline__ void issue(int pr, int col, uint4* lo, uint4* hi) const {
    const bf16* r0 = p + (size_t)(2 * pr) * ld + col;
    cp_async16(lo, r0);
    cp_async16(hi, r0 + ld);
  }
  __device__ __forceinline__ void expand(const uint4* slo, const uint4* shi, int, int, uint4& lo,
                                         uint4& hi) const {
    lo = *slo;
    hi = *shi;
  }
};

// A (N, K, R) for the xA pass: group n reads adapter n's (K x R) matrix.
// vec: rows are 16-byte aligned (R a multiple of 8, an aligned base), else
// the 8 columns come one element at a time (a rank off a multiple of 8).
struct DecA {
  const bf16* p;
  int ld, vec;
  long long stride;
  __device__ __forceinline__ DecA at(int group) const {
    return {p + group * stride, ld, vec, stride};
  }
  __device__ __forceinline__ void issue(int pr, int col, uint4* lo, uint4* hi) const {
    const bf16* r0 = p + (size_t)(2 * pr) * ld + col;
    if (vec) {
      cp_async16(lo, r0);
      cp_async16(hi, r0 + ld);
    } else {  // the thread's own slots: its later read is ordered after these stores
      *lo = gather8(r0, ld - col);
      *hi = gather8(r0 + ld, ld - col);
    }
  }
};

// int8 codes (K, L) and one f32 scale per column: 8 bytes a row
struct DecInt8 {
  const int8_t* codes;
  const float* scales;
  int ld;
  float s8[8];
  static constexpr bool CODES = true;
  __device__ __forceinline__ void setup(int col, bool ok, const float*) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s8[j] = 0.f;
    if (ok) load_f8(scales + col, s8);
  }
  __device__ __forceinline__ void issue(int pr, int col, uint4* lo, uint4* hi) const {
    const int8_t* r0 = codes + (size_t)(2 * pr) * ld + col;
    cp_async8(lo, r0);
    cp_async8(hi, r0 + ld);
  }
  __device__ __forceinline__ void expand(const uint4* slo, const uint4* shi, int, int, uint4& lo,
                                         uint4& hi) const {
    lo = deq_int8(*reinterpret_cast<const uint2*>(slo), s8);
    hi = deq_int8(*reinterpret_cast<const uint2*>(shi), s8);
  }
};

// nf4 codes (K/2, L): one byte holds the pair's two rows (low nibble: the
// even row); f32 scales (K/blk, L); the codebook from shared memory
struct DecNf4 {
  const uint8_t* codes;
  const float* scales;
  int ld, blk;
  const float* cb;
  static constexpr bool CODES = true;
  __device__ __forceinline__ void setup(int, bool, const float* smem_cb) { cb = smem_cb; }
  __device__ __forceinline__ void issue(int pr, int col, uint4* lo, uint4*) const {
    cp_async8(lo, codes + (size_t)pr * ld + col);
  }
  __device__ __forceinline__ void expand(const uint4* slo, const uint4*, int pr, int col,
                                         uint4& lo, uint4& hi) const {
    const uint2 c = *reinterpret_cast<const uint2*>(slo);
    float s[8];
    const int b0 = (2 * pr) / blk, b1 = (2 * pr + 1) / blk;
    load_f8(scales + (size_t)b0 * ld + col, s);
    lo = deq_nf4(c, 0, cb, s);
    if (b1 != b0) load_f8(scales + (size_t)b1 * ld + col, s);
    hi = deq_nf4(c, 4, cb, s);
  }
};

// The decode source of each W source of tile.cuh (the transposed dense W of
// the backward's dx never takes the decode path)
template <class WS>
struct DecodeSource {
  static constexpr bool OK = false;
};
template <>
struct DecodeSource<Dense<bf16, false>> {
  static constexpr bool OK = true;
  using type = DecDense;
  static DecDense make(const Dense<bf16, false>& w) { return {w.p, w.ld}; }
};
template <>
struct DecodeSource<Int8W<bf16>> {
  static constexpr bool OK = true;
  using type = DecInt8;
  static DecInt8 make(const Int8W<bf16>& w) { return {w.codes, w.scales, w.ld, {}}; }
};
template <>
struct DecodeSource<Nf4W<bf16>> {
  static constexpr bool OK = true;
  using type = DecNf4;
  static DecNf4 make(const Nf4W<bf16>& w) { return {w.codes, w.scales, w.ld, w.blk, nullptr}; }
};

// ---------------------------------------------------------------------------
// The cluster's sums and the epilogue, shared by both kernels
// ---------------------------------------------------------------------------

// part: this block's sums [nrows][BN] (f32, shared memory) of the strip's
// columns from blockIdx.x * BN. The cluster's blocks (its K ranges, rank s
// = blockIdx.z) add them in rank order through distributed shared memory,
// each block finishing a share of the elements. XA: the f32 sums go to
// xa[(group * M + g) * R + col]; else y[g][col] = cast(base + scale[n] *
// sum_q xas[g][q] * B[n][q][col]), n = g / M, f32 FMAs in q order.
template <bool XA>
__device__ __forceinline__ void finish(const float* part, int BN, int nrows, int group, int M,
                                       int L, int R, const bf16* __restrict__ b,
                                       const float* __restrict__ scale, bf16* __restrict__ y,
                                       float* __restrict__ xa, const float* xas) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)gridDim.z, rank = (int)blockIdx.z;  // clusters of (1, 1, S)
  cluster.sync();  // every block's sums are in its shared memory
  for (int e = rank * DEC_THREADS + threadIdx.x; e < nrows * BN; e += cs * DEC_THREADS) {
    const int g = e / BN, gl = blockIdx.x * BN + e % BN;
    if (gl >= L) continue;
    float v[DEC_MAX_SPLITS];  // every block's sum in flight at once, then added in order
#pragma unroll
    for (int q = 0; q < DEC_MAX_SPLITS; ++q)
      v[q] = q < cs ? cluster.map_shared_rank(part, q)[e] : 0.f;
    float base = 0.f;
#pragma unroll
    for (int q = 0; q < DEC_MAX_SPLITS; ++q)
      if (q < cs) base += v[q];
    if constexpr (XA) {
      xa[((size_t)group * M + g) * R + gl] = base;
    } else {
      const int n = g / M;
      const bf16* bp = b + (size_t)n * R * L + gl;
      const float* xr = xas + g * R;
      float d = 0.f;
      for (int q = 0; q < R; ++q) d = fmaf(xr[q], to_f32(bp[(size_t)q * L]), d);
      y[(size_t)g * L + gl] = from_f32<bf16>(base + (scale ? scale[n] : 1.f) * d);
    }
  }
  cluster.sync();  // no block leaves while another still reads its sums
}

// ---------------------------------------------------------------------------
// The main kernel: W through a block-wide ring into mma.sync
// ---------------------------------------------------------------------------

// bytes of staged x: RM rows of one chunk (bf16), padded so that the 8 rows
// a fragment load reads fall in different banks
__host__ __device__ constexpr int dec_x_pitch(int rm) { return DEC_X_BYTES / 2 / rm + 8; }
__host__ __device__ constexpr int dec_main_smem(int rm, int r) {
  return rm * dec_x_pitch(rm) * 2 + DEC_STAGES * DEC_STAGE_BYTES + 64 + 4 * rm * r;
}

// Grid (strips, 1, S), clusters of (1, 1, S). Block s covers row pairs
// [s * pairs, (s + 1) * pairs) of K / 2 in steps of KT pairs. Step i's tile
// -- 2 KT rows of W (stage row 2 kt + h is row 2 (pb + i KT + kt) + h) by
// the strip's BN columns -- is copied by the block's threads, each its row
// pair of 8 columns, into ring stage i % DEC_STAGES, DEC_STAGES - 1 steps
// ahead; codes are dequantized in place once they land, rows past the range
// are zeroed, and one barrier a step publishes the tile. The tile is 16
// (16 x 16) pieces of W^T; each warp multiplies two of them into its f32
// sums (mma m16n8k16: 16 columns by the 8 rows of x, twice at 16 rows):
// CT = 32, two column tiles; CT <= 16, one column tile over two k chunks.
template <class S, int RM, int CT>
__global__ void __launch_bounds__(DEC_THREADS, 2)
decode_kernel(const bf16* __restrict__ x, const S src, const bf16* __restrict__ b,
              const float* __restrict__ scale, bf16* __restrict__ y, const float* __restrict__ xa,
              int M, int K, int L, int R, int nrows, int pairs) {
  static_assert(CT >= 4 && CT <= 32 && (RM == 8 || RM == 16), "decode geometry");
  constexpr int KT = DEC_THREADS / CT, BN = 8 * CT;
  constexpr int TK = 32 / CT;          // 16-row k chunks of a stage (KT = 8 TK)
  constexpr int NT = TK == 1 ? 2 : 1;  // a warp's column tiles
  constexpr int RN = RM / 8;           // blocks of 8 rows of x
  constexpr int XP = dec_x_pitch(RM);  // staged x row pitch (bf16)
  constexpr int PC = (XP - 8) / 2;     // row pairs of one x chunk
  static_assert(PC % KT == 0, "a step lies inside one x chunk");
  extern __shared__ float4 dec_smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(dec_smem_raw);
  bf16* xs = reinterpret_cast<bf16*>(sm);                      // [RM][XP]
  uint4* ring = reinterpret_cast<uint4*>(sm + RM * XP * 2);   // [stage][2][thread]
  float* cb = reinterpret_cast<float*>(sm + RM * XP * 2 + DEC_STAGES * DEC_STAGE_BYTES);
  float* xas = cb + 16;  // xA [nrows][R]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = tid % CT, kt = tid / CT;
  const int col = blockIdx.x * BN + 8 * ct;
  const bool col_ok = col < L;
  S w = src;
  w.setup(col, col_ok, cb);
  if (tid < 16) cb[tid] = NF4_CODEBOOK[tid];

  const int tn0 = 2 * warp / TK, tk0 = 2 * warp % TK;  // the warp's first piece
  const int g = lane >> 2, q = lane & 3;               // fragment coordinates
  const int lj = lane >> 3, lr = lane & 7;             // ldmatrix: matrix, row
  float d[NT][RN][4];
#pragma unroll
  for (int u = 0; u < NT; ++u)
#pragma unroll
    for (int rb = 0; rb < RN; ++rb)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[u][rb][e] = 0.f;

  const int pb = blockIdx.z * pairs, pe = min(K / 2, pb + pairs);
  const int nsteps = (pe - pb + KT - 1) / KT;
  // slot of stage row kr (= 2 kt + h), column group c: rows of CT slots, the
  // group index XOR-ed with the row's low bits so that the 8 rows one
  // ldmatrix reads (8 consecutive kr) fall in 8 different bank groups
  auto slot = [&](int i, int kr, int c) {
    const int sw = CT >= 8 ? (kr & 7) : ((kr >> 1) & (CT - 1));
    return ring + (i % DEC_STAGES) * 2 * DEC_THREADS + kr * CT + (c ^ sw);
  };
  auto issue = [&](int i) {  // step i's pair into its stage
    const int p = pb + i * KT + kt;
    if (i < nsteps && p < pe && col_ok) w.issue(p, col, slot(i, 2 * kt, ct), slot(i, 2 * kt + 1, ct));
    cp_async_commit();  // one group per step, empty or not: the waits count steps
  };
#pragma unroll
  for (int i = 0; i < DEC_STAGES - 1; ++i) issue(i);

  int pc = pb;  // the staged x chunk's first pair
  for (int i = 0; i < nsteps; ++i) {
    if ((i * KT) % PC == 0) {
      // a new chunk: x rows [0, RM) x pairs [pc, pc + PC) as bf16, zero past
      // pe and past nrows (the pieces read whole steps)
      pc = pb + i * KT;
      const int nv = (min(pe, pc + PC) - pc) / 4;  // 16-byte vectors of a row
      constexpr int NV = PC / 4, PER = RM * NV / DEC_THREADS;
      __syncthreads();  // the previous chunk is consumed (and the codebook written)
      uint4 xv[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int e = tid + j * DEC_THREADS, r = e / NV, v = e % NV;
        xv[j] = make_uint4(0, 0, 0, 0);
        if (r < nrows && v < nv)
          xv[j] = *reinterpret_cast<const uint4*>(x + (size_t)r * K + 2 * pc + 8 * v);
      }
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int e = tid + j * DEC_THREADS;
        *reinterpret_cast<uint4*>(xs + (e / NV) * XP + 8 * (e % NV)) = xv[j];
      }
    }
    cp_async_wait<DEC_STAGES - 2>();  // step i's copies (this thread's) have landed
    if (col_ok) {
      uint4* lo = slot(i, 2 * kt, ct);
      uint4* hi = slot(i, 2 * kt + 1, ct);
      if (pb + i * KT + kt >= pe) {  // past the range: zero rows for the pieces
        *lo = make_uint4(0, 0, 0, 0);
        *hi = make_uint4(0, 0, 0, 0);
      } else if constexpr (S::CODES) {
        uint4 vlo, vhi;
        w.expand(lo, hi, pb + i * KT + kt, col, vlo, vhi);
        *lo = vlo;
        *hi = vhi;
      }
    }
    __syncthreads();                  // step i's tile and x are in place; step i - 1 is read
    issue(i + DEC_STAGES - 1);        // into the stage step i - 1 used
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int tn = tn0 + (NT == 2 ? u : 0), tk = tk0 + (NT == 2 ? 0 : u);
      const int kr = tk * 16 + 8 * (lj >> 1) + lr;  // this lane's row of W^T's piece
      uint32_t a[4];
      ldsm_x4_trans(a, slot(i, kr, 2 * tn + (lj & 1)));
      // x^T: the piece's rows 2 q, 2 q + 1 are pair pb + i KT + 8 tk + q; + 8: pair + 4
      const int xo = 2 * (pb + i * KT + 8 * tk + q - pc);
#pragma unroll
      for (int rb = 0; rb < RN; ++rb) {
        const bf16* xr = xs + (rb * 8 + g) * XP + xo;
        mma16816(d[NT == 2 ? u : 0][rb], a, *reinterpret_cast<const uint32_t*>(xr),
                 *reinterpret_cast<const uint32_t*>(xr + 8));
      }
    }
  }
  cp_async_wait<0>();

  // d[u][rb]: element e of the fragment is column 16 tn + g + 8 (e / 2) of
  // the strip, row 8 rb + 2 q + e % 2 of x. The warps' sums, [warp][RM][32
  // columns], then the block's, [nrows][BN]: a column's warps in order.
  __syncthreads();  // x and the ring are consumed: the sums take their place
  float* wpart = reinterpret_cast<float*>(sm);
  float* part = wpart + DEC_WARPS * RM * 32;
#pragma unroll
  for (int u = 0; u < NT; ++u)
#pragma unroll
    for (int rb = 0; rb < RN; ++rb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wpart[(warp * RM + rb * 8 + 2 * q + (e & 1)) * 32 + 16 * u + g + 8 * (e >> 1)] =
            d[u][rb][e];
  wait_prerequisites();  // xA, from the xA pass
  for (int e = tid; e < nrows * R; e += DEC_THREADS) xas[e] = xa[e];
  __syncthreads();
  for (int e = tid; e < nrows * BN; e += DEC_THREADS) {
    const int r = e / BN, c = e % BN, tn = c / 16;
    float v;
    if constexpr (NT == 2) {
      v = wpart[((tn / 2) * RM + r) * 32 + 16 * (tn % 2) + c % 16];
    } else {
      v = 0.f;
#pragma unroll
      for (int j = 0; j < TK / 2; ++j) v += wpart[((tn * (TK / 2) + j) * RM + r) * 32 + c % 16];
    }
    part[e] = v;
  }
  finish<false>(part, BN, nrows, 0, M, L, R, b, scale, y, nullptr, xas);
}

// ---------------------------------------------------------------------------
// The xA pass: A through per-thread rings into f32 FMAs
// ---------------------------------------------------------------------------

constexpr int DEC_XA_FLOATS = DEC_X_BYTES / 4;  // one chunk of staged x, f32
__host__ __device__ constexpr int dec_xa_smem(int rm, int ct) {
  return DEC_X_BYTES + DEC_XA_STAGES * DEC_STAGE_BYTES > 4 * DEC_WARPS * rm * 8 * ct
             ? DEC_X_BYTES + DEC_XA_STAGES * DEC_STAGE_BYTES
             : 4 * DEC_WARPS * rm * 8 * ct;
}

// Grid (1, N, S), clusters of (1, 1, S): block (0, n, s) computes the sums of
// xa[n * M + g][col] = sum_k x[n * M + g][k] * A[n][k][col] (g < M, col < R)
// over the s-th K range. k thread kt multiplies pairs kt, kt + KT, ..., each
// copied into the thread's own ring of slots DEC_XA_STAGES - 1 pairs ahead
// (no barrier: a thread reads only what it copied), into RM x 8 f32 sums.
template <int RM, int CT>
__global__ void __launch_bounds__(DEC_THREADS)
decode_xa_kernel(const bf16* __restrict__ x, const DecA src, float* __restrict__ xa, int M,
                 int K, int R, int pairs) {
  constexpr int KT = DEC_THREADS / CT, BN = 8 * CT;
  constexpr int KCH = DEC_XA_FLOATS / RM;  // k columns of one staged x chunk
  constexpr int PC = KCH / 2;
  static_assert(PC % KT == 0, "a step lies inside one x chunk");
  extern __shared__ float4 dec_smem_raw[];
  float* xs = reinterpret_cast<float*>(dec_smem_raw);                  // [RM][KCH]
  uint4* ring = reinterpret_cast<uint4*>(xs + DEC_XA_FLOATS);         // [stage][2][thread]
  launch_dependents();  // the main kernel may start: it reads xa only after waiting

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = tid % CT, kt = tid / CT;
  const int group = blockIdx.y, col = 8 * ct;
  const bool col_ok = col < R;
  const bf16* xg = x + (size_t)group * M * K;
  const DecA w = src.at(group);

  float acc[RM][8];
#pragma unroll
  for (int g = 0; g < RM; ++g)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[g][c] = 0.f;

  const int pb = blockIdx.z * pairs, pe = min(K / 2, pb + pairs);
  const int nsteps = (pe - pb + KT - 1) / KT;
  auto slot = [&](int i) { return ring + (i % DEC_XA_STAGES) * 2 * DEC_THREADS + tid; };
  auto issue = [&](int i) {
    const int p = pb + i * KT + kt;
    if (i < nsteps && p < pe && col_ok) w.issue(p, col, slot(i), slot(i) + DEC_THREADS);
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < DEC_XA_STAGES - 1; ++i) issue(i);

  int pc = pb;
  for (int i = 0; i < nsteps; ++i) {
    if ((i * KT) % PC == 0) {
      // a new chunk: x rows [0, RM) x k in [2 pc, 2 pce) as f32, in 16-byte
      // vectors of 8 k (pc and pce are multiples of 4 pairs); rows past M are 0
      pc = pb + i * KT;
      const int nv = (min(pe, pc + PC) - pc) / 4;
      __syncthreads();  // the previous chunk is consumed
      constexpr int PER = DEC_XA_FLOATS / 8 / DEC_THREADS;
      uint4 xv[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int e = tid + j * DEC_THREADS, r = e / nv;
        xv[j] = make_uint4(0, 0, 0, 0);
        if (e < RM * nv && r < M)
          xv[j] = *reinterpret_cast<const uint4*>(xg + (size_t)r * K + 2 * pc + 8 * (e % nv));
      }
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int e = tid + j * DEC_THREADS;
        if (e < RM * nv) {
          float f[8];
          widen8(xv[j], f);
          float4* dst = reinterpret_cast<float4*>(xs + (e / nv) * KCH + 8 * (e % nv));
          dst[0] = make_float4(f[0], f[1], f[2], f[3]);
          dst[1] = make_float4(f[4], f[5], f[6], f[7]);
        }
      }
      __syncthreads();
    }
    cp_async_wait<DEC_XA_STAGES - 2>();  // step i's copies (this thread's) have landed
    issue(i + DEC_XA_STAGES - 1);         // into the slots step i - 1 read
    const int p = pb + i * KT + kt;
    if (p < pe && col_ok) fma_pair<RM, KCH>(acc, xs + 2 * (p - pc), *slot(i), *(slot(i) + DEC_THREADS));
  }
  cp_async_wait<0>();

  // the k threads' sums: the lanes of a warp that share columns, by a
  // butterfly, which leaves the same sum in each of them; then the warps
#pragma unroll
  for (int off = CT; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < RM; ++g)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[g][c] += __shfl_xor_sync(0xffffffffu, acc[g][c], off);
  __syncthreads();  // x and the rings are consumed: the warps' sums take their place
  float* part = xs;  // [DEC_WARPS][RM][BN]
  if (lane < CT) {   // the warp's first k thread of each column thread
#pragma unroll
    for (int g = 0; g < RM; ++g) {
      float4* dst = reinterpret_cast<float4*>(part + (warp * RM + g) * BN + 8 * ct);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  __syncthreads();
  for (int e = tid; e < M * BN; e += DEC_THREADS) {  // the warps, in order
    float v = part[e];
#pragma unroll
    for (int wi = 1; wi < DEC_WARPS; ++wi) v += part[wi * RM * BN + e];
    part[e] = v;
  }
  finish<true>(part, BN, M, group, M, R, R, nullptr, nullptr, nullptr, xa, nullptr);
}

// ---------------------------------------------------------------------------
// Plan and launch
// ---------------------------------------------------------------------------

__host__ __device__ inline int dec_rm(int rows) { return rows <= 8 ? 8 : 16; }

// column threads of the xA pass: 8 ranks each, a power of two
inline int dec_xa_ct(int r) {
  const int need = (r + 7) / 8;
  int ct = 1;
  while (ct < need) ct *= 2;
  return ct;
}

struct DecodeGeom {
  int ct, splits, pairs;  // column threads; K ranges; row pairs per range
  long long blocks;
};

// The strip width (ct from ct_hi down to ct_lo column threads) and the K
// split (at most DEC_MAX_SPLITS ranges of at least DEC_MIN_PAIRS pairs per
// k thread) whose blocks (strips x groups x ranges) fill `slots` in one
// wave: the most blocks up to `slots`, the widest strip of equals; the
// fewest when every choice has more. A second wave of a few blocks would
// stream alone, at the rate of its own copies in flight. A range is a whole
// number of 16-byte x vectors (4 pairs).
inline DecodeGeom decode_geom(int k, int l, int groups, int ct_lo, int ct_hi, long long slots) {
  const int P = k / 2;
  DecodeGeom best{ct_lo, 1, P, -1};
  for (int ct = ct_hi; ct >= ct_lo; ct /= 2) {
    const long long units = (long long)groups * ((l + 8 * ct - 1) / (8 * ct));
    const int cap = P / ((DEC_THREADS / ct) * DEC_MIN_PAIRS);
    long long s = units >= slots ? 1 : slots / units;
    s = s < cap ? s : cap;
    s = s < DEC_MAX_SPLITS ? s : DEC_MAX_SPLITS;
    s = s > 1 ? s : 1;
    const int pairs = ((P + (int)s - 1) / (int)s + 3) / 4 * 4;
    const int splits = (P + pairs - 1) / pairs;
    const long long blocks = units * splits;
    const bool better = best.blocks < 0 ||
                        (blocks <= slots ? best.blocks > slots || blocks > best.blocks
                                         : best.blocks > slots && blocks < best.blocks);
    if (better) best = {ct, splits, pairs, blocks};
  }
  return best;
}

// grid (strips, groups, S) in clusters of (1, 1, S); `dependent`: a
// programmatic dependent launch (it may start while the kernel before it runs)
template <class F, class... Args>
inline cudaError_t launch_cluster(F kernel, dim3 grid, int smem, bool dependent,
                                  cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = grid.z;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = dependent ? 2 : 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) cudaGetLastError();  // reported here, and cleared
  return e;
}

template <class S, int RM, int CT>
inline cudaError_t launch_main(dim3 grid, const bf16* x, const S& w, const void* b,
                               const float* scale, void* y, const float* xa, int M, int K, int L,
                               int R, int nrows, int pairs, cudaStream_t stream) {
  auto kernel = decode_kernel<S, RM, CT>;
  static PerDevice once;
  const cudaError_t attr = (cudaError_t)once.get([] {
    return (int)cudaFuncSetAttribute(decode_kernel<S, RM, CT>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     dec_main_smem(RM, 128));
  });
  if (attr != cudaSuccess) {
    cudaGetLastError();  // reported here: the next call's check must not see it again
    return attr;
  }
  return launch_cluster(kernel, grid, dec_main_smem(RM, R), true, stream, x, w,
                        static_cast<const bf16*>(b), scale, static_cast<bf16*>(y), xa, M, K, L,
                        R, nrows, pairs);
}

template <int RM, int CT>
inline cudaError_t launch_xa(dim3 grid, const bf16* x, const DecA& a, float* xa, int M, int K,
                             int R, int pairs, cudaStream_t stream) {
  auto kernel = decode_xa_kernel<RM, CT>;
  static PerDevice once;
  const cudaError_t attr = (cudaError_t)once.get([] {
    return (int)cudaFuncSetAttribute(decode_xa_kernel<RM, CT>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     dec_xa_smem(RM, CT));
  });
  if (attr != cudaSuccess) {
    cudaGetLastError();
    return attr;
  }
  return launch_cluster(kernel, grid, dec_xa_smem(RM, CT), false, stream, x, a, xa, M, K, R,
                        pairs);
}

// the instantiations: RM 8 or 16; the main kernel's strips of 32 to 256
// columns (CT 4-32), the xA pass's 8 to 128 ranks (CT 1-16)
template <class S, int RM>
inline cudaError_t launch_main_ct(int ct, dim3 grid, const bf16* x, const S& w, const void* b,
                                  const float* scale, void* y, const float* xa, int M, int K,
                                  int L, int R, int nrows, int pairs, cudaStream_t st) {
  switch (ct) {
    case 4: return launch_main<S, RM, 4>(grid, x, w, b, scale, y, xa, M, K, L, R, nrows, pairs, st);
    case 8: return launch_main<S, RM, 8>(grid, x, w, b, scale, y, xa, M, K, L, R, nrows, pairs, st);
    case 16: return launch_main<S, RM, 16>(grid, x, w, b, scale, y, xa, M, K, L, R, nrows, pairs, st);
    default: return launch_main<S, RM, 32>(grid, x, w, b, scale, y, xa, M, K, L, R, nrows, pairs, st);
  }
}

template <int RM>
inline cudaError_t launch_xa_ct(int ct, dim3 grid, const bf16* x, const DecA& a, float* xa,
                                int M, int K, int R, int pairs, cudaStream_t st) {
  switch (ct) {
    case 1: return launch_xa<RM, 1>(grid, x, a, xa, M, K, R, pairs, st);
    case 2: return launch_xa<RM, 2>(grid, x, a, xa, M, K, R, pairs, st);
    case 4: return launch_xa<RM, 4>(grid, x, a, xa, M, K, R, pairs, st);
    case 8: return launch_xa<RM, 8>(grid, x, a, xa, M, K, R, pairs, st);
    default: return launch_xa<RM, 16>(grid, x, a, xa, M, K, R, pairs, st);
  }
}

}  // namespace
}  // namespace plora
