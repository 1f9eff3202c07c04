// Grouped GEMM over packed LoRA adapters: out[n] = scale[n] * (x[n] @ w[n]).
// (scale may be null: no scaling, as the TPU kernel's scale of ones.)
//
// Replaces the Pallas TPU kernel src/repro/kernels/packed_matmul.py
// (packed_matmul -> _matmul_kernel) in all its uses: the forward delta's two
// grouped products and the four backward cases of kernels/ops.py's _bwd,
// which are the same primitive on transposed operands. f32 accumulation over
// K, then the f32 per-adapter scale, then one cast to the input type. x
// (N, M, K), w (N, K, L), scale (N,) f32, out (N, M, L); bf16 or f32. Each of
// x and w is either row-major or the transpose of a row-major array
// (trans_x: x is stored (N, K, M); trans_w: w is stored (N, L, K)), so the
// backward reads x^T, (xA)^T, A^T and B^T in place: no transposed copy.
//
// What bounds it on an H100. Serving: the rank r (8-128) is the small
// dimension; the two calls of a LoRA projection are (N, T, d_in) @
// (N, d_in, r) and (N, T, r) @ (N, r, d_out); at r = 16 both do about one
// FLOP per byte read, far below the ~295 FLOP/byte at which the tensor
// cores would become the limit, so the bound is bytes -- in practice the
// launch and the K loop's latency. Training (M = B*S = 1024 tokens per
// adapter): case 2 (g @ B^T) and case 3 (x^T @ dxA) read a (T x d) operand
// once and produce r columns (~2r/elt FLOP per byte: bytes-bound); cases 1
// and 3 contract over the T tokens.
//
// Four paths, chosen by one plan (skinny.cuh's skinny_plan) that reads only
// shapes, dtype, layouts and alignment:
//
// "decode" -- bf16 calls with at most 16 rows per adapter (serving's decode
// steps), x and w row-major, K and L multiples of 8, x, w and out 16-byte
// aligned, where L or K is at most 128: decode_rows.cuh's streaming kernels,
// one launch each. xA (L = r) streams A once, its long K split over a
// thread-block cluster whose blocks add their f32 sums in rank order; (xA)B
// (K = r) streams B once, in one wave of blocks over column strips.
// plora_packed_lora_delta below runs both passes of a delta in one call, the
// second as a programmatic dependent launch of the first.
//
// "mma" -- bf16 calls with more than 16 rows per adapter (training and
// prefill), every leading dimension a multiple of 8 elements and x, w, out
// 16-byte aligned, where L or K is at most 128 (a rank): the tensor-core
// kernels of skinny.cuh. Narrow output (xA, case 2, case 3: L = r) splits
// the long K across the blocks of a cluster, which add their f32 partial
// sums in a fixed order through distributed shared memory; short K (xA @
// B, case 4: K = r) writes wide tiles through 16-byte stores. Operands
// arrive by cp.async into a ring of shared-memory stages and are
// multiplied by mma.sync. One launch per call, no workspace.
//
// "f32skinny" -- f32 calls with more than 16 rows per adapter (training and
// prefill), x row-major, K and L multiples of 4 and x, w, out 16-byte
// aligned, where L or K is at most 128: fskinny.cuh's streaming FFMA
// kernels. Narrow output (xA, case 2) streams x through a cp.async ring,
// its K split across a cluster whose blocks add their f32 sums in rank
// order; short K ((xA)B, case 4) is one wave of blocks writing 16-byte
// stores. One launch per call, no workspace.
//
// "fma" -- everything else (f32 decode rows, ranks not a multiple of 8 in
// bf16, transposed operands at few rows, case 1 whose rows are the rank, x
// transposed in f32): the adapter is the grid's z axis and
// each block owns a BM x BN output tile of one adapter, looping over K
// inside the block (the TPU's sequential K grid axis becomes that loop).
// Tiles are staged through registers into shared memory as f32 (the next
// step's loads in flight while the current step is multiplied) and
// multiplied with plain FMA; a transposed operand is staged with its
// adjacent index across neighbouring threads, so its loads stay coalesced.
// No padding of K, L or the rank to 128 lanes: every edge is masked, so
// M = 1 (decode) is as right as a tile multiple. A call with a long K and
// few output tiles splits K across blocks (tile.cuh: SplitK): each range
// writes f32 partial sums, which reduce_kernel below adds in a fixed order.
//
// Either way the rounding stays the TPU kernel's (f32 sums, f32 scale, one
// cast) and the result is deterministic, bit for bit from call to call.
#include "decode_rows.cuh"
#include "fskinny.cuh"
#include "skinny.cuh"
#include "tile.cuh"

using namespace plora;

// out = cast(scale[n] * sum over the K ranges of the partial sums), the
// ranges added in order (scale may be null: 1).
template <typename T>
__global__ void reduce_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                              T* __restrict__ out, int N, int M, int L, int splits) {
  const size_t total = (size_t)N * M * L;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < splits; ++p) acc += part[p * total + e];
    out[e] = from_f32<T>(scale ? acc * scale[e / ((size_t)M * L)] : acc);
  }
}

// --- "fma": tile.cuh's FMA kernel --------------------------------------------

template <typename T, bool TX, bool TW>
static void launch_tr(const void* x, const void* w, const float* scale, void* out, float* part,
                      int n, int m, int k, int l, cudaStream_t stream) {
  const Dense<T, TX> xs{static_cast<const T*>(x), TX ? m : k};
  const Dense<T, TW> ws{static_cast<const T*>(w), TW ? k : l};
  launch_gemm<T>(xs, ws, scale, static_cast<T*>(out), part, n, m, k, l, stream);
}

template <typename T>
static int launch_fma(const void* x, const void* w, const float* scale, void* out, float* part,
                      int n, int m, int k, int l, bool trans_x, bool trans_w, cudaStream_t stream) {
  const SplitK sk = gemm_plan_for(n, m, k, l);
  if (sk.splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  if ((long long)n * sk.splits > 65535) return (int)cudaErrorInvalidValue;
  if ((m + ThinTile::BM - 1) / ThinTile::BM > 65535) return (int)cudaErrorInvalidValue;
  float* p = sk.splits > 1 ? part : nullptr;
  if (trans_x && trans_w)
    launch_tr<T, true, true>(x, w, scale, out, p, n, m, k, l, stream);
  else if (trans_x)
    launch_tr<T, true, false>(x, w, scale, out, p, n, m, k, l, stream);
  else if (trans_w)
    launch_tr<T, false, true>(x, w, scale, out, p, n, m, k, l, stream);
  else
    launch_tr<T, false, false>(x, w, scale, out, p, n, m, k, l, stream);
  if (sk.splits > 1) {
    const long long total = (long long)n * m * l;
    const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
    reduce_kernel<T><<<blocks, 256, 0, stream>>>(part, scale, static_cast<T*>(out), n, m, l,
                                                 sk.splits);
  }
  return (int)cudaGetLastError();
}

// --- "mma": skinny.cuh's tensor-core kernels ------------------------------------

template <int BL, bool TX, bool TW>
static cudaError_t launch_narrow(const bf16* x, const bf16* w, const float* scale, bf16* out,
                                 int n, int m, int k, int l, const SkinnyPlan& p,
                                 cudaStream_t stream) {
  using C = Narrow<BL, TX, TW>;
  static PerDevice attr;
  attr.get([] {
    return (int)cudaFuncSetAttribute(narrow_kernel<BL, TX, TW>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  });
  // the K ranges of one row tile form one cluster (1 x 1 x splits)
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = p.splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((m + NW_BM - 1) / NW_BM, n, p.splits);
  cfg.blockDim = dim3(NW_THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, narrow_kernel<BL, TX, TW>, x, w, scale, out, m, k, l, p.steps);
}

template <int RK, bool TX, bool TW>
static void launch_short_k(const bf16* x, const bf16* w, const float* scale, bf16* out, int n,
                           int m, int k, int l, cudaStream_t stream) {
  using C = ShortK<RK, TX, TW>;
  // resident blocks per SM at this kernel's registers and shared memory
  static PerDevice occupancy;
  const int per_sm = occupancy.get([] {
    cudaFuncSetAttribute(short_k_kernel<RK, TX, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         C::SMEM);
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, short_k_kernel<RK, TX, TW>, SK_THREADS,
                                                  C::SMEM);
    return b > 0 ? b : 1;
  });
  // one wave of resident blocks, each walking a run of column tiles
  const int rows = (m + SK_BM - 1) / SK_BM, tiles = (l + SK_BN - 1) / SK_BN;
  const long long target = (long long)SMS * per_sm;
  const long long total = (long long)n * rows * tiles;
  int tpb = (int)((total + target - 1) / target);
  tpb = tpb < tiles ? tpb : tiles;
  const dim3 grid((tiles + tpb - 1) / tpb, rows, n);
  short_k_kernel<RK, TX, TW><<<grid, SK_THREADS, C::SMEM, stream>>>(x, w, scale, out, m, k, l, tpb);
}

template <bool TX, bool TW>
static cudaError_t launch_mma_tr(const bf16* x, const bf16* w, const float* scale, bf16* out,
                                 int n, int m, int k, int l, const SkinnyPlan& p,
                                 cudaStream_t st) {
  if (p.cls == CLASS_NARROW) {
    switch (p.width) {
      case 16: return launch_narrow<16, TX, TW>(x, w, scale, out, n, m, k, l, p, st);
      case 32: return launch_narrow<32, TX, TW>(x, w, scale, out, n, m, k, l, p, st);
      case 64: return launch_narrow<64, TX, TW>(x, w, scale, out, n, m, k, l, p, st);
      default: return launch_narrow<128, TX, TW>(x, w, scale, out, n, m, k, l, p, st);
    }
  }
  switch (p.width) {
    case 16: launch_short_k<16, TX, TW>(x, w, scale, out, n, m, k, l, st); break;
    case 32: launch_short_k<32, TX, TW>(x, w, scale, out, n, m, k, l, st); break;
    case 64: launch_short_k<64, TX, TW>(x, w, scale, out, n, m, k, l, st); break;
    default: launch_short_k<128, TX, TW>(x, w, scale, out, n, m, k, l, st); break;
  }
  return cudaSuccess;
}

static int launch_mma(const void* x, const void* w, const float* scale, void* out, int n, int m,
                      int k, int l, bool tx, bool tw, const SkinnyPlan& p, cudaStream_t st) {
  const long long rows = p.cls == CLASS_NARROW ? n : (m + SK_BM - 1) / SK_BM;
  if (rows > 65535 || (p.cls != CLASS_NARROW && n > 65535)) return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  cudaError_t err;
  if (tx && tw)
    err = launch_mma_tr<true, true>(xb, wb, scale, ob, n, m, k, l, p, st);
  else if (tx)
    err = launch_mma_tr<true, false>(xb, wb, scale, ob, n, m, k, l, p, st);
  else if (tw)
    err = launch_mma_tr<false, true>(xb, wb, scale, ob, n, m, k, l, p, st);
  else
    err = launch_mma_tr<false, false>(xb, wb, scale, ob, n, m, k, l, p, st);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

static bool aligned16(const void* x, const void* w, const void* out) {
  return (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) & 15) == 0;
}

// --- C interface -------------------------------------------------------------
// dtype: 0 = float32, 1 = bfloat16; trans_x / trans_w: 1 when that operand is
// stored transposed (see the top of this file); aligned: 1 when x, w and
// out all start on 16 bytes (what the launch finds from its pointers).

// The path the plan gives a call: 0 "fma", 1 "mma", 2 "decode", 3 "f32skinny".
extern "C" int plora_packed_matmul_path(int n, int m, int k, int l, int dtype, int trans_x,
                                        int trans_w, int aligned) {
  return skinny_plan(n, m, k, l, dtype, trans_x != 0, trans_w != 0, aligned != 0).path;
}

// The f32 workspace (elements) a call needs: the partial sums of the FMA
// path's K ranges, or 0 (K not split, or the "mma", "decode" and "f32skinny"
// paths: their clusters add their partial sums in shared memory).
extern "C" long long plora_packed_matmul_workspace(int n, int m, int k, int l, int dtype,
                                                   int trans_x, int trans_w, int aligned) {
  const SkinnyPlan p = skinny_plan(n, m, k, l, dtype, trans_x != 0, trans_w != 0, aligned != 0);
  if (p.path != PATH_FMA) return 0;
  const SplitK sk = gemm_plan_for(n, m, k, l);
  return sk.splits > 1 ? (long long)sk.splits * n * m * l : 0;
}

// One call: its arguments come as one block of 13 int64 -- x, w, scale, out,
// workspace (addresses; 0 for no scale or no workspace), n, m, k, l, dtype,
// trans_x, trans_w, stream -- because ctypes converts each argument of a
// call on the host, and 13 of them cost about as much as the launch.
// Returns cudaGetLastError() after the launches (0 on success); they are
// asynchronous on `stream`.
extern "C" int plora_packed_matmul(const long long* a) {
  const void* x = reinterpret_cast<const void*>(a[0]);
  const void* w = reinterpret_cast<const void*>(a[1]);
  const float* scale = reinterpret_cast<const float*>(a[2]);
  void* out = reinterpret_cast<void*>(a[3]);
  float* workspace = reinterpret_cast<float*>(a[4]);
  const int n = (int)a[5], m = (int)a[6], k = (int)a[7], l = (int)a[8], dtype = (int)a[9];
  const bool tx = a[10] != 0, tw = a[11] != 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a[12]);
  if (n <= 0 || m <= 0 || k <= 0 || l <= 0) return (int)cudaErrorInvalidValue;
  const SkinnyPlan p = skinny_plan(n, m, k, l, dtype, tx, tw, aligned16(x, w, out));
  if (p.path == PATH_DECODE) {
    const cudaError_t err = launch_decode_rows(static_cast<const bf16*>(x),
                                               static_cast<const bf16*>(w), scale,
                                               static_cast<bf16*>(out), n, m, k, l, p, st);
    const cudaError_t last = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : last);
  }
  if (p.path == PATH_MMA) return launch_mma(x, w, scale, out, n, m, k, l, tx, tw, p, st);
  if (p.path == PATH_F32SKINNY) {
    const cudaError_t err = launch_f32skinny(static_cast<const float*>(x),
                                             static_cast<const float*>(w), scale,
                                             static_cast<float*>(out), n, m, k, l, tw, p, st);
    const cudaError_t last = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : last);
  }
  if (dtype == 0) return launch_fma<float>(x, w, scale, out, workspace, n, m, k, l, tx, tw, st);
  if (dtype == 1)
    return launch_fma<__nv_bfloat16>(x, w, scale, out, workspace, n, m, k, l, tx, tw, st);
  return (int)cudaErrorInvalidValue;
}

// The two passes of one LoRA delta, out = scale[n] * (x[n] @ a[n]) @ b[n],
// when both take the "decode" path: xa = cast(x @ a) (bf16, what the first
// of two packed_matmul calls returns) and then out from xa, the second
// launch a programmatic dependent of the first. The same kernels and plans
// as two plora_packed_matmul calls, so the same bits. Arguments: one block
// of 12 int64 -- x, a, b, scale, xa, out (addresses; 0 for no scale), n, m,
// k (d_in), r, l (d_out), stream. Returns cudaErrorInvalidValue, launching
// nothing, unless both passes plan to "decode"; else cudaGetLastError()
// after the launches.
extern "C" int plora_packed_lora_delta(const long long* a) {
  const bf16* x = reinterpret_cast<const bf16*>(a[0]);
  const bf16* wa = reinterpret_cast<const bf16*>(a[1]);
  const bf16* wb = reinterpret_cast<const bf16*>(a[2]);
  const float* scale = reinterpret_cast<const float*>(a[3]);
  bf16* xa = reinterpret_cast<bf16*>(a[4]);
  bf16* out = reinterpret_cast<bf16*>(a[5]);
  const int n = (int)a[6], m = (int)a[7], k = (int)a[8], r = (int)a[9], l = (int)a[10];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a[11]);
  if (n <= 0 || m <= 0 || k <= 0 || r <= 0 || l <= 0 || n > 65535) return (int)cudaErrorInvalidValue;
  const SkinnyPlan p1 = skinny_plan(n, m, k, r, 1, false, false, aligned16(x, wa, xa));
  const SkinnyPlan p2 = skinny_plan(n, m, r, l, 1, false, false, aligned16(xa, wb, out));
  if (p1.path != PATH_DECODE || p2.path != PATH_DECODE) return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_decode_rows(x, wa, nullptr, xa, n, m, k, r, p1, st);
  if (e == cudaSuccess)
    e = p2.cls == CLASS_SHORT_K
            ? launch_decode_short_k(xa, wb, scale, out, n, m, r, l, p2, true, st)
            : launch_decode_rows(xa, wb, scale, out, n, m, r, l, p2, st);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}
