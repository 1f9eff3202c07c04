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
// Design: the adapter is the grid's z axis and each block owns a BM x BN
// output tile of one adapter, looping over K inside the block (the TPU's
// sequential K grid axis becomes that loop). Tiles are staged through
// registers into shared memory as f32 (the next step's loads in flight
// while the current step is multiplied) and multiplied with plain FMA; a
// transposed operand is staged with its adjacent index across neighbouring
// threads, so its loads stay coalesced. No padding of K, L or the rank to
// 128 lanes: every edge is masked, so M = 1 (decode) is as right as a tile
// multiple. A call with a long K and few output tiles (xA, dB, dA) splits K
// across blocks (tile.cuh: SplitK): each range writes f32 partial sums and a
// second kernel adds them in a fixed order, then scales and casts once --
// the rounding stays the TPU kernel's, and the result is deterministic.
// Known cost, left for later work: no tensor cores, scalar loads, and a
// 64-column tile that is three quarters idle when the output is r = 16
// wide (cases 2 and 3).
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

template <typename T, bool TX, bool TW>
static void launch_tr(const void* x, const void* w, const float* scale, void* out, float* part,
                      int n, int m, int k, int l, cudaStream_t stream) {
  const Dense<T, TX> xs{static_cast<const T*>(x), TX ? m : k};
  const Dense<T, TW> ws{static_cast<const T*>(w), TW ? k : l};
  launch_gemm<T>(xs, ws, scale, static_cast<T*>(out), part, n, m, k, l, stream);
}

template <typename T>
static int launch(const void* x, const void* w, const float* scale, void* out, float* part,
                  int n, int m, int k, int l, bool trans_x, bool trans_w, cudaStream_t stream) {
  const SplitK sk = gemm_plan_for(n, m, k, l);
  if (sk.splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  if ((long long)n * sk.splits > 65535) return (int)cudaErrorInvalidValue;
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

// The f32 workspace (elements) a call of these sizes needs: the partial
// sums of its K ranges, or 0 when K is not split.
extern "C" long long plora_packed_matmul_workspace(int n, int m, int k, int l) {
  const SplitK sk = gemm_plan_for(n, m, k, l);
  return sk.splits > 1 ? (long long)sk.splits * n * m * l : 0;
}

// dtype: 0 = float32, 1 = bfloat16; trans_x / trans_w: 1 when that
// operand is stored transposed (see the top of this file). Returns
// cudaGetLastError() after the launches (0 on success); they are
// asynchronous on `stream`.
extern "C" int plora_packed_matmul(const void* x, const void* w, const float* scale, void* out,
                                   float* workspace, int n, int m, int k, int l, int dtype,
                                   int trans_x, int trans_w, void* stream) {
  if (n <= 0 || m <= 0 || k <= 0 || l <= 0) return (int)cudaErrorInvalidValue;
  if ((m + ThinTile::BM - 1) / ThinTile::BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tx = trans_x != 0, tw = trans_w != 0;
  if (dtype == 0) return launch<float>(x, w, scale, out, workspace, n, m, k, l, tx, tw, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, scale, out, workspace, n, m, k, l, tx, tw, st);
  return (int)cudaErrorInvalidValue;
}
