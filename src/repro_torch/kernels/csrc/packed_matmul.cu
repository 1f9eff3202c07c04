// Grouped GEMM over packed LoRA adapters: out[n] = scale[n] * (x[n] @ w[n]).
// (scale may be null: no scaling, as the TPU kernel's scale of ones.)
//
// Replaces the Pallas TPU kernel src/repro/kernels/packed_matmul.py
// (packed_matmul -> _matmul_kernel): f32 accumulation over K, then the f32
// per-adapter scale, then one cast to the input type. x (N, M, K), w
// (N, K, L), scale (N,) f32, out (N, M, L), all contiguous row-major; bf16
// or f32.
//
// What bounds it on an H100 at the serving shapes: the rank r (8-128) is
// the small dimension. The two calls of a LoRA projection are
// (N, T, d_in) @ (N, d_in, r) and (N, T, r) @ (N, r, d_out); at r = 16 both
// do about one FLOP per byte read, far below the ~295 FLOP/byte at which
// the tensor cores would become the limit, so the bound is bytes: reading
// A or B once (about 1 MB for decode at N = 8), a fraction of a
// microsecond -- in practice the launch and the K loop's latency.
//
// Design: the adapter is the grid's z axis and each block owns a BM x BN
// output tile of one adapter, looping over K inside the block (the TPU's
// sequential K grid axis becomes that loop). Tiles are staged through
// registers into shared memory as f32 (the next step's loads in flight
// while the current step is multiplied) and multiplied with plain FMA. No
// padding of K, L or the rank to 128 lanes: every edge is masked, so M = 1
// (decode) is as right as a tile multiple. The xA call has a long K and
// only N output tiles, so it splits K across blocks (tile.cuh: SplitK):
// each range writes f32 partial sums and a second kernel adds them in a
// fixed order, then scales and casts once -- the rounding stays the TPU
// kernel's. Known cost, left for later work: no tensor cores, scalar loads.
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

template <typename T>
static int launch(const void* x, const void* w, const float* scale, void* out, float* part,
                  int n, int m, int k, int l, cudaStream_t stream) {
  const SplitK sk = gemm_plan_for(n, m, k, l);
  if (sk.splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  if ((long long)n * sk.splits > 65535) return (int)cudaErrorInvalidValue;
  launch_gemm<T>(static_cast<const T*>(x), static_cast<const T*>(w), scale, static_cast<T*>(out),
                 sk.splits > 1 ? part : nullptr, n, m, k, l, stream);
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

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launches (0 on success); they are asynchronous on `stream`.
extern "C" int plora_packed_matmul(const void* x, const void* w, const float* scale, void* out,
                                   float* workspace, int n, int m, int k, int l, int dtype,
                                   void* stream) {
  if (n <= 0 || m <= 0 || k <= 0 || l <= 0) return (int)cudaErrorInvalidValue;
  if ((m + ThinTile::BM - 1) / ThinTile::BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, scale, out, workspace, n, m, k, l, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, scale, out, workspace, n, m, k, l, st);
  return (int)cudaErrorInvalidValue;
}
