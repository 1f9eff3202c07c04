// Fused base + LoRA delta on a dense W: y[n] = x[n] @ W + scale[n] * (x[n] @ A[n]) @ B[n].
//
// Replaces the dense branch of the Pallas TPU kernel
// src/repro/kernels/fused.py (fused_matmul -> _fused_kernel) in both of its
// uses: the forward of every projection under impl="fused", and the
// backward's dx = g @ W^T + scale * (g @ B^T) @ A^T, which is the same
// function on (g, W^T, B^T, A^T) (fused.py:389-401). With trans_w the
// kernel reads W^T through W's own (K_fwd x L_fwd) storage: no transposed
// copy (a copy would move 136 MB for each of gate, up and down of qwen25-7b
// in every layer of every backward). The kernels, their rounding and their
// paths are in fused.cuh.
//
// What bounds it on an H100. Decode (N = 8 rows, M = 1) reads the whole of
// W for 8 rows, about 2 FLOP per weight byte: bytes-bound (W once per
// step). Prefill (M = 256) and training (M = B*S = 1024 tokens per adapter,
// 2-4 adapters) do 256 to 4096 FLOP per weight byte, above the card's bf16
// ridge (~295): there the tensor cores are the limit, and the design is
// fused.cuh's warp-specialised wgmma kernel fed by TMA. The forward's
// row-major W tile is wgmma's MN-major B operand (transpose bit set); dx's
// W^T tile, loaded by TMA from W's own storage, is its K-major B operand.
// Known cost, left for later work: plain FMA off the tensor-core path (f32,
// odd shapes), and three launches in decode.
#include "fused.cuh"

using namespace plora;

static Plan dense_plan(const void* x, const void* w, int dtype, int n, int m, int k, int l, int r) {
  return make_plan(aligned_to(x, 16) && aligned_to(w, 16), dtype, n, m, k, l, r);
}

template <typename T>
static int run(const void* x, const void* w, const void* a, const void* b, const float* scale,
               void* y, float* workspace, int n, int m, int k, int l, int r, int dtype,
               bool trans_w, cudaStream_t stream) {
  const Plan pl = dense_plan(x, w, dtype, n, m, k, l, r);
  const T* wp = static_cast<const T*>(w);
  if (trans_w)  // W^T (k x l) read from W stored (l x k)
    return launch_fused<T>(pl, x, Dense<T, true>{wp, k}, a, b, scale, y, workspace, n, m, k, l, r,
                           stream);
  return launch_fused<T>(pl, x, Dense<T, false>{wp, l}, a, b, scale, y, workspace, n, m, k, l, r,
                         stream);
}

// The path a call with these operands takes: PATH_SPLIT3 or PATH_WGMMA.
extern "C" int plora_fused_matmul_path(const void* x, const void* w, int n, int m, int k, int l,
                                       int r, int dtype) {
  return dense_plan(x, w, dtype, n, m, k, l, r).path;
}

// The f32 workspace (elements) a call with these operands needs.
extern "C" long long plora_fused_matmul_workspace(const void* x, const void* w, int n, int m,
                                                  int k, int l, int r, int dtype) {
  return dense_plan(x, w, dtype, n, m, k, l, r).workspace;
}

// dtype: 0 = float32, 1 = bfloat16; trans_w: 1 when the (k x l) W operand
// is W^T of a row-major (l x k) array. Returns cudaGetLastError() after the
// launches (0 on success); they are asynchronous on `stream`.
extern "C" int plora_fused_matmul(const void* x, const void* w, const void* a, const void* b,
                                  const float* scale, void* y, float* workspace, int n, int m,
                                  int k, int l, int r, int dtype, int trans_w, void* stream) {
  if (const int bad = check_sizes(n, m, k, l, r)) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(x, w, a, b, scale, y, workspace, n, m, k, l, r, dtype, trans_w != 0, st);
  if (dtype == 1)
    return run<bf16>(x, w, a, b, scale, y, workspace, n, m, k, l, r, dtype, trans_w != 0, st);
  return (int)cudaErrorInvalidValue;
}
