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
// W for 8 rows, about 8 FLOP per weight byte: bytes-bound (W once per
// step); there the design is decode.cuh's weight-streaming kernel. Prefill (M = 256) and training (M = B*S = 1024 tokens per adapter,
// 2-4 adapters) do 256 to 4096 FLOP per weight byte, above the card's bf16
// ridge (~295): there the tensor cores are the limit, and the design is
// fused.cuh's warp-specialised wgmma kernel fed by TMA. The forward's
// row-major W tile is wgmma's MN-major B operand (transpose bit set); dx's
// W^T tile, loaded by TMA from W's own storage, is its K-major B operand.
// In f32 at those shapes the FP32 pipes are the limit (67 TFLOP/s, no
// tensor core at full f32): ffma.cuh's tiled FFMA kernel, 8 x 8 outputs a
// thread fed by a cp.async ring, the delta in its epilogue, in two
// launches; it reads dx's W^T in place at the forward's cost. Decode-size
// f32 calls and odd shapes (K or L not a multiple of 4, operands off 16
// bytes; bf16 W^T at decode rows) keep plain FMA in three launches.
#include "fused.cuh"

using namespace plora;

template <typename T>
static int run(const Plan& pl, const void* x, const void* w, const void* a, const void* b,
               const float* scale, void* y, float* workspace, int n, int m, int k, int l, int r,
               bool trans_w, cudaStream_t stream) {
  const T* wp = static_cast<const T*>(w);
  if (trans_w)  // W^T (k x l) read from W stored (l x k)
    return launch_fused<T>(pl, x, Dense<T, true>{wp, k}, a, b, scale, y, workspace, n, m, k, l, r,
                           stream);
  return launch_fused<T>(pl, x, Dense<T, false>{wp, l}, a, b, scale, y, workspace, n, m, k, l, r,
                         stream);
}

// The plan of a call from its sizes and its operands' flags -- aligned: x
// and W start on 16 bytes; ab_aligned: A and B start on 16 bytes; trans_w:
// W is W^T read in place; splits: the K ranges asked for (0: the plan's
// choice; see make_plan). Returns the path (PATH_SPLIT3, PATH_WGMMA,
// PATH_DECODE or PATH_FFMA) and stores the f32 workspace (elements) it
// needs and the K ranges of its base product.
extern "C" int plora_fused_matmul_plan(int n, int m, int k, int l, int r, int dtype, int aligned,
                                       int ab_aligned, int trans_w, int splits,
                                       long long* workspace, int* k_splits) {
  const Plan pl =
      make_plan(aligned != 0, ab_aligned != 0, trans_w != 0, dtype, n, m, k, l, r, splits);
  *workspace = pl.workspace;
  *k_splits = pl.splits_y;
  return pl.path;
}

// One call: its arguments come as one block of 16 int64 -- x, w, a, b,
// scale, y, workspace (addresses; 0 for no scale or no workspace), n, m, k,
// l, r, dtype (0 float32, 1 bfloat16), trans_w (1 when the (k x l) W operand
// is W^T of a row-major (l x k) array), splits (the K ranges asked for, 0:
// the plan's choice), stream -- because ctypes converts
// each argument of a call on the host. The plan is made from the pointers
// as plora_fused_matmul_plan makes it from their flags. Returns
// cudaGetLastError() after the launches (0 on success); they are
// asynchronous on `stream`.
extern "C" int plora_fused_matmul(const long long* args) {
  const void* x = reinterpret_cast<const void*>(args[0]);
  const void* w = reinterpret_cast<const void*>(args[1]);
  const void* a = reinterpret_cast<const void*>(args[2]);
  const void* b = reinterpret_cast<const void*>(args[3]);
  const float* scale = reinterpret_cast<const float*>(args[4]);
  void* y = reinterpret_cast<void*>(args[5]);
  float* workspace = reinterpret_cast<float*>(args[6]);
  const int n = (int)args[7], m = (int)args[8], k = (int)args[9], l = (int)args[10];
  const int r = (int)args[11], dtype = (int)args[12];
  const bool trans_w = args[13] != 0;
  const int splits = (int)args[14];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(args[15]);
  if (const int bad = check_sizes(n, m, k, l, r)) return bad;
  const Plan pl = make_plan(aligned_to(x, 16) && aligned_to(w, 16),
                            aligned_to(a, 16) && aligned_to(b, 16), trans_w, dtype, n, m, k, l, r,
                            splits);
  if (dtype == 0)
    return run<float>(pl, x, w, a, b, scale, y, workspace, n, m, k, l, r, trans_w, st);
  if (dtype == 1)
    return run<bf16>(pl, x, w, a, b, scale, y, workspace, n, m, k, l, r, trans_w, st);
  return (int)cudaErrorInvalidValue;
}
