// Fused base + LoRA delta on a quantized W, dequantized inside the K loop:
// y[n] = x[n] @ deq(W) + scale[n] * (x[n] @ A[n]) @ B[n].
//
// Replaces the quantized branch of the Pallas TPU kernel
// src/repro/kernels/fused.py (fused_matmul with w_scales ->
// _fused_kernel_q, whose W tiles _dequant_tile dequantizes in registers).
// W arrives as codes + scales (kernels/quant.py): int8 codes (K, L) with one
// f32 scale per column (1, L), or nf4 codes (K/2, L) uint8, two K rows per
// byte (low nibble = the even row), with f32 scales (K/blk, L). Each W
// element is the f32 product code * scale (nf4: codebook[code] * scale),
// rounded once to the compute type as the tile is staged; a dense W is never
// materialized. On the wgmma path the producer warpgroup of fused.cuh's
// kernel loads the codes one K step ahead, looks nf4 codes up in a 16-entry
// shared-memory table, and writes each dequantized tile into the layout the
// dense kernel's TMA load gives. Everything else -- the paths, the split
// plan, the wgmma sequence, the rounding points -- is the dense kernel's, so
// a call is bit-equal to the dense kernel on cast(dequantize(W)), the Pallas
// kernel's contract (fused.py:37-46).
//
// What bounds it on an H100. Training (M = B*S = 1024 tokens per adapter):
// the tensor cores, as for the dense kernel; the dequantization adds one
// multiply and one rounding per W element per 128-row block, done by the
// producer while the consumers multiply, and the weight bytes read drop 2x
// (int8) or ~3.6x (nf4). Decode (at most 16 rows) is bytes-bound on the
// codes: decode.cuh's weight-streaming kernel loads them in 8-byte vectors
// and dequantizes each row pair before it multiplies it, in the dense call's
// order of sums. On an f32 x at those shapes the FP32 pipes bound it, as
// the dense f32 call: ffma.cuh's tiled FFMA kernel stages the dequantized
// f32 tile from registers where the dense call copies W by cp.async, and
// multiplies it in the same order.
#include "fused.cuh"

using namespace plora;

static bool q_aligned(const void* x, const void* codes, const float* scales) {
  return aligned_to(x, 16) && aligned_to(codes, 8) && aligned_to(scales, 16);
}

template <typename T>
static int run(const Plan& pl, const void* x, const void* codes, const float* scales,
               const void* a, const void* b, const float* scale, void* y, float* workspace, int n,
               int m, int k, int l, int r, int mode, int blk, cudaStream_t stream) {
  if (mode == 0)
    return launch_fused<T>(pl, x, Int8W<T>{static_cast<const int8_t*>(codes), scales, l}, a, b,
                           scale, y, workspace, n, m, k, l, r, stream);
  return launch_fused<T>(pl, x, Nf4W<T>{static_cast<const uint8_t*>(codes), scales, l, blk}, a,
                         b, scale, y, workspace, n, m, k, l, r, stream);
}

// The plan of a call from its sizes and its operands' flags -- aligned: x
// and the scales start on 16 bytes, the codes on 8; ab_aligned: A and B
// start on 16 bytes. The same plan as the dense kernel's (fused.cu) on a
// row-major W, so a call takes the path and the order of sums of the dense
// call on the dequantized W; splits as there. Returns the path and stores
// the f32 workspace (elements) it needs and the K ranges of its base
// product.
extern "C" int plora_fused_matmul_q_plan(int n, int m, int k, int l, int r, int dtype,
                                         int aligned, int ab_aligned, int splits,
                                         long long* workspace, int* k_splits) {
  const Plan pl = make_plan(aligned != 0, ab_aligned != 0, false, dtype, n, m, k, l, r, splits);
  *workspace = pl.workspace;
  *k_splits = pl.splits_y;
  return pl.path;
}

// One call: its arguments come as one block of 18 int64 -- x, codes,
// scales, a, b, scale, y, workspace (addresses; 0 for no scale or no
// workspace), n, m, k, l, r, dtype (0 float32, 1 bfloat16), mode (0 int8,
// 1 nf4), blk (nf4: the rows of one scale block, dividing k), splits (the
// K ranges asked for, 0: the plan's choice), stream.
// Returns cudaGetLastError() after the launches (0 on success); they are
// asynchronous on `stream`.
extern "C" int plora_fused_matmul_q(const long long* args) {
  const void* x = reinterpret_cast<const void*>(args[0]);
  const void* codes = reinterpret_cast<const void*>(args[1]);
  const float* scales = reinterpret_cast<const float*>(args[2]);
  const void* a = reinterpret_cast<const void*>(args[3]);
  const void* b = reinterpret_cast<const void*>(args[4]);
  const float* scale = reinterpret_cast<const float*>(args[5]);
  void* y = reinterpret_cast<void*>(args[6]);
  float* workspace = reinterpret_cast<float*>(args[7]);
  const int n = (int)args[8], m = (int)args[9], k = (int)args[10], l = (int)args[11];
  const int r = (int)args[12], dtype = (int)args[13], mode = (int)args[14], blk = (int)args[15];
  const int splits = (int)args[16];
  cudaStream_t st = reinterpret_cast<cudaStream_t>(args[17]);
  if (const int bad = check_sizes(n, m, k, l, r)) return bad;
  if (mode != 0 && (mode != 1 || k % 2 || blk <= 0 || k % blk)) return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(q_aligned(x, codes, scales), aligned_to(a, 16) && aligned_to(b, 16),
                            false, dtype, n, m, k, l, r, splits);
  if (dtype == 0)
    return run<float>(pl, x, codes, scales, a, b, scale, y, workspace, n, m, k, l, r, mode, blk,
                      st);
  if (dtype == 1)
    return run<bf16>(pl, x, codes, scales, a, b, scale, y, workspace, n, m, k, l, r, mode, blk,
                     st);
  return (int)cudaErrorInvalidValue;
}
