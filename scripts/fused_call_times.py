#!/usr/bin/env python3
"""Per-call times of the port's fused base+LoRA kernels at the qwen25-7b
training shapes, on one CUDA card.

    python3 scripts/fused_call_times.py                  # this checkout
    python3 scripts/fused_call_times.py --src OTHER/src  # another tree's port

For each projection shape (d_in, d_out) of a qwen25-7b layer at N=2
adapters x M=1024 tokens, r=16, bf16, it times with CUDA events (inputs
cycled through enough copies to miss the 50 MB L2): ``fused_matmul``'s
forward and dx (W^T read in place), ``fused_matmul_q`` on int8 and nf4
codes, and the library composition ``baddbmm(x@W, bmm(x,A)*s, B)``. Each
kernel is also held against its plain version (max |err| / max |plain|).
Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per shape. Comparing two trees means one call of this script per tree in
one session on one card, in turns (a, b, b, a).
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

PROJ = ((3584, 3584), (3584, 512), (3584, 18944), (18944, 3584))
N, M, R = 2, 1024, 16


def time_ms(torch, fn, arg_sets, iters: int) -> float:
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent.parent / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="", help="a name for this tree in the output")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("fused_call_times: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import fused as F
    from repro_torch.kernels.quant import dequantize, quantize_weight
    from repro_torch.kernels.ref import fused_matmul_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dt = torch.bfloat16

    def rnd(shape, std=1.0, dtype=dt):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def lib(x, w, a, b, s):
        return torch.baddbmm(torch.matmul(x, w), torch.bmm(x, a) * s.view(-1, 1, 1).to(x.dtype), b)

    def rel(got, want):
        return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()

    s = torch.linspace(0.5, 2.0, N, device=dev)
    for d_in, d_out in PROJ:
        nbytes = 2 * (N * M * (d_in + d_out) + d_in * d_out)
        copies = max(1, min(16, math.ceil(100e6 / nbytes)))
        fwd = [(rnd((N, M, d_in)), rnd((d_in, d_out), d_in ** -0.5), rnd((N, d_in, R), d_in ** -0.5),
                rnd((N, R, d_out)), s) for _ in range(copies)]
        dx = [(rnd((N, M, d_out)), rnd((d_in, d_out), d_in ** -0.5).t(), rnd((N, d_out, R)),
               rnd((N, R, d_in), d_in ** -0.5), s) for _ in range(copies)]
        row = {"label": args.label, "d_in": d_in, "d_out": d_out, "n": N, "m": M, "r": R,
               "copies": copies}
        if hasattr(F, "fused_matmul_path"):
            row["path"] = F.fused_matmul_path(*fwd[0][:2], R)
        row["fwd_rel_err"] = rel(F.fused_matmul(*fwd[0]), fused_matmul_ref(*fwd[0]))
        row["dx_rel_err"] = rel(F.fused_matmul(*dx[0], backward=True), fused_matmul_ref(*dx[0]))
        row["fwd_ms"] = time_ms(torch, F.fused_matmul, fwd, args.iters)
        row["dx_ms"] = time_ms(torch, lambda *a: F.fused_matmul(*a, backward=True), dx, args.iters)
        row["library_fwd_ms"] = time_ms(torch, lib, fwd, args.iters)
        row["library_dx_ms"] = time_ms(torch, lib, dx, args.iters)
        del dx
        for mode in ("int8", "nf4"):
            q = [quantize_weight(rnd((d_in, d_out), d_in ** -0.5, torch.float32), mode)
                 for _ in range(min(copies, 4))]
            sets = [(f[0], qq["codes"], qq["scales"], f[2], f[3], s) for f, qq in zip(fwd, q)]
            got = F.fused_matmul_q(*sets[0])
            dense = F.fused_matmul(sets[0][0], dequantize(q[0], dt), *sets[0][3:])
            row[f"{mode}_bit_equal_dense"] = bool(torch.equal(got, dense))
            row[f"{mode}_ms"] = time_ms(torch, F.fused_matmul_q, sets, args.iters)
            del q, sets
        print(json.dumps(row), flush=True)
        del fwd
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
