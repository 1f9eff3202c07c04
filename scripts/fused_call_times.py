#!/usr/bin/env python3
"""Device and host time per call of the port's fused base+LoRA kernels at the
qwen25-7b shapes, and optionally profiled train steps, on one CUDA card.

    python3 scripts/fused_call_times.py                   # this checkout
    python3 scripts/fused_call_times.py --src OTHER/src   # another tree's port
    python3 scripts/fused_call_times.py --cases decode    # some cases only
    python3 scripts/fused_call_times.py --train auto,fused,nf4  # + profiled train steps
    python3 scripts/fused_call_times.py --src OLD/src --no-library  # kernels only
    python3 scripts/fused_call_times.py --cases decode --host  # + a host-time breakdown
    python3 scripts/fused_call_times.py --cases train --dtype float32  # the f32 rows
    python3 scripts/fused_call_times.py --cases whisper_enc,whisper_dec \
        --train fused --arch whisper-tiny   # whisper-tiny's rows and its fused step

bf16 (or ``--dtype float32``), r=16, for each projection (d_in, d_out) of a layer: decode (N=8
adapters x M=1 token) ``fused_matmul`` and ``fused_matmul_q`` on int8 and
nf4 codes; prefill (N=1, M=256) ``fused_matmul``; train (N=2, M=1024) the
forward, dx (W^T read in place), int8 and nf4; at whisper-tiny's widths
(its encoder layer, N=2 x M=1,500 frames, and its decoder layer, N=2 x
M=448 tokens) the forward and dx. Each row holds the kernel
against its plain version (``rel_err``), ``fused_matmul_q`` bit-equal to
``fused_matmul`` on the dequantized W, and names the plan's ``path``; for
the kernel and for the library composition ``baddbmm(x@W, bmm(x,A)*s, B)``
(after ``dequantize`` for int8/nf4) it carries ``ms`` (20 calls back to
back, CUDA events), ``device_ms`` (a CUDA graph of 20 calls replayed: the
host out of the loop) and ``host_us`` (host time per call, not
synchronised). Every call set holds its own copy of every operand, W
included, enough copies to miss the 50 MB L2. Then one ``layer_sums``
line: per use, the times summed over a layer's projections (weighted by
their count per layer).

``--host`` (this tree's wrapper only): the host µs of one decode call
broken down into the C call (its launches), the allocation and the rest,
beside one ``torch.bmm``.

``--train RUNS``: chip_smoke.py's train pack on full-width, full-depth
qwen25-7b (or ``--arch``, at its family train length) with random weights,
for each of the runs named (impl="auto", impl="fused", and "nf4":
impl="fused" on an nf4 base): 3 steps (the last two timed), then one under
``torch.profiler`` (device time and busy share, the device ms and launches
of each of the port's kernels, the wrappers' launches by path; tables
under ``<out>/<label>/``). ``--no-library`` leaves out the library
yardstick's times.

The measuring code is this checkout's ``chip_smoke.py`` whatever ``--src``
says, so two trees are measured alike. Prints the card's ``nvidia-smi``
name and power limit, then one JSON line per row. Comparing two trees means
one call of this script per tree on one card, in turns (a, b, b, a).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CASES = {"decode": (8, 1), "prefill": (1, 256), "train": (2, 1024), "whisper_enc": (2, 1500),
         "whisper_dec": (2, 448)}
CALLS = {"decode": ("fused", "int8", "nf4"), "prefill": ("fused",),
         "train": ("fused", "dx", "int8", "nf4"), "whisper_enc": ("fused", "dx"),
         "whisper_dec": ("fused", "dx")}
# chip_smoke.py's case whose projections a case's layer sums (else qwen25-7b's)
SMOKE_CASE = {"whisper_enc": "train_whisper_enc", "whisper_dec": "train_whisper"}
KEYS = ("ms", "device_ms", "host_us", "library_ms", "library_device_ms", "library_host_us",
        "bound_ms")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="this", help="a name for this tree in the output")
    ap.add_argument("--cases", default=",".join(CASES), help="comma-separated cases to time")
    ap.add_argument("--train", default="", help="also profile train steps of these runs "
                    "(comma-separated: auto, fused, nf4 = fused on an nf4 base)")
    ap.add_argument("--no-library", action="store_true",
                    help="time the kernels only, not the library yardstick (a tree whose "
                    "dequantize copies from the host cannot be captured in a CUDA graph)")
    ap.add_argument("--host", action="store_true",
                    help="also break down the host time of one decode call (this tree's wrapper)")
    ap.add_argument("--out", default=str(ROOT / "smoke_out"), help="where the profile tables go")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="x, W, A and B's type (the bound's peak follows it)")
    ap.add_argument("--arch", default="qwen25-7b", help="the model --train steps")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("fused_call_times: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import fused as F
    from repro_torch.kernels.quant import dequantize, quantize_weight
    from repro_torch.kernels.ref import fused_matmul_q_ref, fused_matmul_ref

    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    dt, r = getattr(torch, args.dtype), cs.RANK

    def rnd(shape, dtype=dt, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def lib(x, w, a, b, s):
        return torch.baddbmm(torch.matmul(x, w), torch.bmm(x, a) * s.view(-1, 1, 1).to(x.dtype), b)

    def lib_q(x, codes, scales, a, b, s):
        return lib(x, dequantize({"codes": codes, "scales": scales}, x.dtype), a, b, s)

    def call_spec(call, n, m, d_in, d_out, s):
        """(args_fn, kernel, plain, library, flops, path_fn) of one row."""
        flops = 2 * n * m * (d_in * d_out + d_in * r + r * d_out)
        if call == "fused":
            return (lambda: (rnd((n, m, d_in)), rnd((d_in, d_out), std=d_in ** -0.5),
                             rnd((n, d_in, r), std=d_in ** -0.5), rnd((n, r, d_out)), s),
                    F.fused_matmul, fused_matmul_ref, lib, flops,
                    lambda x, w, a, b, s: F.fused_matmul_path(x, w, r))
        if call == "dx":  # dx = g @ W^T + s * (g @ B^T) @ A^T, W^T a view of the (d_in, d_out) W
            return (lambda: (rnd((n, m, d_out)), rnd((d_in, d_out), std=d_in ** -0.5).t(),
                             rnd((n, d_out, r)), rnd((n, r, d_in), std=d_in ** -0.5), s),
                    lambda *a: F.fused_matmul(*a, backward=True), fused_matmul_ref, lib, flops,
                    lambda g, wt, bt, at, s: F.fused_matmul_path(g, wt, r))

        def q_args(mode=call):
            q = quantize_weight(rnd((d_in, d_out), torch.float32, d_in ** -0.5), mode)
            return (rnd((n, m, d_in)), q["codes"], q["scales"], rnd((n, d_in, r), std=d_in ** -0.5),
                    rnd((n, r, d_out)), s)

        return (q_args, F.fused_matmul_q, fused_matmul_q_ref, lib_q, flops,
                lambda x, c, sc, a, b, s: F.fused_matmul_q_path(x, c, sc, r))

    rows = []
    for case in args.cases.split(","):
        n, m = CASES[case]
        s = torch.linspace(0.5, 2.0, n, device=dev)
        for (d_in, d_out), _ in case_proj(cs, case):
            for call in CALLS[case]:
                args_fn, kfn, pfn, lfn, flops, path_fn = call_spec(call, n, m, d_in, d_out, s)
                first = args_fn()
                got, want = kfn(*first), pfn(*first)
                in_bytes = cs.nbytes(*first[:-1]) + cs.nbytes(got)
                sets = [first] + [args_fn() for _ in range(cs.copies_for(in_bytes) - 1)]
                row = {"label": args.label, "dtype": args.dtype, "case": case, "call": call,
                       "d_in": d_in,
                       "d_out": d_out, "n": n, "m": m, "r": r, "copies": len(sets),
                       "path": path_fn(*first),
                       "rel_err": ((got.float() - want.float()).abs().max()
                                   / want.float().abs().max().clamp_min(1e-30)).item(),
                       "bound_ms": cs.bound(in_bytes, flops, args.dtype)[0]}
                if call in ("int8", "nf4"):
                    x, codes, scales, a, b, _ = first
                    dense = F.fused_matmul(x, dequantize({"codes": codes, "scales": scales}, dt), a, b, s)
                    row["bit_equal_dense"] = bool(torch.equal(got, dense))
                for key, fn in (("", kfn),) + (() if args.no_library else (("library_", lfn),)):
                    row[key + "ms"] = cs.time_ms(torch, fn, sets)
                    row[key + "device_ms"] = cs.device_ms(torch, fn, sets)
                    row[key + "host_us"] = cs.host_us(torch, fn, sets)
                print(cs.json.dumps(row), flush=True)
                rows.append(row)
                del sets, first, got, want
            torch.cuda.empty_cache()
    print(cs.json.dumps(summary(cs, rows, args.label)), flush=True)
    if args.host:
        host_breakdown(torch, cs, F, rnd, args.label)
    if args.train:
        train_profiles(torch, cs, dev, Path(args.out) / args.label, args.label,
                       args.train.split(","), args.arch)
    return 0


def case_proj(cs, case: str):
    """((d_in, d_out), count per layer) of the projections a case times."""
    return cs.case_proj(SMOKE_CASE[case]) if case in SMOKE_CASE else cs.PROJ


def summary(cs, rows, label: str) -> dict:
    """Per use (case and call): the times summed over one layer's
    projections, weighted by their count per layer, and the mean host µs
    per call over the use's rows."""
    out = {"label": label, "phase": "layer_sums"}
    for case, calls in CALLS.items():
        mult = dict(case_proj(cs, case))
        for call in calls:
            sel = [x for x in rows if x["case"] == case and x["call"] == call]
            if sel:
                use = out[f"{case}_{call}"] = {
                    k: sum(mult[(x["d_in"], x["d_out"])] * x[k] for x in sel) for k in KEYS
                    if k in sel[0]}
                for k in ("host_us", "library_host_us"):
                    if k in sel[0]:
                        use["mean_" + k] = sum(x[k] for x in sel) / len(sel)
    return out


def host_breakdown(torch, cs, F, rnd, label: str) -> None:
    """Host µs of one bf16 decode call of ``fused_matmul`` at q's shape
    (N=8, M=1, 3584 x 3584, r=16), the least of 5 rounds of 200 calls: the
    whole call, under no_grad, the C call alone (the plan's launches), the
    allocation of y and xA, and one ``torch.bmm`` of the same x for scale."""
    n, k, r = 8, 3584, 16
    x, w = rnd((n, 1, k)), rnd((k, k), std=k ** -0.5)
    a, b = rnd((n, k, r), std=k ** -0.5), rnd((n, r, k))
    s = torch.ones(n, device=x.device)

    def us(fn):
        return cs.host_us(torch, fn, [()], iters=200, rounds=5)

    row = {"label": label, "phase": "host_breakdown", "call": us(lambda: F.fused_matmul(x, w, a, b, s))}
    with torch.no_grad():
        row["call_no_grad"] = us(lambda: F.fused_matmul(x, w, a, b, s))
    path, n_ws = F._plan("fused", n, 1, k, k, r, 1, 1, 1)
    y, ws, keep = F._outputs(n, 1, k, path, n_ws, x.dtype, 0)
    block = F._ARGS.pack(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), s.data_ptr(),
                         y.data_ptr(), ws, n, 1, k, k, r, 1, 0,
                         torch._C._cuda_getCurrentRawStream(0))
    launch = F._build.load("fused").plora_fused_matmul
    row["c_call"] = us(lambda: launch(block))
    row["outputs"] = us(lambda: F._outputs(n, 1, k, path, n_ws, x.dtype, 0))
    row["bmm"] = us(lambda: torch.bmm(x, a))
    print(cs.json.dumps(row), flush=True)


def train_profiles(torch, cs, dev, out_dir: Path, label: str, runs, arch: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels import launches
    from repro_torch.kernels.quant import quantize_base_params
    from repro_torch.models.model import init_model
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import make_packed_step

    cfg, meta, lora0, batches = cs.train_setup(torch, dev, get_config(arch),
                                               cs.FAMILY_TRAIN_SEQ.get(arch, cs.TRAIN_SEQ), 4)
    base, _ = init_model(cs.SEED, cfg, None, dtype=torch.bfloat16, device=dev)
    scales, lr_vec = meta.scales(dev), meta.lr_vector(dev)
    out_dir.mkdir(parents=True, exist_ok=True)
    for run in runs:
        impl, quant = ("fused", "nf4") if run == "nf4" else (run, None)
        qbase = quantize_base_params(base, quant) if quant else base
        step = make_packed_step(cfg, meta.n, impl=impl, ranks=meta.ranks, base_dtype=quant)
        lora, opt = lora0, init_opt_state(lora0)
        times = []
        for batch in batches[:3]:
            t0 = time.perf_counter()
            lora, opt, _ = step(qbase, lora, opt, batch, scales, lr_vec, None)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches.zero()
        row = cs.profile_train(torch, step, qbase, lora, opt, batches[3], meta, out_dir, impl,
                               quant)
        print(cs.json.dumps({"label": label, "phase": "train_step", "arch": arch, "impl": impl,
                             "quant": quant, "step_s": times,
                             "step_s_after_first": sum(times[1:]) / 2,
                             "profiled_wall_ms": row["wall_ms"], "device_ms": row["device_ms"],
                             "device_busy_share": row["device_busy_share"],
                             "port_kernels": row["port_device_ms"],
                             "launches_by_path": launches.read_paths()}), flush=True)
        del step, lora, opt, qbase
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
