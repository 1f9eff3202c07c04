#!/usr/bin/env python3
"""Device and host time per call of the port's ``packed_matmul`` kernel at
the qwen25-7b shapes, and one profiled impl="auto" train step, on one CUDA
card.

    python3 scripts/packed_call_times.py                  # this checkout
    python3 scripts/packed_call_times.py --src OTHER/src  # another tree's port
    python3 scripts/packed_call_times.py --no-train       # kernel rows only
    python3 scripts/packed_call_times.py --cases decode   # some shapes only
    python3 scripts/packed_call_times.py --dtype float32 --cases launcher,train --no-train

bf16 (or ``--dtype float32``), r=16, at the training shapes (N=2 adapters x M=1024 tokens: xA,
(xA)B and the four backward cases on transposed views), prefill (N=1,
M=256) and decode (N=8, M=1), for each projection (d_in, d_out) of a layer;
at decode also both passes as one ``packed_matmul_pair`` call ("pair",
against two ``torch.bmm`` calls) where the tree has it; "launcher": the
calls ``python -m repro_torch.launch.train``'s ``--impl auto`` makes of
each same-rank segment of chip_smoke.py's launcher pack (N=1 x M=1024 at
r=8 and r=16: xA, (xA)B, backward cases 2 and 4).
Each row holds the kernel against its plain version and carries, for the
kernel and for ``torch.bmm`` on the same operands: ``ms`` (20 calls back to
back, CUDA events), ``device_ms`` (a CUDA graph of 20 calls replayed: the
host out of the loop) and ``host_us`` (host time per call, not
synchronised), plus the plan's ``path`` where the tree has
``packed_matmul_path``. Then the train phase's pack (chip_smoke.py's
TRAIN_* settings) on full-width, full-depth qwen25-7b with random weights:
3 auto steps (the last two timed), then one under ``torch.profiler``, with
``packed_matmul``'s share of the device time; the table goes to
``<out>/<label>/profile_train_auto.txt``.

The measuring code is this checkout's ``chip_smoke.py`` whatever ``--src``
says, so two trees are measured alike. Prints the card's ``nvidia-smi``
name and power limit, then one JSON line per row. Comparing two trees means
one call of this script per tree on one card, in turns
(a, b, b, a).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CASES = {"train": (2, 1024), "prefill": (1, 256), "decode": (8, 1), "launcher": None}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="this", help="a name for this tree in the output")
    ap.add_argument("--out", default=str(ROOT / "smoke_out"), help="where the profile table goes")
    ap.add_argument("--no-train", action="store_true", help="skip the profiled train step")
    ap.add_argument("--cases", default="train,prefill,decode", help="comma-separated shapes to time")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("packed_call_times: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import packed_matmul as P
    from repro_torch.kernels.ref import packed_matmul_ref

    smi = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    dt = getattr(torch, args.dtype)

    def rnd(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def lib(x, w, s=None):
        return torch.bmm(x, w)

    rows = []
    shapes = [(case, shape) for case in args.cases.split(",")
              for shape in ([(n, m, r, cs.SWEEP_CALLS) for n, m, r in cs.launcher_segments()]
                            if case == "launcher" else [CASES[case] + (cs.RANK, None)])]
    for case, (n, m, rank, only) in shapes:
        scale = torch.linspace(0.5, 2.0, n, device=dev)
        for (d_in, d_out), _ in cs.PROJ:
            specs = []
            for call, args_fn, flops, bwd in cs.packed_calls(rnd, dt, n, m, d_in, d_out, rank, scale,
                                                             backward_cases=case in ("train", "launcher")):
                if only is not None and call not in only:
                    continue
                def kfn(x, w, s=None, bwd=bwd):
                    return P.packed_matmul(x, w, s, backward=bwd)

                path_fn = (lambda x, w, s=None: P.packed_matmul_path(x, w)) \
                    if hasattr(P, "packed_matmul_path") else None
                specs.append((call, args_fn, kfn, packed_matmul_ref, lib, flops, path_fn))
            if case == "decode" and hasattr(P, "packed_matmul_pair"):
                args_fn, kfn, pfn, lfn, flops, path_fn = cs.pair_call(torch, rnd, dt, n, m, d_in, d_out,
                                                                      cs.RANK, scale)
                specs.append(("pair", args_fn, kfn, pfn, lfn, flops, path_fn))
            for call, args_fn, kfn, pfn, lfn, flops, path_fn in specs:
                first = args_fn()
                got, want = kfn(*first), pfn(*first)
                in_bytes = cs.nbytes(*[a for a in first if a is not None]) + cs.nbytes(got)
                sets = [first] + [args_fn() for _ in range(cs.copies_for(in_bytes) - 1)]
                row = {"label": args.label, "case": case, "call": call, "d_in": d_in, "d_out": d_out,
                       "n": n, "m": m, "r": rank, "dtype": args.dtype, "copies": len(sets),
                       "rel_err": ((got.float() - want.float()).abs().max()
                                   / want.float().abs().max().clamp_min(1e-30)).item(),
                       "bound_ms": cs.bound(in_bytes, flops, args.dtype)[0]}
                if path_fn is not None:
                    row["path"] = path_fn(*first)
                for key, fn in (("", kfn), ("library_", lfn)):
                    row[key + "ms"] = cs.time_ms(torch, fn, sets)
                    row[key + "device_ms"] = cs.device_ms(torch, fn, sets)
                    row[key + "host_us"] = cs.host_us(torch, fn, sets)
                print(cs.json.dumps(row), flush=True)
                rows.append(row)
                del sets, first, got, want
            torch.cuda.empty_cache()
    print(cs.json.dumps(summary(cs, rows, args.label)), flush=True)
    if not args.no_train:
        train_profile(torch, cs, dev, Path(args.out) / args.label, args.label)
    return 0


# the calls of a layer's use, as chip_smoke.py's kernels line groups them
USES = {"decode": ("decode", ("xA", "xAB")), "decode_pair": ("decode", ("pair",)),
        "prefill": ("prefill", ("xA", "xAB")),
        "train_forward": ("train", ("xA", "xAB")), "train_backward": ("train", ("bwd2_dxA", "bwd4_dx")),
        "launcher_forward": ("launcher", ("xA", "xAB")),
        "launcher_backward": ("launcher", ("bwd2_dxA", "bwd4_dx"))}
KEYS = ("ms", "device_ms", "host_us", "library_ms", "library_device_ms", "library_host_us", "bound_ms")


def summary(cs, rows, label: str) -> dict:
    """Per use: the times summed over one decoder layer's projections
    (weighted by their count per layer), and the mean host µs per call over
    every row of the use."""
    mult = dict(cs.PROJ)
    out = {"label": label, "phase": "layer_sums"}
    for use, (case, calls) in USES.items():
        sel = [r for r in rows if r["case"] == case and r["call"] in calls]
        if not sel:
            continue
        out[use] = {k: sum(mult[(r["d_in"], r["d_out"])] * r[k] for r in sel) for k in KEYS}
        out[use]["mean_host_us"] = sum(r["host_us"] for r in sel) / len(sel)
        out[use]["mean_library_host_us"] = sum(r["library_host_us"] for r in sel) / len(sel)
    out["mean_host_us_all_rows"] = sum(r["host_us"] for r in rows) / len(rows)
    out["mean_library_host_us_all_rows"] = sum(r["library_host_us"] for r in rows) / len(rows)
    return out


def train_profile(torch, cs, dev, out_dir: Path, label: str) -> None:
    from repro_torch.models.model import init_model
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import make_packed_step

    cfg, meta, lora, batches = cs.train_setup(torch, dev)
    base, _ = init_model(cs.SEED, cfg, None, dtype=torch.bfloat16, device=dev)
    step = make_packed_step(cfg, meta.n, impl="auto", ranks=meta.ranks)
    scales, lr_vec = meta.scales(dev), meta.lr_vector(dev)
    opt = init_opt_state(lora)
    times = []
    for batch in batches[:3]:
        t0 = time.perf_counter()
        lora, opt, _ = step(base, lora, opt, batch, scales, lr_vec, None)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out_dir.mkdir(parents=True, exist_ok=True)
    row = cs.profile_train(torch, step, base, lora, opt, batches[3], meta, out_dir, "auto", None)
    print(cs.json.dumps({"label": label, "phase": "train_auto", "step_s": times,
                         "step_s_after_first": sum(times[1:]) / 2,
                         "profiled_wall_ms": row["wall_ms"], "device_ms": row["device_ms"],
                         "packed_matmul_device_ms": row["packed_matmul_device_ms"],
                         "packed_matmul_device_share": row["packed_matmul_device_share"]}),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
