#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # everything, on cuda:0

Phases, each of which fails the run (non-zero exit, no result line):

1. device  -- needs ``torch.cuda.is_available()``; prints the card's name
   and power limit as ``nvidia-smi`` reports them; turns TF32 off.
2. build   -- compiles every kernel of ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (one process per source, all at once).
3. kernels -- calls each kernel at the qwen25-7b serving shapes (decode:
   N=8 rows, M=1; prefill: N=1, M=256; r=16; plus a ragged pack of ranks
   (8, 16)) in bf16 and f32, holds it against its plain version, and times
   kernel, plain version and one PyTorch library call with CUDA events.
4. serve   -- full-width qwen25-7b (28 layers, bf16, random weights from a
   seed), 8 published adapters of rank 8 or 16 with non-zero B, 16 requests
   through ``ServeEngine.serve`` under impl="auto" (packed_matmul kernel)
   and impl="fused" (fused kernel). Launch counts are zeroed just before
   each drain and read just after. Prefill logits and 4 teacher-forced
   decode steps are held against the plain-version path on the same
   weights. Then a short drain of each impl runs under ``torch.profiler``
   (device busy share, device time by kernel).

Prints one JSON line per measurement, then a ``kernels`` line, then
``{"ok": true, "device": {...}}`` last. Details also go to
``smoke_out/`` (``chip_smoke.json``, ``profile_<impl>.txt``, the nvcc
logs with ``ptxas -v``).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet; dense, no sparsity)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Max |kernel - plain| over max |plain|, per dtype. f32: only the order of
# the f32 sums differs; over K <= 18944 that is about sqrt(K) * 2^-24, some
# 1e-5 of the largest output at worst. bf16: besides, the one final cast may
# round the other way: one bf16 ulp, at most 2^-7 of the largest output.
KERNEL_TOL = {"float32": 5e-5, "bfloat16": 2 ** -7}
# Serve-phase logits, bf16 end to end: a 1-ulp difference in one projection
# output passes through up to 28 layers; held relative to max |logit|.
LOGIT_TOL = 0.05

# (d_in, d_out) of one qwen25-7b layer's projections, with their count
PROJ = [((3584, 3584), 2), ((3584, 512), 2), ((3584, 18944), 2), ((18944, 3584), 1)]
RANK = 16
CASES = {"decode": (8, 1), "prefill": (1, 256)}

RECORDS = []


def emit(obj) -> None:
    RECORDS.append(obj)
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, arg_sets, iters: int = 20) -> float:
    """Mean ms per call over ``iters`` calls, cycling through ``arg_sets``
    (enough copies of the inputs that they do not stay in the 50 MB L2)."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    return max(1, min(32, math.ceil(100e6 / max(nbytes, 1))))


def bound(nbytes: float, flops: float, dtype: str):
    t_b, t_f = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations"), t_b, t_f


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def kernel_phase(torch, dev):
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused import fused_matmul
    from repro_torch.kernels.packed_matmul import packed_matmul
    from repro_torch.kernels.ref import fused_matmul_ref, packed_matmul_ref

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    rows = []

    def check(name, case, call, d_in, d_out, dtype, kfn, pfn, lfn, args_fn, flops):
        args = args_fn()
        got = kfn(*args)
        want = pfn(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = KERNEL_TOL[str(dtype).split(".")[-1]] * max(scale, 1e-30)
        if not (math.isfinite(err) and err <= tol):
            fail(f"{name} {case} {call} ({d_in},{d_out}) {dtype}: max_abs_err {err} > {tol}")
        in_bytes = nbytes(*[a for a in args if a is not None]) + nbytes(got)
        sets = [args] + [args_fn() for _ in range(copies_for(in_bytes) - 1)]
        ms = time_ms(torch, kfn, sets)
        plain_ms = time_ms(torch, pfn, sets)
        library_ms = time_ms(torch, lfn, sets)
        dname = str(dtype).split(".")[-1]
        b_ms, b_by, _, _ = bound(in_bytes, flops, dname)
        row = {"phase": "kernel", "kernel": name, "case": case, "call": call,
               "d_in": d_in, "d_out": d_out, "dtype": dname, "max_abs_err": err,
               "tol": tol, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": in_bytes, "flops": flops}
        emit(row)
        rows.append(row)
        del sets, args, got, want

    def lib_bmm(x, w, s=None):
        return torch.bmm(x, w)

    def lib_fused(x, w, a, b, s):
        return torch.baddbmm(torch.matmul(x, w), torch.bmm(x, a) * s.view(-1, 1, 1).to(x.dtype), b)

    for dtype in (torch.bfloat16, torch.float32):
        for case, (n, m) in CASES.items():
            for (d_in, d_out), _ in PROJ:
                scale = torch.linspace(0.5, 2.0, n, device=dev)
                check("packed_matmul", case, "xA", d_in, d_out, dtype,
                      packed_matmul, packed_matmul_ref, lib_bmm,
                      lambda: (rnd((n, m, d_in), dtype), rnd((n, d_in, RANK), dtype, d_in ** -0.5)),
                      2 * n * m * d_in * RANK)
                check("packed_matmul", case, "xAB", d_in, d_out, dtype,
                      packed_matmul, packed_matmul_ref, lib_bmm,
                      lambda: (rnd((n, m, RANK), dtype), rnd((n, RANK, d_out), dtype), scale),
                      2 * n * m * RANK * d_out)
                check("fused_matmul", case, "fused", d_in, d_out, dtype,
                      fused_matmul, fused_matmul_ref, lib_fused,
                      lambda: (rnd((n, m, d_in), dtype), rnd((d_in, d_out), dtype, d_in ** -0.5),
                               rnd((n, d_in, RANK), dtype, d_in ** -0.5),
                               rnd((n, RANK, d_out), dtype), scale),
                      2 * n * m * (d_in * d_out + d_in * RANK + RANK * d_out))
        # a ragged pack: ranks (8, 16) padded to a bucket of 16
        ranks = (8, 16)
        x = rnd((2, 4, 3584), dtype)
        w = rnd((3584, 3584), dtype, 3584 ** -0.5)
        a = rnd((2, 3584, 16), dtype, 3584 ** -0.5)
        b = rnd((2, 16, 3584), dtype)
        al = torch.tensor([2.0, 0.5], device=dev)
        for name, kimpl, pimpl, fn in (
            ("packed_lora_delta", "pallas", "plain", lambda i: ops.packed_lora_delta(x, a, b, al, impl=i, ranks=ranks)),
            ("fused_lora_linear", "fused_pallas", "fused_plain", lambda i: ops.fused_lora_linear(x, w, a, b, al, impl=i, ranks=ranks)),
        ):
            got, want = fn(kimpl), fn(pimpl)
            err = (got.float() - want.float()).abs().max().item()
            tol = KERNEL_TOL[str(dtype).split(".")[-1]] * want.float().abs().max().item()
            if not err <= tol:
                fail(f"ragged {name} {dtype}: max_abs_err {err} > {tol}")
            emit({"phase": "ragged", "op": name, "ranks": list(ranks),
                  "dtype": str(dtype).split(".")[-1], "max_abs_err": err, "tol": tol})
    return rows


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------


def make_adapters(torch, cfg, n: int):
    """``n`` host adapter trees (f32 numpy), ranks alternating 8 and 16, A
    ~ N(0, 1/d_in) and B ~ N(0, 0.25/r): non-zero deltas about half the
    size of the base projection's output at scale alpha/r = 1."""
    from repro_torch.configs import LoraConfig
    from repro_torch.core.adapter import pack_meta
    from repro_torch.models.model import lora_zeros
    from repro_torch.tree import tree_map

    gen = torch.Generator().manual_seed(SEED + 1)
    out = []
    for i in range(n):
        r = 8 if i % 2 == 0 else 16
        tmpl = lora_zeros(cfg, pack_meta([LoraConfig(rank=r, alpha=float(r))]), torch.float32, "cpu")

        def fill(t, r=r):
            if t.shape[-1] == r:  # a: (L, 1, d_in, r)
                return (torch.randn(t.shape, generator=gen) * t.shape[-2] ** -0.5).numpy()
            return (torch.randn(t.shape, generator=gen) * (0.25 / r) ** 0.5).numpy()

        tree = tree_map(fill, tmpl)
        # drop the width-1 pack axis: what extract_adapter would give
        out.append((tree_map(lambda t: t[:, 0] if t.ndim == 4 else t[0], tree), r))
    return out


def teacher_forced(torch, cfg, base, adapters, prompts, smax, kimpl, pimpl, counter, steps=4):
    """Prefill 8 rows (one adapter each) and decode ``steps`` tokens at
    width 8, once through the kernel path and once through the plain path,
    feeding both the kernel path's greedy tokens. Returns the max abs logit
    difference per step (prefill first), the max abs plain logit, and the
    kernel's launches per decode step (``counter`` is its wrapper)."""
    from repro_torch import bridge
    from repro_torch.configs import LoraConfig
    from repro_torch.core.adapter import pack_meta
    from repro_torch.core.packed_lora import inject_adapter
    from repro_torch.kernels.ops import KernelConfig
    from repro_torch.models.model import decode_step, init_caches, lora_zeros, prefill
    from repro_torch.serve.decode import pad_caches
    from repro_torch.serve.engine import write_row_caches
    from repro_torch.tree import tree_map

    dev = base["embed"]["w"].device
    rows = len(adapters)
    meta1 = pack_meta([LoraConfig(rank=16, alpha=16.0)])
    meta = pack_meta([LoraConfig(rank=16, alpha=16.0)] * rows)
    tmpl = tree_map(lambda t: t.numpy(), lora_zeros(cfg, meta1, torch.float32, "cpu"))
    scales = torch.ones((rows,), dtype=torch.float32, device=dev)  # alpha / r = 1
    teacher = []
    logs = {}
    for path in (kimpl, pimpl):
        kc1 = KernelConfig(impl=path, ranks=meta1.ranks)
        kc = KernelConfig(impl=path, ranks=meta.ranks)
        caches = init_caches(cfg, rows, smax, device=dev)
        lora = lora_zeros(cfg, meta, torch.bfloat16, dev)
        lg_all = []
        for i, ((tree, _r), p) in enumerate(zip(adapters, prompts)):
            lora1 = bridge.to_torch(inject_adapter(tmpl, tree, 0), dev, torch.bfloat16)
            write_row_caches(lora, lora1, i)
            lg, c1 = prefill(base, lora1, scales[:1], {"tokens": torch.from_numpy(p[None]).to(dev)},
                             cfg, kcfg=kc1)
            write_row_caches(caches, pad_caches(c1, smax), i)
            lg_all.append(lg[0, -1, : cfg.vocab_size].float())
        step_lg = [torch.stack(lg_all)]
        pos = torch.tensor([len(p) for p in prompts], device=dev)
        n0 = counter.launches
        for s in range(steps):
            if path == kimpl:
                teacher.append(torch.argmax(step_lg[-1], dim=-1).to(torch.int32))
            lg, caches = decode_step(base, lora, scales, teacher[s][:, None], caches, pos, cfg,
                                     n_pack=rows, kcfg=kc)
            step_lg.append(lg[:, -1, : cfg.vocab_size].float())
            pos = pos + 1
        if path == kimpl:
            per_step_launches = (counter.launches - n0) / steps
        logs[path] = torch.stack(step_lg)  # (1 + steps, rows, V)
        del caches, lora
    got, want = logs[kimpl], logs[pimpl]
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"non-finite logits on the {kimpl} or {pimpl} path")
    per_step = (got - want).abs().amax(dim=(1, 2)).tolist()
    return per_step, want.abs().max().item(), per_step_launches


def profile_serve(torch, cfg, base, adapters, reqs, impl: str, out_dir: Path):
    """Serve 8 requests of 8 new tokens under ``torch.profiler`` (8 one-shot
    prefills, 7 decode steps) and report the device time by operator and
    the device's busy share of the wall time. The table goes to
    ``smoke_out/profile_<impl>.txt``."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, base, rows=8, smax=512, r_bucket=16, impl=impl, device=base["embed"]["w"].device)
    for i, (tree, r) in enumerate(adapters):
        eng.publish(f"ad{i}", tree, {"rank": r, "alpha": float(r)})
    short = [dataclasses.replace(r, max_new_tokens=8, arrival=0.0) for r in reqs[:8]]
    eng.serve(short[:1])  # warm-up outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(short)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ka = prof.key_averages()
    # device-side events only (kernels, copies): an operator's own row
    # repeats the time of the kernels it launched
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    (out_dir / f"profile_{impl}.txt").write_text(
        ka.table(sort_by="self_cuda_time_total", row_limit=40))
    emit({"phase": "profile", "impl": impl, "wall_ms": wall_ms, "device_ms": device_ms,
          "device_busy_share": device_ms / wall_ms,
          "top_device_ms": [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in top]})


def serve_phase(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused import fused_matmul
    from repro_torch.kernels.packed_matmul import packed_matmul
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import ServeEngine, poisson_requests
    from repro_torch.tree import tree_leaves

    cfg = get_config("qwen25-7b")
    t0 = time.perf_counter()
    base, _ = init_model(SEED, cfg, None, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(base))
    adapters = make_adapters(torch, cfg, 8)
    emit({"phase": "serve_setup", "model": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": n_params, "dtype": "bfloat16",
          "init_s": time.perf_counter() - t0,
          "weights_gb": torch.cuda.memory_allocated(dev) / 1e9})
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(64, 257)).astype(np.int32)
               for _ in range(16)]
    reqs = poisson_requests([f"ad{i % 8}" for i in range(16)], prompts, 2.0,
                            max_new_tokens=32, seed=SEED)
    counters = {"auto": packed_matmul, "fused": fused_matmul}
    launches, tokens = {}, {}
    for impl in ("auto", "fused"):
        eng = ServeEngine(cfg, base, rows=8, smax=512, r_bucket=16, slot_capacity=8,
                          impl=impl, device=dev)
        for i, (tree, r) in enumerate(adapters):
            eng.publish(f"ad{i}", tree, {"rank": r, "alpha": float(r)})
        packed_matmul.launches = 0
        fused_matmul.launches = 0
        stats = eng.serve(reqs)
        torch.cuda.synchronize()
        launches[impl] = {"packed_matmul": packed_matmul.launches,
                          "fused_matmul": fused_matmul.launches}
        if counters[impl].launches == 0:
            fail(f"impl={impl}: the {counters[impl].__name__} kernel was never launched")
        bad = [r for r in stats.results if r.error is not None or len(r.tokens) != 32]
        if bad or len(stats.results) != 16:
            fail(f"impl={impl}: requests failed: {[(r.request_id, r.error) for r in bad]}")
        toks = np.stack([r.tokens for r in stats.results])
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            fail(f"impl={impl}: token ids outside the vocabulary")
        tokens[impl] = toks
        lat = stats.latency_summaries()
        emit({"phase": "serve", "impl": impl, "requests": len(stats.results),
              "tokens": stats.tokens_emitted, "steps": stats.steps,
              "mean_occupancy": stats.mean_occupancy, "wall_s": stats.wall_seconds,
              "tokens_per_s": stats.tokens_per_s,
              "ttft_p50_s": lat["ttft"]["p50"], "ttft_p95_s": lat["ttft"]["p95"],
              "itl_p50_s": lat["itl"]["p50"], "itl_p95_s": lat["itl"]["p95"],
              "launches": launches[impl]})
        del eng
    emit({"phase": "serve_agreement",
          "greedy_token_match_share": float((tokens["auto"] == tokens["fused"]).mean())})
    with torch.no_grad():
        for kimpl, pimpl in (("auto", "plain"), ("fused", "fused_plain")):
            per_step, ref_max, per_dec = teacher_forced(
                torch, cfg, base, adapters, [r.prompt for r in reqs[:8]], 512, kimpl, pimpl,
                counters[kimpl])
            rel = max(per_step) / ref_max
            emit({"phase": "serve_logits", "impl": kimpl, "plain": pimpl,
                  "launches_per_decode_step": per_dec,
                  "max_abs_err_prefill": per_step[0], "max_abs_err_decode": per_step[1:],
                  "max_abs_logit": ref_max, "rel_err": rel, "tol": LOGIT_TOL})
            if not rel <= LOGIT_TOL:
                fail(f"impl={kimpl}: logits differ from {pimpl} by {rel} > {LOGIT_TOL}")
    out_dir = ROOT / "smoke_out"
    out_dir.mkdir(exist_ok=True)
    for impl in ("auto", "fused"):
        try:
            profile_serve(torch, cfg, base, adapters, reqs, impl, out_dir)
        except Exception as e:  # the profile is a reading, not a check: report and go on
            emit({"phase": "profile", "impl": impl, "error": repr(e)})
    return launches


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def summarize(rows, launches):
    """One entry per kernel for one decoder layer of a bf16 decode step
    (every projection's calls, weighted by their count per layer)."""
    mult = {shape: k for shape, k in PROJ}
    src = {"packed_matmul": ("src/repro_torch/kernels/csrc/packed_matmul.cu",
                             "src/repro/kernels/packed_matmul.py:89"),
           "fused_matmul": ("src/repro_torch/kernels/csrc/fused.cu",
                            "src/repro/kernels/fused.py:275")}
    out = []
    for name, (source, replaces) in src.items():
        sel = [r for r in rows if r["kernel"] == name and r["case"] == "decode"
               and r["dtype"] == "bfloat16"]
        tot = {k: sum(mult[(r["d_in"], r["d_out"])] * r[k] for r in sel)
               for k in ("ms", "plain_ms", "library_ms", "bytes", "flops")}
        b_ms, b_by, _, _ = bound(tot["bytes"], tot["flops"], "bfloat16")
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches["auto" if name == "packed_matmul" else "fused"][name],
                    "max_abs_err": max(r["max_abs_err"] for r in sel),
                    "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": tot["library_ms"]})
    return {"kernels": out}


def main() -> None:
    if len(sys.argv) > 1:
        fail(f"takes no arguments, got {sys.argv[1:]}")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch not found next to chip_smoke.py: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs an NVIDIA GPU")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi.stdout.strip().splitlines()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    try:
        libs = _build.build_all()
    except RuntimeError as e:
        fail(str(e))
    out_dir = ROOT / "smoke_out"
    out_dir.mkdir(exist_ok=True)
    spills = {}
    for lib in libs:  # ptxas: registers and spills of every kernel
        log = lib.with_suffix(".log")
        if log.exists():
            (out_dir / f"nvcc_{lib.stem}.log").write_text(log.read_text())
            spills[lib.stem] = [ln.strip() for ln in log.read_text().splitlines()
                                if "spill" in ln and not ln.strip().startswith("0 bytes")]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "libs": [p.name for p in libs],
          "spill_lines": spills})

    t0 = time.perf_counter()
    rows = kernel_phase(torch, dev)
    emit({"phase": "kernels_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    launches = serve_phase(torch, dev)
    emit({"phase": "serve_done", "seconds": time.perf_counter() - t0})
    summary = summarize(rows, launches)
    (out_dir / "chip_smoke.json").write_text(json.dumps({"records": RECORDS, **summary}, indent=1))
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
