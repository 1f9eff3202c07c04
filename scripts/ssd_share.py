#!/usr/bin/env python3
"""The SSD's share of mamba2-370m's device time on one CUDA card.

    python3 scripts/ssd_share.py

Builds the kernels and draws full mamba2-370m (48 layers, bf16) from
``chip_smoke.py``'s seed, then profiles with ``torch.profiler``: one
``make_packed_step`` step (impl="auto") of the smoke's train pack at its
sequence length (8 rows of 1,024 tokens), and a ``ServeEngine`` drain of 4
of the smoke's mamba2 requests (prompts of 200-600 tokens, 8 new tokens
each), each after a warm-up. The SSD's plain-PyTorch parts
(``models/layers/ssm.py``: the chunked scan, the causal conv, the decode
step's conv and recurrence, the gated RMSNorm) run inside ``ssd:<name>``
ranges; their forward and backward device time and their share of all
device time are printed as one JSON line per profile, after the card's
name and power limit. The device time by kernel name goes to
``smoke_out/profile_mamba2_{train,serve}.txt``.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# the SSD module's functions timed, each under a ``ssd:<name>`` range
# (``apply_norm`` as the SSD module calls it: the gated norm)
SSD_PARTS = ("_ssd_scan", "_causal_conv", "_ssd_step", "apply_norm")


def ssd_profile(torch, cs, cfg, what: str, fn, out_dir: Path) -> dict:
    """The SSD's parts (SSD_PARTS of ``models/layers/ssm.py``) in ``fn()``:
    ``parts_profile`` under the tag "ssd", the kernel table in
    ``smoke_out/profile_mamba2_<what>.txt``."""
    from repro_torch.models.layers import ssm

    return parts_profile(torch, cs, cfg, what, fn, out_dir, ssm, SSD_PARTS, "ssd", "mamba2")


def parts_profile(torch, cs, cfg, what: str, fn, out_dir: Path, module, parts, tag: str,
                  model_tag: str) -> dict:
    """``fn()`` under ``torch.profiler`` with each of ``module``'s ``parts``
    run inside a ``<tag>:<name>`` range (a function, or an autograd
    Function's ``apply``): their device time, and share of all device
    time, in the forward (the kernels launched inside the ranges, a
    checkpointed block's recompute included) and in the backward (the
    autograd nodes of the ops launched there, matched by thread and
    sequence number, less the recompute of a checkpointed block that a
    node's first read of its saved tensors runs: each decoder layer runs
    inside a ``layer`` range, and the ranges under a node are its
    recompute). Read from the profile's events, without
    ``key_averages`` (minutes of host time at this many events); the
    device time by kernel name goes to
    ``smoke_out/profile_<model_tag>_<what>.txt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import transformer

    saved = {nm: getattr(module, nm) for nm in parts}
    apply_layer = transformer.apply_layer

    def ranged(nm, f):
        if isinstance(f, type):  # an autograd Function: range its apply
            return type(f.__name__, (), {"apply": staticmethod(ranged(nm, f.apply))})

        def call(*a, **kw):
            with record_function(f"{tag}:{nm}"):
                return f(*a, **kw)
        return call

    torch.cuda.synchronize()
    for nm, f in saved.items():
        setattr(module, nm, ranged(nm, f))
    transformer.apply_layer = ranged("layer", apply_layer)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for nm, f in saved.items():
            setattr(module, nm, f)
        transformer.apply_layer = apply_layer
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            ms, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (ms + e.self_device_time_total / 1e3, n + 1)
    device_ms = sum(ms for ms, _ in by_kernel.values())
    if device_ms <= 0:
        cs.fail(f"the profiler saw no device time in {cfg.name}'s {what}")
    top = sorted(by_kernel.items(), key=lambda kv: kv[1][0], reverse=True)
    (out_dir / f"profile_{model_tag}_{what}.txt").write_text(
        "".join(f"{ms:12.3f} ms {n:8d}  {name}\n" for name, (ms, n) in top))
    res = {"wall_ms": wall_ms, "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
           "top_device_ms": [[name[:60], ms, n] for name, (ms, n) in top[:12]]}
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    pre = f"{tag}:"

    def part_of(e):
        while e is not None:
            if e.name.startswith(pre) and e.name != f"{tag}:layer":
                return e.name[len(pre):]
            e = e.cpu_parent
        return None

    fwd, bwd, nodes = dict.fromkeys(parts, 0.0), dict.fromkeys(parts, 0.0), 0
    seqs, node_part, recompute_ms = {}, {}, 0.0
    for e in events:
        if e.name == f"{tag}:layer":
            continue
        if e.name.startswith(pre):
            fwd[e.name[len(pre):]] += e.device_time_total / 1e3
        elif e.sequence_nr >= 0 and "Backward" not in e.name:
            part = part_of(e.cpu_parent)
            if part is not None:
                seqs[e.thread, e.sequence_nr] = part
    # an autograd node: "<Op>Backward<k>" (an autograd Function's:
    # "<Name>Backward"), with its forward's sequence number
    for e in events:
        if (e.name.endswith(("Backward", *(f"Backward{k}" for k in range(4))))
                and not e.name.startswith("autograd::")):
            part = seqs.get((e.fwd_thread, e.sequence_nr))
            if part is None and e.name[:-len("Backward")] in parts:  # an autograd Function's
                part = e.name[:-len("Backward")]
            if part is not None:
                bwd[part] += e.device_time_total / 1e3
                node_part[e.id] = part
                nodes += 1
    for e in events:  # a layer's recompute inside a node: not the node's own time
        if e.name == f"{tag}:layer":
            up = e.cpu_parent
            while up is not None and up.id not in node_part:
                up = up.cpu_parent
            if up is not None:
                bwd[node_part[up.id]] -= e.device_time_total / 1e3
                recompute_ms += e.device_time_total / 1e3
    part_ms = sum(fwd.values()) + sum(bwd.values())
    row = {"phase": f"{tag}_profile", "model": cfg.name, "what": what, **res,
           f"{tag}_forward_device_ms": fwd, f"{tag}_backward_device_ms": bwd,
           f"{tag}_backward_nodes_matched": nodes,
           f"{tag}_recompute_in_nodes_device_ms": recompute_ms, f"{tag}_device_ms": part_ms,
           f"{tag}_device_share": part_ms / res["device_ms"]}
    cs.emit(row)
    return row


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import ServeEngine, poisson_requests
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import make_packed_step

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else smi.stderr, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.zeros(1, device=dev)
    _build.build_all()
    out = ROOT / "smoke_out"
    out.mkdir(exist_ok=True)
    cfg = get_config(cs.MAMBA2)
    base, _ = init_model(cs.SEED, cfg, None, dtype=torch.bfloat16, device=dev)
    _, meta, lora, batches = cs.train_setup(torch, dev, cfg, cs.FAMILY_TRAIN_SEQ[cs.MAMBA2], 2)
    step = make_packed_step(cfg, meta.n, impl="auto", ranks=meta.ranks)
    opt = init_opt_state(lora)
    scales, lr_vec = meta.scales(dev), meta.lr_vector(dev)
    step(base, lora, opt, batches[0], scales, lr_vec, None)  # warm-up
    ssd_profile(torch, cs, cfg, "train",
                lambda: step(base, lora, opt, batches[1], scales, lr_vec, None), out)
    del step, lora, opt, batches
    torch.cuda.empty_cache()
    _, (lo, hi), _, _ = cs.FAMILY_SERVE[cs.MAMBA2]
    rng = np.random.RandomState(cs.SEED)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(lo, hi)).astype(np.int32)
               for _ in range(4)]
    reqs = [dataclasses.replace(r, max_new_tokens=8, arrival=0.0) for r in poisson_requests(
        [f"ad{i}" for i in range(4)], prompts, 2.0, max_new_tokens=8, seed=cs.SEED)]
    eng = ServeEngine(cfg, base, rows=8, smax=(hi + 8 + 63) // 64 * 64, r_bucket=16,
                      impl="auto", device=dev)
    for i, (tree, r) in enumerate(cs.make_adapters(torch, cfg, 4)):
        eng.publish(f"ad{i}", tree, {"rank": r, "alpha": float(r)})
    eng.serve(reqs[:1])  # warm-up
    ssd_profile(torch, cs, cfg, "serve", lambda: eng.serve(reqs), out)


if __name__ == "__main__":
    main()
