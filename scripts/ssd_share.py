#!/usr/bin/env python3
"""The SSD's share of mamba2-370m's or jamba-v0.1-52b's device time on one
CUDA card.

    python3 scripts/ssd_share.py          # mamba2-370m
    python3 scripts/ssd_share.py jamba    # jamba-v0.1-52b, the smoke's cut

Builds the kernels and draws the model in bf16 from ``chip_smoke.py``'s
seed -- full mamba2-370m (48 layers), or jamba at full width on the jamba
phase's first 8 layers (one whole period: 7 SSD layers and 1 attention
layer, 4 MoE FFNs and 4 dense ones) -- then profiles with
``torch.profiler``: one ``make_packed_step`` step (impl="auto") of the
smoke's train pack at the model's sequence length there (8 rows of 1,024
tokens; jamba's 512), and a ``ServeEngine`` drain of 4 of the smoke's
requests for the model (prompts of 200-600 tokens, 8 new tokens each),
each after a warm-up. The SSD's plain-PyTorch parts
(``models/layers/ssm.py``: the chunked scan, the causal conv, the decode
step's conv and recurrence, the gated RMSNorm) run inside ``ssd:<name>``
ranges; their forward and backward device time and their share of all
device time are printed as one JSON line per profile, after the card's
name and power limit. The device time by kernel name goes to
``smoke_out/profile_{mamba2,jamba_ssd}_{train,serve}.txt``.
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


def share_model(torch, cs, dev, which: str):
    """The model a share script profiles and its train pack's sequence
    length: ``which`` "jamba" -> jamba-v0.1-52b cut to the jamba phase's
    JAMBA_LAYERS, a bf16 base drawn to that depth; ``arch`` -> the full
    model. Returns (cfg, base, seq)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_model

    if which == "jamba":
        cfg, seq = get_config(cs.JAMBA).replace(n_layers=cs.JAMBA_LAYERS), cs.JAMBA_TRAIN_SEQ
    else:
        cfg = get_config(which)
        seq = cs.FAMILY_TRAIN_SEQ.get(which, cs.TRAIN_SEQ)
    base, _ = init_model(cs.SEED, cfg, None, dtype=torch.bfloat16, device=dev)
    return cfg, base, seq


def profile_train_and_serve(torch, cs, dev, cfg, base, seq: int, profile) -> None:
    """``profile(what, fn)`` of one ``make_packed_step`` step (impl="auto")
    of the smoke's train pack at ``seq`` tokens, then of a ``ServeEngine``
    drain of 4 of the smoke's requests for the model (8 new tokens each),
    each after a warm-up."""
    from repro_torch.serve.engine import ServeEngine, poisson_requests
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import make_packed_step

    _, meta, lora, batches = cs.train_setup(torch, dev, cfg, seq, 2)
    step = make_packed_step(cfg, meta.n, impl="auto", ranks=meta.ranks)
    opt = init_opt_state(lora)
    scales, lr_vec = meta.scales(dev), meta.lr_vector(dev)
    step(base, lora, opt, batches[0], scales, lr_vec, None)  # warm-up
    profile("train", lambda: step(base, lora, opt, batches[1], scales, lr_vec, None))
    del step, lora, opt, batches
    torch.cuda.empty_cache()
    _, (lo, hi), _, _ = cs.FAMILY_SERVE[cfg.name]
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
    profile("serve", lambda: eng.serve(reqs))


def setup_card(cs):
    """torch on cuda:0 with TF32 off and the kernels built; prints the
    card's name and power limit. Returns (torch, dev, smoke_out)."""
    import torch

    from repro_torch.kernels import _build

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
    return torch, dev, out


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
    import chip_smoke as cs
    from repro_torch.models.layers import ssm

    which = sys.argv[1] if len(sys.argv) > 1 else cs.MAMBA2
    if which not in (cs.MAMBA2, "jamba"):
        cs.fail(f"the model is {cs.MAMBA2} or jamba, got {which}")
    torch, dev, out = setup_card(cs)
    cfg, base, seq = share_model(torch, cs, dev, which)
    tag = "jamba_ssd" if which == "jamba" else "mamba2"
    profile_train_and_serve(torch, cs, dev, cfg, base, seq, lambda what, fn: parts_profile(
        torch, cs, cfg, what, fn, out, ssm, SSD_PARTS, "ssd", tag))


if __name__ == "__main__":
    main()
