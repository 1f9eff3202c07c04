#!/usr/bin/env python3
"""The MoE parts' share of qwen3-moe-30b-a3b's device time on one CUDA card.

    python3 scripts/moe_share.py

Builds the kernels and draws full qwen3-moe-30b-a3b (48 layers, bf16,
61.06 GB) from ``chip_smoke.py``'s seed, then profiles with
``torch.profiler``: one ``make_packed_step`` step (impl="auto") of the
smoke's train pack (8 rows of 512 tokens), and a ``ServeEngine`` drain of
4 of the smoke's qwen3-moe requests (prompts of 64-600 tokens, 8 new
tokens each), each after a warm-up. The MoE layer's plain-PyTorch parts
(``models/layers/moe.py``: the router, the dispatch plan, the dispatch
gather, the experts' batched products, the combine gather) run inside
``moe:<name>`` ranges; their forward and backward device time and their
share of all device time are printed as one JSON line per profile, after
the card's name and power limit. The device time by kernel name goes to
``smoke_out/profile_qwen3_moe_{train,serve}.txt``.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# the MoE module's parts timed, each under a ``moe:<name>`` range
MOE_PARTS = ("_router", "dispatch_plan", "_Dispatch", "_expert_ffn", "_Combine")


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.layers import moe
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import ServeEngine, poisson_requests
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import make_packed_step
    from ssd_share import parts_profile

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
    cfg = get_config(cs.MOE)
    base, _ = init_model(cs.SEED, cfg, None, dtype=torch.bfloat16, device=dev)

    def profile(what, fn):
        return parts_profile(torch, cs, cfg, what, fn, out, moe, MOE_PARTS, "moe", "qwen3_moe")

    _, meta, lora, batches = cs.train_setup(torch, dev, cfg, cs.TRAIN_SEQ, 2)
    step = make_packed_step(cfg, meta.n, impl="auto", ranks=meta.ranks)
    opt = init_opt_state(lora)
    scales, lr_vec = meta.scales(dev), meta.lr_vector(dev)
    step(base, lora, opt, batches[0], scales, lr_vec, None)  # warm-up
    profile("train", lambda: step(base, lora, opt, batches[1], scales, lr_vec, None))
    del step, lora, opt, batches
    torch.cuda.empty_cache()
    _, (lo, hi), _, _ = cs.FAMILY_SERVE[cs.MOE]
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


if __name__ == "__main__":
    main()
