#!/usr/bin/env python3
"""Where qwen3-moe-30b-a3b's serve logits part between the kernel and plain
paths, on one CUDA card.

    python3 scripts/moe_routing.py

Builds the kernels and draws full qwen3-moe-30b-a3b (48 layers, bf16) from
``chip_smoke.py``'s seed, then runs the smoke's serve check
(``chip_smoke.teacher_forced``: 8 rows, each prompt prefilled alone, then 4
teacher-forced decode steps at width 8) under impl="auto" against the
plain path, twice for each impl in IMPLS:

- as the smoke does, recording every MoE layer's top-k choice on both
  paths: the share of the kernel path's choices that the plain path also
  made, per layer, in the prefills and in the decode steps;
- with the plain path replaying the kernel path's choices (its own router
  probabilities, gathered at the kernel path's experts and renormalized):
  what the two paths' logits differ by when no token takes another
  expert.

Prints the card's name and power limit, then one JSON line per run: the
max abs logit difference per step (prefill first) over max |logit|.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
IMPLS = (("auto", "plain"), ("fused", "fused_plain"))


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.layers import moe
    from repro_torch.models.model import init_model

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
    cfg = get_config(cs.MOE)
    base, _ = init_model(cs.SEED, cfg, None, dtype=torch.bfloat16, device=dev)
    _, (lo, hi), new_tokens, steps = cs.FAMILY_SERVE[cs.MOE]
    adapters = cs.make_adapters(torch, cfg, 8)
    rng = np.random.RandomState(cs.SEED)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(lo, hi)).astype(np.int32)
               for _ in range(8)]
    smax = (hi + max(new_tokens, steps) + 63) // 64 * 64
    router = moe._router
    # the router calls of one path: 8 prefills and ``steps`` decode steps,
    # each through every layer
    per_path = (len(prompts) + steps) * cfg.n_layers
    for kimpl, pimpl in IMPLS:
        for replay in (False, True):
            seen = []

            def rec(x, params, mcfg):
                gates, idx, aux = router(x, params, mcfg)
                i = len(seen)
                if replay and i >= per_path:  # the plain path: the kernel path's experts
                    idx = seen[i - per_path]
                    probs = torch.softmax(x.float() @ params["router"]["w"].float(), dim=-1)
                    g = probs.gather(1, idx)
                    gates = g / (g.sum(-1, keepdim=True) + 1e-9)
                seen.append(idx)
                return gates, idx, aux

            moe._router = rec
            try:
                with torch.no_grad():
                    per_step, ref_max, _ = cs.teacher_forced(
                        torch, cfg, base, adapters, prompts, smax, kimpl, pimpl,
                        {"auto": "packed_matmul", "fused": "fused_matmul"}[kimpl], steps)
            finally:
                moe._router = router
            if len(seen) != 2 * per_path:
                cs.fail(f"{len(seen)} router calls, expected {2 * per_path}")

            def agree(a, b):
                return (a[:, :, None] == b[:, None, :]).any(-1).float().mean().item()

            kern, plain = seen[:per_path], seen[per_path:]
            n_pre = len(prompts) * cfg.n_layers
            by_layer = {
                what: [float(np.mean([agree(kern[j], plain[j]) for j in range(a, b)
                                      if j % cfg.n_layers == layer]))
                       for layer in range(cfg.n_layers)]
                for what, (a, b) in (("prefill", (0, n_pre)), ("decode", (n_pre, per_path)))}
            cs.emit({"phase": "moe_routing", "model": cfg.name, "impl": kimpl, "plain": pimpl,
                     "plain_replays_kernel_routes": replay,
                     "prompt_tokens": [len(p) for p in prompts], "decode_steps": steps,
                     "rel_err_by_step": [e / ref_max for e in per_step],
                     "rel_err": max(per_step) / ref_max, "max_abs_logit": ref_max,
                     "tol": cs.LOGIT_TOL,
                     "topk_agreement_by_layer": by_layer,
                     "topk_agreement_min": {k: min(v) for k, v in by_layer.items()}})


if __name__ == "__main__":
    main()
