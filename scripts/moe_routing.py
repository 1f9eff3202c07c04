#!/usr/bin/env python3
"""Where qwen3-moe-30b-a3b's or jamba-v0.1-52b's serve logits part between
the kernel and plain paths, on one CUDA card.

    python3 scripts/moe_routing.py          # qwen3-moe-30b-a3b
    python3 scripts/moe_routing.py jamba    # jamba-v0.1-52b, the smoke's cut

Builds the kernels and draws the model in bf16 from ``chip_smoke.py``'s
seed -- full qwen3-moe-30b-a3b (48 layers), or jamba at full width on the
jamba phase's first 8 layers (4 of them MoE) -- then runs the smoke's
serve check (``chip_smoke.teacher_forced``: 8 rows, each prompt prefilled alone, then 4
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

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
IMPLS = (("auto", "plain"), ("fused", "fused_plain"))


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]
    import chip_smoke as cs
    from repro_torch.models.layers import moe
    from ssd_share import setup_card, share_model

    which = sys.argv[1] if len(sys.argv) > 1 else cs.MOE
    if which not in (cs.MOE, "jamba"):
        cs.fail(f"the model is {cs.MOE} or jamba, got {which}")
    torch, dev, _ = setup_card(cs)
    cfg, base, _ = share_model(torch, cs, dev, which)
    _, (lo, hi), new_tokens, steps = cs.FAMILY_SERVE[cfg.name]
    adapters = cs.make_adapters(torch, cfg, 8)
    rng = np.random.RandomState(cs.SEED)
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(lo, hi)).astype(np.int32)
               for _ in range(8)]
    smax = (hi + max(new_tokens, steps) + 63) // 64 * 64
    router = moe._router
    # the router calls of one path: 8 prefills and ``steps`` decode steps,
    # each through every MoE layer
    n_moe = cfg.ffn_kinds().count("moe")
    per_path = (len(prompts) + steps) * n_moe
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
            n_pre = len(prompts) * n_moe
            by_layer = {
                what: [float(np.mean([agree(kern[j], plain[j]) for j in range(a, b)
                                      if j % n_moe == layer]))
                       for layer in range(n_moe)]
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
