"""The MoE parts' share of qwen3-moe-30b-a3b's or jamba-v0.1-52b's device
time on one CUDA card.

    python3 scripts/moe_share.py          # qwen3-moe-30b-a3b
    python3 scripts/moe_share.py jamba    # jamba-v0.1-52b, the smoke's cut

Builds the kernels and draws the model in bf16 from ``chip_smoke.py``'s
seed -- full qwen3-moe-30b-a3b (48 layers, 61.06 GB), or jamba at full
width on the jamba phase's first 8 layers (4 MoE FFNs of 16 experts, 4
dense ones) -- then profiles with ``torch.profiler``: one
``make_packed_step`` step (impl="auto") of the smoke's train pack (8 rows
of 512 tokens), and a ``ServeEngine`` drain of 4 of the smoke's requests
for the model (8 new tokens each), each after a warm-up (``ssd_share.py``'s
``profile_train_and_serve``). The MoE layer's plain-PyTorch parts
(``models/layers/moe.py``: the router, the dispatch plan, the dispatch
gather, the experts' batched products, the combine gather) run inside
``moe:<name>`` ranges; their forward and backward device time and their
share of all device time are printed as one JSON line per profile, after
the card's name and power limit. The device time by kernel name goes to
``smoke_out/profile_{qwen3_moe,jamba_moe}_{train,serve}.txt``.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the MoE module's parts timed, each under a ``moe:<name>`` range
MOE_PARTS = ("_router", "dispatch_plan", "_Dispatch", "_expert_ffn", "_Combine")


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]
    import chip_smoke as cs
    from repro_torch.models.layers import moe
    from ssd_share import parts_profile, profile_train_and_serve, setup_card, share_model

    which = sys.argv[1] if len(sys.argv) > 1 else cs.MOE
    if which not in (cs.MOE, "jamba"):
        cs.fail(f"the model is {cs.MOE} or jamba, got {which}")
    torch, dev, out = setup_card(cs)
    cfg, base, seq = share_model(torch, cs, dev, which)
    tag = "jamba_moe" if which == "jamba" else "qwen3_moe"
    profile_train_and_serve(torch, cs, dev, cfg, base, seq, lambda what, fn: parts_profile(
        torch, cs, cfg, what, fn, out, moe, MOE_PARTS, "moe", tag))


if __name__ == "__main__":
    main()
