"""Shared layer primitives: linear init, RMSNorm, the SwiGLU MLP."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.adapter import PackMeta, init_lora_pair
from repro_torch.core.packed_lora import lora_linear


def init_linear(gen, d_in: int, d_out: int, bias: bool, dtype=torch.float32, device=None) -> dict:
    """W ~ N(0, 1/d_in) laid out (d_in, d_out) as used by ``x @ W``; bias 0."""
    w = torch.randn((d_in, d_out), generator=gen, device=device, dtype=torch.float32)
    p = {"w": (w * d_in ** -0.5).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def init_norm(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in f32, cast back to ``x.dtype``."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"].float()).to(x.dtype)


def init_mlp(
    gen, d_model: int, d_ff: int, bias: bool,
    meta: Optional[PackMeta], targets, dtype=torch.float32, device=None,
):
    """SwiGLU MLP: gate/up/down, with packed LoRA pairs on the targets."""
    params = {
        "gate": init_linear(gen, d_model, d_ff, bias, dtype, device),
        "up": init_linear(gen, d_model, d_ff, bias, dtype, device),
        "down": init_linear(gen, d_ff, d_model, bias, dtype, device),
    }
    lora = {}
    if meta is not None:
        for nm in ("gate", "up", "down"):
            if nm in targets:
                d_in, d_out = params[nm]["w"].shape
                lora[nm] = init_lora_pair(gen, meta, d_in, d_out, dtype, device)
    return params, lora


def apply_mlp(params, lora, scales, x, n_pack: int = 1, kcfg=None):
    """silu(x @ gate) * (x @ up) @ down, each a ``lora_linear``."""
    lo = lora or {}
    g = lora_linear(x, params["gate"], lo.get("gate"), scales, n_pack, kcfg=kcfg)
    u = lora_linear(x, params["up"], lo.get("up"), scales, n_pack, kcfg=kcfg)
    return lora_linear(F.silu(g) * u, params["down"], lo.get("down"), scales, n_pack, kcfg=kcfg)
