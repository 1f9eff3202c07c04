"""Shared layer primitives: linear init, the norms (RMSNorm, LayerNorm) and
the MLPs ("swiglu", the gated "gelu", the classic two-matrix "gelu2")."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MLP_PROJECTIONS
from repro_torch.core.adapter import PackMeta, init_lora_pair
from repro_torch.core.packed_lora import lora_linear


def init_linear(gen, d_in: int, d_out: int, bias: bool, dtype=torch.float32, device=None) -> dict:
    """W ~ N(0, 1/d_in) laid out (d_in, d_out) as used by ``x @ W``; bias 0."""
    w = torch.randn((d_in, d_out), generator=gen, device=device, dtype=torch.float32)
    p = {"w": (w * d_in ** -0.5).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def init_norm(d: int, kind: str = "rmsnorm", dtype=torch.float32, device=None) -> dict:
    """Scale 1 (and, for a LayerNorm, bias 0): no random draw."""
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, kind: str = "rmsnorm", eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm computed in f32 with the reference's eps,
    cast back to ``x.dtype``."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def init_mlp(
    gen, d_model: int, d_ff: int, bias: bool,
    meta: Optional[PackMeta], targets, dtype=torch.float32, device=None, kind: str = "swiglu",
):
    """The MLP's weights, with packed LoRA pairs on the targets it has."""
    names = MLP_PROJECTIONS[kind]
    dims = {"gate": (d_model, d_ff), "up": (d_model, d_ff), "down": (d_ff, d_model)}
    params = {nm: init_linear(gen, *dims[nm], bias, dtype, device) for nm in names}
    lora = {}
    if meta is not None:
        for nm in names:
            if nm in targets:
                lora[nm] = init_lora_pair(gen, meta, *dims[nm], dtype, device)
    return params, lora


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(params, lora, scales, x, n_pack: int = 1, kcfg=None, kind: str = "swiglu"):
    """"gelu2": gelu(x @ up) @ down; "gelu" / "swiglu": act(x @ gate) *
    (x @ up) @ down with act GELU / SiLU; each a ``lora_linear``."""
    lo = lora or {}
    if kind == "gelu2":
        h = gelu(lora_linear(x, params["up"], lo.get("up"), scales, n_pack, kcfg=kcfg))
        return lora_linear(h, params["down"], lo.get("down"), scales, n_pack, kcfg=kcfg)
    g = lora_linear(x, params["gate"], lo.get("gate"), scales, n_pack, kcfg=kcfg)
    u = lora_linear(x, params["up"], lo.get("up"), scales, n_pack, kcfg=kcfg)
    act = gelu(g) if kind == "gelu" else F.silu(g)
    return lora_linear(act * u, params["down"], lo.get("down"), scales, n_pack, kcfg=kcfg)
