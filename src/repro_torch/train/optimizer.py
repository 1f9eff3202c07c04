"""AdamW over packed adapter parameters with per-adapter learning rates (the
port of ``repro/train/optimizer.py``).

Only LoRA parameters carry optimizer state: the base is frozen (no base
grads, no base moments). The pack dim N is axis 0 of unstacked leaves and
axis 1 of layer-stacked ("blocks") leaves; adapter n is stepped with its own
learning rate. The update is functional by default, as in the reference: it
returns new trees and leaves its inputs as they were; ``in_place=True``
updates the state where it lies instead.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


def init_opt_state(lora_params, n_pack: int = 0) -> Dict[str, Any]:
    """``n_pack > 0`` makes ``step`` a per-adapter (N,) vector instead of a
    scalar, so adapters resumed at different steps each keep their own Adam
    bias correction."""
    dev = tree_leaves(lora_params)[0].device
    return {
        "m": tree_map(torch.zeros_like, lora_params),
        "v": tree_map(torch.zeros_like, lora_params),
        "step": torch.zeros((n_pack,) if n_pack else (), dtype=torch.int32, device=dev),
    }


def _lr_shape(leaf: torch.Tensor, n_pack: int, in_blocks: bool):
    """Broadcast shape of an (N,) vector along this leaf's pack axis: 1
    under a "blocks" stack, else 0."""
    ax = 1 if in_blocks else 0
    if leaf.shape[ax] != n_pack:
        raise ValueError(f"leaf {tuple(leaf.shape)}: pack axis {ax} is not {n_pack}")
    shape = [1] * leaf.dim()
    shape[ax] = n_pack
    return shape


@torch.no_grad()
def adamw_update(
    grads,
    opt_state,
    params,
    lr_vector: torch.Tensor,  # (N,)
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    step_budget: Optional[torch.Tensor] = None,  # (N,) max steps per adapter
    in_place: bool = False,
) -> Tuple[Any, Dict[str, Any]]:
    """One AdamW step; returns (new params, new state). ``step_budget``
    freezes adapter n -- params, moments and step count -- once it has
    taken its budgeted steps, while its packmates go on. ``in_place``
    writes each leaf's new values into ``params`` and ``opt_state`` as soon
    as they are computed, and returns those: the same arithmetic, so the
    same bits, without a second copy of the state (what a captured step
    wants)."""
    active = None
    if step_budget is not None:
        active = (opt_state["step"] < step_budget).float()  # (N,)
        step = opt_state["step"] + active.to(opt_state["step"].dtype)
    else:
        step = opt_state["step"] + 1
    n_pack = lr_vector.shape[0]
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def leaf(g, m, v, p, in_blocks):
        shape = _lr_shape(p, n_pack, in_blocks)
        c1l = c1.reshape(shape) if c1.dim() else c1
        c2l = c2.reshape(shape) if c2.dim() else c2
        if active is not None:
            g = g * active.reshape(shape).to(g.dtype)
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * (g * g)
        if active is not None:
            act = active.reshape(shape)
            m_new = act * m_new + (1 - act) * m
            v_new = act * v_new + (1 - act) * v
        mh = m_new / torch.clamp(c1l, min=1e-12)
        vh = v_new / torch.clamp(c2l, min=1e-12)
        lr = lr_vector.reshape(shape).to(p.dtype)
        upd = mh / (torch.sqrt(vh) + eps)
        if weight_decay:
            upd = upd + weight_decay * p
        if active is not None:
            upd = upd * active.reshape(shape).to(p.dtype)
        p_new = p - lr * upd
        if in_place:
            for dst, src in ((p, p_new), (m, m_new), (v, v_new)):
                dst.copy_(src)
            return p, m, v
        return p_new, m_new, v_new

    def walk(g, m, v, p, in_blocks):
        if isinstance(p, dict):
            outs = {k: walk(g[k], m[k], v[k], p[k], in_blocks or k == "blocks") for k in p}
            return tuple({k: o[i] for k, o in outs.items()} for i in range(3))
        return leaf(g, m, v, p, in_blocks)

    new_p, new_m, new_v = walk(grads, opt_state["m"], opt_state["v"], params, False)
    if in_place:
        opt_state["step"].copy_(step)
        return params, opt_state
    return new_p, {"m": new_m, "v": new_v, "step": step}
