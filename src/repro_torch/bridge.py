"""Carry parameters between the JAX package and the port, through numpy.

Both packages lay parameters out alike: nested dicts with weights
``(d_in, d_out)`` as used by ``x @ W``; the base tree holds ``embed``,
``final_norm``, ``lm_head`` (none when the embeddings are tied) and
``decoder.blocks.l0.*`` stacked on axis 0 (the layer); a LoRA pack tree
has the pack on axis 1 under ``"blocks"`` and on axis 0 elsewhere. So the
bridge changes no layout: it converts leaves. An MoE layer's ``"moe"``
subtree crosses under ``"blocks"`` like any other, its leaves with the
block on axis 0.
JAX → numpy → :func:`to_torch` → :func:`to_numpy` is bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map

# subtrees that stay f32 whatever dtype the rest of a tree is cast to: an
# MoE router, whose top-k choice reads it (the reference keeps it f32)
F32_SUBTREES = frozenset({"router"})


def _leaf_to_torch(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # own copy: never aliases the caller's array
    if dtype is not None and t.is_floating_point():
        return t.to(device=device, dtype=dtype)
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only for bf16 leaves; ships with JAX

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree, device, dtype=None):
    """A numpy (or JAX) parameter tree as torch tensors on ``device``, its
    floating-point leaves optionally cast to ``dtype`` (those under an
    F32_SUBTREES key to f32); same structure and layout."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device, torch.float32 if k in F32_SUBTREES and dtype is not None
                            else dtype) for k, v in tree.items()}
    return tree_map(lambda a: _leaf_to_torch(a, device, dtype), tree)


def to_numpy(tree):
    """A torch parameter tree as numpy arrays; same structure and layout."""
    return tree_map(_leaf_to_numpy, tree)
