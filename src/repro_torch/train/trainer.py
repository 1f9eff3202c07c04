"""Packed-LoRA training step and loop (the port of ``repro/train/trainer.py``).

A step runs the forward with packed-LoRA deltas, the chunked CE with
per-adapter reduction, the gradients with respect to the LoRA leaves only
(``requires_grad`` on them, never on the base: no base grads, no base
moments), and AdamW with the per-adapter learning-rate vector. The loss
is the CE total plus ``aux_weight`` times the MoE layers' load-balance aux
loss (zero without an MoE layer), as in the reference; the per-adapter
losses are the CE alone.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import CROSS_UNREAD, ModelConfig
from repro_torch.core.adapter import PackMeta
from repro_torch.kernels.ops import KernelConfig
from repro_torch.models.model import forward, unembed_w
from repro_torch.train.losses import chunked_cross_entropy
from repro_torch.train.optimizer import adamw_update, init_opt_state
from repro_torch.tree import tree_map


def packed_loss_fn(
    lora, base, batch, cfg: ModelConfig, n_pack: int, scales, *,
    chunk_q: int = 512, vocab_chunk: int = 512, aux_weight: float = 0.01,
    kcfg: Optional[KernelConfig] = None,
):
    """(total, per-adapter (N,)) loss of a pack, ``scales`` (alpha/r) a
    runtime tensor; ``kcfg`` the kernel policy. total = the CE total +
    ``aux_weight`` x the MoE aux loss (one scalar over the whole pack, as
    in the reference: it couples the pack's adapters); per-adapter: the CE
    alone."""
    h, _, aux = forward(base, lora, scales, batch, cfg, n_pack=n_pack, chunk_q=chunk_q,
                        kcfg=kcfg)
    per_adapter, total = chunked_cross_entropy(
        h, unembed_w(base, cfg), batch["labels"], n_pack, chunk=vocab_chunk, vocab=cfg.vocab_size,
    )
    return total + aux_weight * aux, per_adapter


def loss_fn(
    lora, base, batch, cfg: ModelConfig, meta: PackMeta, *,
    chunk_q: int = 512, vocab_chunk: int = 512, aux_weight: float = 0.01,
    kcfg: Optional[KernelConfig] = None,
):
    return packed_loss_fn(
        lora, base, batch, cfg, meta.n, meta.scales(batch["tokens"].device),
        chunk_q=chunk_q, vocab_chunk=vocab_chunk, aux_weight=aux_weight,
        kcfg=kcfg if kcfg is not None else meta.kernel_config(),
    )


def packed_value_and_grad(
    lora, base, batch, cfg: ModelConfig, n_pack: int, scales, *,
    chunk_q: int = 512, vocab_chunk: int = 512, aux_weight: float = 0.01,
    kcfg: Optional[KernelConfig] = None,
):
    """(total, per-adapter loss, grads): the gradient of the total with
    respect to every LoRA leaf, in the LoRA tree's layout. A leaf that no
    loss reads (``unread_lora``: an encoder-decoder's cross-attention k/v
    adapters) gets a zero gradient, as ``jax.grad`` gives it in the
    reference; any other leaf without a gradient raises: the graph from
    that leaf to the loss was cut."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), lora)
    total, per_adapter = packed_loss_fn(
        leaves, base, batch, cfg, n_pack, scales,
        chunk_q=chunk_q, vocab_chunk=vocab_chunk, aux_weight=aux_weight, kcfg=kcfg,
    )
    total.backward()

    def grad(path, t):
        if t.grad is not None:
            return t.grad
        if unread_lora(path):
            return torch.zeros_like(t)
        raise RuntimeError(f"the LoRA leaf {'/'.join(path)} received no gradient: its path "
                           "to the loss is cut")

    return total.detach(), per_adapter.detach(), _map_with_path(grad, leaves)


def unread_lora(path) -> bool:
    """Whether the LoRA leaf at ``path`` (the tree's keys) is one that no
    loss reads: an adapter of the cross-attention group on a projection of
    CROSS_UNREAD (whisper's cross "v"; the reference builds it and never
    reads it, ROADMAP C)."""
    return any(k == "cross" and nm in CROSS_UNREAD for k, nm in zip(path, path[1:]))


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    return fn(path, tree)


def make_packed_step(
    cfg: ModelConfig,
    n_pack: int,
    *,
    chunk_q: int = 512,
    vocab_chunk: int = 512,
    weight_decay: float = 0.0,
    aux_weight: float = 0.01,
    impl: Optional[str] = None,
    remat: Optional[str] = None,
    ranks: Optional[tuple] = None,
    base_dtype: Optional[str] = None,
    in_place: bool = False,
    blocks: Optional[tuple] = None,
):
    """A packed train step whose per-adapter vectors -- ``scales``
    (alpha/r), ``lr_vec`` and ``budgets`` (per-adapter step caps, or None)
    -- are runtime tensors, so one step serves every pack of the same shape.

    ``aux_weight`` weighs the MoE aux loss in the total (the reference's
    0.01); ``impl``/``remat`` select the kernel backend and backward xA policy
    (kernels/ops.py); ``ranks`` is the pack's per-adapter rank tuple, which
    runs a mixed-rank pack as ragged same-rank segments (a homogeneous tuple
    normalizes to None: it computes the same); ``base_dtype`` names a
    quantized base ("int8"/"nf4"), whose "w" slots then hold
    ``{"codes", "scales"}`` dicts; ``blocks`` is the fused kernel's K-split
    override ``(k_splits,)`` (the autotuner's choice; None: each call's plan).

    ``train_step(base, lora, opt_state, batch, scales, lr_vec, budgets)``
    returns (new lora, new opt_state, {"loss", "per_adapter_loss"});
    ``in_place`` makes AdamW update ``lora`` and ``opt_state`` where they
    lie and return them (the same bits; the executor's captured step)."""
    ranks = tuple(ranks) if ranks and len(set(ranks)) > 1 else None
    kcfg = KernelConfig(impl=impl, remat=remat, ranks=ranks, base_dtype=base_dtype,
                        blocks=tuple(blocks) if blocks is not None else None)

    def train_step(base, lora, opt_state, batch, scales, lr_vec, budgets):
        total, per_adapter, grads = packed_value_and_grad(
            lora, base, batch, cfg, n_pack, scales,
            chunk_q=chunk_q, vocab_chunk=vocab_chunk, aux_weight=aux_weight, kcfg=kcfg,
        )
        lora_new, opt_state = adamw_update(
            grads, opt_state, lora, lr_vec, weight_decay=weight_decay, step_budget=budgets,
            in_place=in_place,
        )
        return lora_new, opt_state, {"loss": total, "per_adapter_loss": per_adapter}

    return train_step


def make_train_step(
    cfg: ModelConfig,
    meta: PackMeta,
    *,
    chunk_q: int = 512,
    vocab_chunk: int = 512,
    weight_decay: float = 0.0,
    step_budgets=None,  # (N,) per-adapter max step counts
    impl: Optional[str] = None,
    remat: Optional[str] = None,
    base_dtype: Optional[str] = None,
):
    """The step for one pack, its hyperparameter vectors closed over:
    ``train_step(base, lora, opt_state, batch)``. The vectors (scales,
    learning rates, step budgets) are made on the first step on a device and
    reused, so a step copies nothing from the host."""
    step = make_packed_step(
        cfg, meta.n, chunk_q=chunk_q, vocab_chunk=vocab_chunk, weight_decay=weight_decay,
        impl=impl, remat=remat, ranks=meta.ranks, base_dtype=base_dtype,
    )
    vectors = {}  # device -> (scales, lr_vec, budgets)

    def train_step(base, lora, opt_state, batch):
        dev = batch["tokens"].device
        vec = vectors.get(dev)
        if vec is None:
            budgets = (torch.tensor(step_budgets, dtype=torch.int32).to(dev, non_blocking=True)
                       if step_budgets is not None else None)
            vec = vectors[dev] = (meta.scales(dev), meta.lr_vector(dev), budgets)
        return step(base, lora, opt_state, batch, *vec)

    return train_step


def train_loop(
    base, lora, cfg: ModelConfig, meta: PackMeta, data_iter, n_steps: int, *,
    chunk_q: int = 512, vocab_chunk: int = 512, log_every: int = 0,
) -> Dict[str, Any]:
    """Run n_steps; returns the final state and the per-adapter loss history."""
    step_fn = make_train_step(cfg, meta, chunk_q=chunk_q, vocab_chunk=vocab_chunk)
    opt_state = init_opt_state(lora)
    history = []
    for i in range(n_steps):
        lora, opt_state, m = step_fn(base, lora, opt_state, next(data_iter))
        history.append(m["per_adapter_loss"].cpu().numpy())
        if log_every and i % log_every == 0:
            print(f"step {i}: loss={float(m['loss']):.4f}")
    return {"lora": lora, "opt_state": opt_state, "history": history}
