"""Losses: vocab-chunked cross-entropy with per-adapter reduction (the port
of ``repro/train/losses.py``).

The CE never keeps the full (NB, S, V) f32 logits of a long sequence: the
sequence is cut into chunks, and each chunk's logits are computed, reduced
and dropped, then recomputed in the backward (each chunk is checkpointed).
Per-adapter reduction: total = sum_n mean-CE_n, so each adapter's gradient
is exactly what it would be when fine-tuned alone.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

IGNORE = -100


def _chunk_ce(h, w, labels, mask, vocab=None):
    """h: (NB, c, d); w: (d, Vpad); labels: (NB, c). Returns (nll_sum, cnt)."""
    lg = (h @ w.to(h.dtype)).float()  # (NB, c, Vpad)
    if vocab is not None and vocab < lg.shape[-1]:
        lg = lg.masked_fill(torch.arange(lg.shape[-1], device=lg.device) >= vocab, -1e30)
    lse = torch.logsumexp(lg, dim=-1)
    safe = labels.clamp(min=0).long()  # gather takes int64 indices
    tgt = torch.gather(lg, -1, safe[..., None])[..., 0]
    nll = (lse - tgt) * mask
    return nll.sum(-1), mask.sum(-1)


def chunked_cross_entropy(
    hidden: torch.Tensor,
    unembed: torch.Tensor,
    labels: torch.Tensor,
    n_pack: int,
    *,
    chunk: int = 512,
    vocab: int = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (per_adapter_mean (N,), total = sum of per-adapter means).

    hidden: (NB, S, d); labels: (NB, S) with IGNORE at masked positions.
    ``vocab``: the true vocabulary size when ``unembed`` is padded (the
    padded logits are masked to -1e30)."""
    nb, s, _ = hidden.shape
    mask = (labels != IGNORE).float()
    if s <= chunk:
        nll, cnt = _chunk_ce(hidden, unembed, labels, mask, vocab)
    else:
        pad = (-s) % chunk
        if pad:
            hidden = F.pad(hidden, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad), value=IGNORE)
            mask = F.pad(mask, (0, pad))
        nll = torch.zeros((nb,), dtype=torch.float32, device=hidden.device)
        cnt = torch.zeros((nb,), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, hidden.shape[1], chunk):
            sl = slice(c0, c0 + chunk)
            a, b = checkpoint(_chunk_ce, hidden[:, sl], unembed, labels[:, sl], mask[:, sl],
                              vocab, use_reentrant=False, preserve_rng_state=False)
            nll, cnt = nll + a, cnt + b
    nll_n = nll.reshape(n_pack, -1).sum(-1)
    cnt_n = cnt.reshape(n_pack, -1).sum(-1)
    per_adapter = nll_n / torch.clamp(cnt_n, min=1.0)
    return per_adapter, per_adapter.sum()


def top1_accuracy(logits: torch.Tensor, labels: torch.Tensor, n_pack: int) -> torch.Tensor:
    """Per-adapter next-token top-1 accuracy."""
    pred = torch.argmax(logits, -1)
    mask = labels != IGNORE
    hit = ((pred == labels) & mask).float()
    hit_n = hit.reshape(n_pack, -1).sum(-1)
    cnt_n = mask.float().reshape(n_pack, -1).sum(-1)
    return hit_n / torch.clamp(cnt_n, min=1.0)
