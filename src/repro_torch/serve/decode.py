"""Multi-LoRA serving: prefill + decode steps over packed adapters.

A decode batch of (N*B) requests where requests [n*B, (n+1)*B) use adapter
n runs one grouped-kernel pass per projection — no per-adapter dispatch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapter import PackMeta
from repro_torch.models.model import decode_step, init_caches, prefill


def _scales(meta: Optional[PackMeta], device) -> torch.Tensor:
    return meta.scales(device) if meta else torch.ones((1,), dtype=torch.float32, device=device)


def make_serve_step(cfg: ModelConfig, meta: Optional[PackMeta], *, kcfg=None, device=None):
    """One-token greedy decode step against a cache:
    ``(base, lora, caches, token (NB,1), pos) -> (next_tok, logits, caches)``."""
    scales = _scales(meta, resolve_device(device))
    n_pack = meta.n if meta else 1

    def serve_step(base, lora, caches, token, pos):
        lg, caches = decode_step(base, lora, scales, token, caches, pos, cfg,
                                 n_pack=n_pack, kcfg=kcfg)
        return torch.argmax(lg[:, -1, :], dim=-1).to(torch.int32), lg, caches

    return serve_step


def make_prefill(cfg: ModelConfig, meta: Optional[PackMeta], *, chunk_q: int = 512,
                 kcfg=None, device=None):
    scales = _scales(meta, resolve_device(device))
    n_pack = meta.n if meta else 1

    def prefill_fn(base, lora, batch):
        return prefill(base, lora, scales, batch, cfg, n_pack=n_pack, chunk_q=chunk_q, kcfg=kcfg)

    return prefill_fn


# the sequence-indexed leaves of a cache: attention k/v (NB, S, KV, D) and
# MLA's ckv (NB, S, kvlr) / k_rope (NB, S, dr)
SEQ_LEAVES = ("k", "v", "ckv", "k_rope")
# the cache subtrees of a fixed size, whatever the sequence's length
FIXED_SUBTREES = ("ssm", "cross_kv")


def pad_caches(caches, target_len: int):
    """Grow prefill caches along the sequence axis to ``target_len`` with
    zeros: every leaf of SEQ_LEAVES, whose sequence axis is 1, or 2 under a
    stacked ``"blocks"`` subtree (a leading layer axis). Keeps the dtype.
    An ``"ssm"`` subtree (an SSM layer's conv window and state) and a
    ``"cross_kv"`` one (a cross-attention layer's k/v over the encoder's
    frames), both of a fixed size, pass through unchanged, as in the
    reference. Raises on a tensor leaf of another name: an unknown one
    would pass through unpadded."""

    def walk(t, in_blocks=False):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                if k in FIXED_SUBTREES:
                    out[k] = v
                    continue
                if not isinstance(v, torch.Tensor):
                    out[k] = walk(v, in_blocks or k == "blocks")
                    continue
                if k not in SEQ_LEAVES:
                    raise ValueError(f"cache leaf {k!r} {tuple(v.shape)} is not one of "
                                     f"{SEQ_LEAVES}: its sequence axis is unknown")
                ax = 2 if in_blocks else 1
                if v.shape[ax] > target_len:
                    raise ValueError(f"cache {k} {tuple(v.shape)} longer than {target_len}")
                shape = list(v.shape)
                shape[ax] = target_len
                new = v.new_zeros(shape)
                new.narrow(ax, 0, v.shape[ax]).copy_(v)
                out[k] = new
            return out
        return t

    return walk(caches)


def align_prefill_chunk(cfg: ModelConfig, chunk: Optional[int]) -> Optional[int]:
    """A prefill chunk rounded up so that every resume is safe (the
    reference's ``decode.py:91-105``): attention chunks commute with the
    causal mask at any boundary, but an SSD scan resumes bit for bit only on
    its own chunk grid, so on a stack with an SSM layer the chunk rounds up
    to a multiple of ``cfg.ssm.chunk_size``. None or 0 (or less): no
    chunking, one-shot prefill."""
    if not chunk or chunk <= 0:
        return None
    if cfg.ssm is not None and "ssm" in cfg.layer_kinds():
        q = cfg.ssm.chunk_size
        chunk = -(-chunk // q) * q
    return int(chunk)


def prefill_chunked(base, lora, scales, tokens: torch.Tensor, cfg: ModelConfig, chunk: int, *,
                    n_pack: int = 1, kcfg=None, executor=None, capacity: Optional[int] = None):
    """``prefill``'s contract built from ``prefill_chunk`` steps of at most
    ``chunk`` tokens (aligned by ``align_prefill_chunk``), the reference's
    ``decode.py:107-143``: returns (last-position logits (NB, 1, V), caches)
    with caches of capacity ``capacity or S``, in f32 as the reference's
    (the engine casts them where it writes a row). At capacity S the result
    equals the one-shot ``prefill``'s: every chunk attends a cache of the
    one-shot operands' shapes. ``tokens`` (NB, S) lie on the device the
    caches are made on."""
    from repro_torch.serve.engine import default_executor

    chunk = align_prefill_chunk(cfg, chunk)
    if not chunk:
        raise ValueError("prefill_chunked needs a positive chunk size")
    ex = executor if executor is not None else default_executor()
    nb, s = tokens.shape
    caches = init_caches(cfg, nb, capacity or s, dtype=torch.float32, device=tokens.device)
    fn = ex.prefill_chunk_fn(cfg, n_pack, kcfg=kcfg)
    lg = None
    for p0 in range(0, s, chunk):
        lg, caches = fn(base, lora, scales, tokens[:, p0 : p0 + chunk], caches, p0)
    return lg, caches


def generate(base, lora, cfg: ModelConfig, meta: Optional[PackMeta],
             prompt_tokens: torch.Tensor, n_new: int, *, kcfg=None, executor=None,
             device=None, batch_extra=None):
    """Greedy generation: prefill the prompt (NB, S), then decode ``n_new``
    tokens at a shared position. Returns (NB, n_new) int32. Runs on CUDA
    unless ``device`` says otherwise; ``prompt_tokens`` must be there.
    ``batch_extra``: the prefill batch's other fields (an encoder-decoder's
    "frames", a VLM's "patches"). A VLM's positions start after its
    ``n_patch_tokens`` patch positions, as in the reference, whether or not
    the batch carries patches."""
    from repro_torch.serve.engine import default_executor

    device = resolve_device(device)
    if prompt_tokens.device != device:
        raise ValueError(f"prompt on {prompt_tokens.device}, expected {device}")
    ex = executor if executor is not None else default_executor()
    scales = _scales(meta, device)
    n_pack = meta.n if meta else 1
    s_total = prompt_tokens.shape[1] + cfg.n_patch_tokens
    with torch.no_grad():
        lg, caches = ex.prefill_fn(cfg, n_pack, kcfg=kcfg)(
            base, lora, scales, {"tokens": prompt_tokens, **(batch_extra or {})}
        )
        caches = pad_caches(caches, s_total + n_new)
        step_fn = ex.step_fn(cfg, n_pack, kcfg=kcfg)
        tok = torch.argmax(lg[:, -1, :], dim=-1).to(torch.int32)
        out = [tok]
        for i in range(n_new - 1):
            pos = torch.tensor(s_total + i, dtype=torch.int64, device=device)
            tok, lg, caches = step_fn(base, lora, scales, caches, tok[:, None], pos)
            out.append(tok)
    return torch.stack(out, dim=1)
