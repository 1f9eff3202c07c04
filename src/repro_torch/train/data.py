"""Synthetic data pipeline (the port of ``repro/train/data.py``).

A learnable synthetic task: a fixed random permutation pi over the vocab
defines x_{t+1} = pi(x_t) with probability (1 - noise), uniform otherwise.
A base model that never saw pi is at chance; an adapter can learn pi at a
rate that depends on its rank, learning rate and batch size.

Streams are keyed by the adapter's configuration, not by the pack, so an
adapter sees the same samples alone or packed. The samples are drawn in
numpy exactly as the reference draws them and handed over as torch tensors
on the requested device (CUDA unless the caller asks otherwise).

An encoder-decoder's batch also carries its front end's stub, precomputed
frame embeddings ("frames": (NB, S_enc, d)); a VLM's, patch embeddings
("patches": (NB, P, d)) whose P positions come before the text and take
part of the sequence's budget: S - P tokens, the labels shifted by P.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import LoraConfig, ModelConfig
from repro_torch.train.losses import IGNORE


def task_permutation(task_seed: int, vocab: int) -> np.ndarray:
    rng = np.random.RandomState(task_seed)
    return rng.permutation(vocab)


def sample_perm_lm(
    rng: np.random.RandomState,
    perm: np.ndarray,
    batch: int,
    seq: int,
    vocab: int,
    noise: float = 0.1,
) -> np.ndarray:
    x = np.empty((batch, seq), np.int32)
    x[:, 0] = rng.randint(0, vocab, batch)
    for t in range(1, seq):
        nxt = perm[x[:, t - 1]]
        flip = rng.rand(batch) < noise
        nxt = np.where(flip, rng.randint(0, vocab, batch), nxt)
        x[:, t] = nxt
    return x


def packed_batch_iterator(
    cfg: ModelConfig,
    configs: Sequence[LoraConfig],
    *,
    seq: int,
    task_seed: int = 0,
    noise: float = 0.1,
    seed: int = 1234,
    start_steps: Optional[Sequence[int]] = None,
    device=None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Yields {"tokens": (N*Bmax, S - P) int32, "labels": (N*Bmax, S)
    int32} (P = ``cfg.n_patch_tokens``, 0 but for a VLM), with the front
    end's stubs (``frontend_stubs``): adapter n fills b_n <= Bmax rows and
    its padding rows are all IGNORE (zero gradient), so mixed batch sizes
    pack into one rectangle. Position P + t is labelled with token t + 1;
    the prefix and the last position are IGNORE.

    ``start_steps[n]`` fast-forwards adapter n's stream past the batches it
    consumed before, so a resumed adapter sees the samples of an unbroken
    run. Each stream is seeded from ``hash(c.key())``: a tuple of ints and
    floats, whose hash is the same in every process."""
    dev = resolve_device(device)
    vocab = cfg.vocab_size
    perm = task_permutation(task_seed, vocab)
    bmax = max(c.batch_size for c in configs)
    rngs = [np.random.RandomState(seed + 7919 * hash(c.key()) % 100_000) for c in configs]
    n_patch = cfg.n_patch_tokens
    s_text = seq - n_patch
    if start_steps is not None:
        if len(start_steps) != len(configs):
            raise ValueError(f"start_steps {start_steps} do not match {len(configs)} configs")
        for n, c in enumerate(configs):
            for _ in range(start_steps[n]):
                sample_perm_lm(rngs[n], perm, c.batch_size, s_text, vocab, noise)
    nb = len(configs) * bmax
    stubs = frontend_stubs(cfg, nb, seed, dev)
    while True:
        toks = np.zeros((len(configs), bmax, s_text), np.int32)
        labs = np.full((len(configs), bmax, seq), IGNORE, np.int32)
        for n, c in enumerate(configs):
            x = sample_perm_lm(rngs[n], perm, c.batch_size, s_text, vocab, noise)
            toks[n, : c.batch_size] = x
            labs[n, : c.batch_size, n_patch : seq - 1] = x[:, 1:]
        yield {
            "tokens": torch.from_numpy(toks.reshape(nb, s_text)).to(dev),
            "labels": torch.from_numpy(labs.reshape(nb, seq)).to(dev),
            **stubs,
        }


def frontend_stubs(cfg: ModelConfig, nb: int, seed: int, device=None) -> Dict[str, torch.Tensor]:
    """The front ends' stubs, 0.1 x N(0, 1) in f32, the same at every
    step: an encoder-decoder's frames (nb, S_enc, d), drawn from a
    generator seeded with ``seed``, and a VLM's patches (nb, P, d), from
    ``seed + 1``. The reference draws them from ``jax.random`` with those
    seeds (``repro/train/data.py:100-114``), which torch cannot reproduce:
    the values differ, their law and their constancy do not."""
    dev = resolve_device(device)
    out = {}
    if cfg.is_encdec:
        gen = torch.Generator().manual_seed(seed)
        out["frames"] = (0.1 * torch.randn((nb, cfg.encoder_seq_len, cfg.d_model),
                                           generator=gen)).to(dev)
    if cfg.n_patch_tokens:
        gen = torch.Generator().manual_seed(seed + 1)
        out["patches"] = (0.1 * torch.randn((nb, cfg.n_patch_tokens, cfg.d_model),
                                            generator=gen)).to(dev)
    return out


def eval_batch(
    cfg: ModelConfig,
    n_pack: int,
    *,
    seq: int,
    batch: int = 4,
    task_seed: int = 0,
    noise: float = 0.0,
    seed: int = 999,
    device=None,
):
    """Held-out eval batch on the same task (noise-free for clean
    accuracy), laid out as ``packed_batch_iterator``'s."""
    dev = resolve_device(device)
    perm = task_permutation(task_seed, cfg.vocab_size)
    rng = np.random.RandomState(seed)
    n_patch = cfg.n_patch_tokens
    x = sample_perm_lm(rng, perm, n_pack * batch, seq - n_patch, cfg.vocab_size, noise)
    labs = np.full((n_pack * batch, seq), IGNORE, np.int32)
    labs[:, n_patch : seq - 1] = x[:, 1:]
    return {"tokens": torch.from_numpy(x).to(dev), "labels": torch.from_numpy(labs).to(dev),
            **frontend_stubs(cfg, n_pack * batch, seed, dev)}
