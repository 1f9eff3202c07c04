"""Synthetic data pipeline (the port of ``repro/train/data.py``, token-only
decoders).

A learnable synthetic task: a fixed random permutation pi over the vocab
defines x_{t+1} = pi(x_t) with probability (1 - noise), uniform otherwise.
A base model that never saw pi is at chance; an adapter can learn pi at a
rate that depends on its rank, learning rate and batch size.

Streams are keyed by the adapter's configuration, not by the pack, so an
adapter sees the same samples alone or packed. The samples are drawn in
numpy exactly as the reference draws them and handed over as torch tensors
on the requested device (CUDA unless the caller asks otherwise).
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
    """Yields {"tokens": (N*Bmax, S) int32, "labels": (N*Bmax, S) int32}:
    adapter n fills b_n <= Bmax rows and its padding rows are all IGNORE
    (zero gradient), so mixed batch sizes pack into one rectangle.

    ``start_steps[n]`` fast-forwards adapter n's stream past the batches it
    consumed before, so a resumed adapter sees the samples of an unbroken
    run. Each stream is seeded from ``hash(c.key())``: a tuple of ints and
    floats, whose hash is the same in every process."""
    dev = resolve_device(device)
    vocab = cfg.vocab_size
    perm = task_permutation(task_seed, vocab)
    bmax = max(c.batch_size for c in configs)
    rngs = [np.random.RandomState(seed + 7919 * hash(c.key()) % 100_000) for c in configs]
    if start_steps is not None:
        if len(start_steps) != len(configs):
            raise ValueError(f"start_steps {start_steps} do not match {len(configs)} configs")
        for n, c in enumerate(configs):
            for _ in range(start_steps[n]):
                sample_perm_lm(rngs[n], perm, c.batch_size, seq, vocab, noise)
    while True:
        toks = np.zeros((len(configs), bmax, seq), np.int32)
        labs = np.full((len(configs), bmax, seq), IGNORE, np.int32)
        for n, c in enumerate(configs):
            x = sample_perm_lm(rngs[n], perm, c.batch_size, seq, vocab, noise)
            toks[n, : c.batch_size] = x
            labs[n, : c.batch_size, : seq - 1] = x[:, 1:]
        yield {
            "tokens": torch.from_numpy(toks.reshape(len(configs) * bmax, seq)).to(dev),
            "labels": torch.from_numpy(labs.reshape(len(configs) * bmax, seq)).to(dev),
        }


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
    """Held-out eval batch on the same task (noise-free for clean accuracy)."""
    dev = resolve_device(device)
    perm = task_permutation(task_seed, cfg.vocab_size)
    rng = np.random.RandomState(seed)
    x = sample_perm_lm(rng, perm, n_pack * batch, seq, cfg.vocab_size, noise)
    labs = np.full((n_pack * batch, seq), IGNORE, np.int32)
    labs[:, : seq - 1] = x[:, 1:]
    return {"tokens": torch.from_numpy(x).to(dev), "labels": torch.from_numpy(labs).to(dev)}
