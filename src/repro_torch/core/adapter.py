"""Adapter-level definitions: pack metadata and per-adapter initialization.

A *pack* is N LoRA configurations run over one shared frozen base.
Heterogeneous ranks are zero-padded to the pack's bucket rank ``r_bucket``
(max rank rounded up to a multiple of 8, as in the reference, so trees
interchange with it); the padding contributes exactly 0. The effective
per-adapter scale is alpha_n / r_n.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import LoraConfig


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _f32_vector(values, device) -> torch.Tensor:
    """(N,) f32 on ``device``, copied from the host without blocking: a
    blocking copy of a fresh host tensor ends in a stream synchronize."""
    return torch.tensor(values, dtype=torch.float32).to(device, non_blocking=True)


@dataclass(frozen=True)
class PackMeta:
    """Static description of a pack of LoRA configurations."""

    ranks: Tuple[int, ...]
    alphas: Tuple[float, ...]
    learning_rates: Tuple[float, ...]
    batch_sizes: Tuple[int, ...]

    @property
    def n(self) -> int:
        return len(self.ranks)

    @property
    def r_bucket(self) -> int:
        return max(8, _round_up(max(self.ranks), 8))

    @property
    def max_batch(self) -> int:
        return max(self.batch_sizes)

    def scales(self, device=None) -> torch.Tensor:
        """(N,) f32 effective multipliers alpha_n / r_n."""
        return _f32_vector([a / r for a, r in zip(self.alphas, self.ranks)], device)

    def lr_vector(self, device=None) -> torch.Tensor:
        """(N,) f32 per-adapter learning rates."""
        return _f32_vector(self.learning_rates, device)

    def rank_mask(self, device=None) -> torch.Tensor:
        """(N, r_bucket) f32: 1.0 for real rank columns, 0.0 for padding."""
        iota = torch.arange(self.r_bucket, device=device)[None, :]
        ranks = torch.tensor(self.ranks, device=device)[:, None]
        return (iota < ranks).to(torch.float32)

    def kernel_config(self, impl: Optional[str] = None, remat: Optional[str] = None,
                      base_dtype: Optional[str] = None):
        """Kernel policy for this pack: carries the rank vector down to the
        kernels, so a mixed-rank pack runs as same-rank segments."""
        from repro_torch.kernels.ops import KernelConfig

        return KernelConfig(impl=impl, remat=remat, ranks=self.ranks, base_dtype=base_dtype)


def pack_meta(configs: Sequence[LoraConfig]) -> PackMeta:
    return PackMeta(
        ranks=tuple(c.rank for c in configs),
        alphas=tuple(float(c.alpha) for c in configs),
        learning_rates=tuple(float(c.learning_rate) for c in configs),
        batch_sizes=tuple(int(c.batch_size) for c in configs),
    )


def init_lora_pair(
    gen: torch.Generator, meta: PackMeta, d_in: int, d_out: int,
    dtype=torch.float32, device=None,
) -> dict:
    """Packed (A, B) for one target projection across all N adapters.

    A ~ N(0, 1/d_in) on the first r_n columns (rest zero); B = 0, so the
    delta starts at exactly zero (standard LoRA init)."""
    n, r = meta.n, meta.r_bucket
    a = torch.randn((n, d_in, r), generator=gen, device=device, dtype=torch.float32)
    a = a / (d_in ** 0.5) * meta.rank_mask(device)[:, None, :]
    b = torch.zeros((n, r, d_out), dtype=dtype, device=device)
    return {"a": a.to(dtype), "b": b}
