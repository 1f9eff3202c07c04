"""PyTorch/CUDA port of the PLoRA reproduction.

The JAX package ``repro`` is the reference; this package mirrors its module
layout and public names and imports nothing of it. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; with no device given and
no CUDA present they raise (:func:`resolve_device`).
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else CUDA.
    Never falls back to the CPU: with no device given and no CUDA present
    this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' explicitly to run on the CPU"
        )
    return torch.device("cuda")
