"""Launch counts of the hand-written kernels' wrappers, as one dict.

Each wrapper adds one to its count where it launches its kernel. A wrapper
called while a CUDA graph captures records its kernel into the graph and
launches nothing; the graph then launches that kernel on every replay. So a
capture moves what it recorded out of the counts (:func:`recorded`), and
each replay adds it back (:func:`add`). The counts are plain integers:
captures and launches on several devices at once (one thread each) may
miscount by the calls that overlap a capture.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

from repro_torch.kernels.fused import fused_matmul, fused_matmul_q
from repro_torch.kernels.packed_matmul import packed_matmul

# count name -> (wrapper, attribute)
COUNTERS = {
    "packed_matmul": (packed_matmul, "launches"),
    "packed_matmul_bwd": (packed_matmul, "bwd_launches"),
    "fused_matmul": (fused_matmul, "launches"),
    "fused_matmul_dx": (fused_matmul, "bwd_launches"),
    "fused_matmul_q": (fused_matmul_q, "launches"),
}


def read() -> Dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def zero() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def add(counts: Dict[str, int]) -> None:
    for name, k in counts.items():
        fn, attr = COUNTERS[name]
        setattr(fn, attr, getattr(fn, attr) + k)


@contextlib.contextmanager
def recorded() -> Iterator[Dict[str, int]]:
    """Around a capture: yields a dict that holds, on exit, the calls each
    wrapper made inside the block, and takes them out of the counts."""
    before = read()
    calls: Dict[str, int] = {}
    try:
        yield calls
    finally:
        calls.update({name: k - before[name] for name, k in read().items()})
        add({name: -k for name, k in calls.items()})
