"""Launch counts of the hand-written kernels' wrappers.

Each wrapper adds one to its count where it launches its kernel: its
``launches`` dict, keyed by (direction, path) -- "fwd" or "bwd", and the
path its plan took. :func:`read` gives the totals by direction and
:func:`read_paths` the totals by path; both are sums of those counts.
A wrapper called while a CUDA graph captures records its kernel into the
graph and launches nothing; the graph then launches that kernel on every
replay. So a capture moves what it recorded out of the counts
(:func:`recorded`), and each replay adds it back (:func:`add`). The counts
are plain integers: captures and launches on several devices at once (one
thread each) may miscount by the calls that overlap a capture.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Tuple

from repro_torch.kernels.fused import fused_matmul, fused_matmul_q
from repro_torch.kernels.packed_matmul import packed_matmul

WRAPPERS = {"packed_matmul": packed_matmul, "fused_matmul": fused_matmul,
            "fused_matmul_q": fused_matmul_q}
# count name of read() -> (wrapper name, direction)
COUNTERS = {
    "packed_matmul": ("packed_matmul", "fwd"),
    "packed_matmul_bwd": ("packed_matmul", "bwd"),
    "fused_matmul": ("fused_matmul", "fwd"),
    "fused_matmul_dx": ("fused_matmul", "bwd"),
    "fused_matmul_q": ("fused_matmul_q", "fwd"),
}


def _counts() -> Dict[Tuple[str, str, str], int]:
    """(wrapper name, direction, path) -> launches, of every wrapper."""
    return {(name, d, p): k for name, fn in WRAPPERS.items() for (d, p), k in fn.launches.items()}


def read() -> Dict[str, int]:
    counts = _counts()
    return {count: sum(k for (name, d, _), k in counts.items() if (name, d) == key)
            for count, key in COUNTERS.items()}


def read_paths() -> Dict[str, Dict[str, int]]:
    """Each wrapper's launches by path (forward and backward together)."""
    out = {name: {} for name in WRAPPERS}
    for (name, _, p), k in _counts().items():
        out[name][p] = out[name].get(p, 0) + k
    return out


def zero() -> None:
    for fn in WRAPPERS.values():
        fn.launches.update(dict.fromkeys(fn.launches, 0))


def add(counts: Dict[Tuple[str, str, str], int]) -> None:
    """Add ``counts`` ((wrapper name, direction, path) -> launches, as
    :func:`recorded` yields them) to the wrappers' counts."""
    for (name, d, p), k in counts.items():
        WRAPPERS[name].launches[d, p] += k


@contextlib.contextmanager
def recorded() -> Iterator[Dict[Tuple[str, str, str], int]]:
    """Around a capture: yields a dict that holds, on exit, the calls each
    wrapper made inside the block, and takes them out of the counts."""
    before = _counts()
    calls: Dict[Tuple[str, str, str], int] = {}
    try:
        yield calls
    finally:
        calls.update({key: k - before[key] for key, k in _counts().items() if k != before[key]})
        add({key: -k for key, k in calls.items()})
