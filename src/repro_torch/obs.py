"""Latency histograms and the disabled tracer, as far as the serve engine
needs them: the port's own copy of ``Histogram`` (``repro/obs/metrics.py``)
and ``NULL_TRACER`` (``repro/obs/trace.py``). Stdlib only.

A tracer passed to the engine must offer ``span(name, **attrs)`` (a context
manager), ``add_span(name, t0, t1, **attrs)`` and ``metrics`` with
``counter(name).inc()`` and ``gauge(name).set(v)``; ``NULL_TRACER`` is the
no-op one.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List


def percentile(sorted_values: List[float], q: float) -> float:
    """Linear-interpolation percentile of an ascending list (q in [0, 1])."""
    if not sorted_values:
        return float("nan")
    if len(sorted_values) == 1:
        return sorted_values[0]
    pos = q * (len(sorted_values) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    frac = pos - lo
    return sorted_values[lo] * (1.0 - frac) + sorted_values[hi] * frac


class Histogram:
    """Latency histogram: records raw values, summarizes as percentiles."""

    def __init__(self, name: str = ""):
        self.name = name
        self._values: List[float] = []
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        with self._lock:
            self._values.append(float(value))

    @property
    def count(self) -> int:
        with self._lock:
            return len(self._values)

    def values(self) -> List[float]:
        with self._lock:
            return list(self._values)

    def summary(self) -> Dict[str, float]:
        """``{count, mean, min, p50, p95, p99, max}`` (NaNs when empty)."""
        with self._lock:
            vs = sorted(self._values)
        if not vs:
            nan = float("nan")
            return {"count": 0, "mean": nan, "min": nan, "p50": nan,
                    "p95": nan, "p99": nan, "max": nan}
        return {
            "count": len(vs),
            "mean": sum(vs) / len(vs),
            "min": vs[0],
            "p50": percentile(vs, 0.50),
            "p95": percentile(vs, 0.95),
            "p99": percentile(vs, 0.99),
            "max": vs[-1],
        }


class _NullMetric:
    def inc(self, n: int = 1) -> None:
        pass

    def set(self, value: float) -> None:
        pass


class _NullMetrics:
    _metric = _NullMetric()

    def counter(self, name: str) -> _NullMetric:
        return self._metric

    def gauge(self, name: str) -> _NullMetric:
        return self._metric


class _NullTracer:
    """Disabled tracer: every call is a no-op on shared singletons."""

    enabled = False
    metrics = _NullMetrics()
    _span = contextlib.nullcontext()

    def span(self, name: str, **attrs):
        return self._span

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        pass


NULL_TRACER = _NullTracer()
