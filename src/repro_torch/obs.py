"""Metrics and the disabled tracer, as far as the port's engines need them:
its own copy of ``Counter``, ``Gauge``, ``Histogram`` and ``MetricsRegistry``
(``repro/obs/metrics.py``) and of ``NULL_TRACER`` (``repro/obs/trace.py``).
Stdlib only.

A tracer passed to the serve engine, the execution engine, the cluster
runner or the slice executor must offer ``enabled``, ``span(name, **attrs)``
(a context manager whose value has a ``span_id``), ``add_span(name, t0, t1,
**attrs)``, ``instant(name, **attrs)`` (a point event) and ``metrics`` with
``counter(name).inc()`` and ``gauge(name).set(v)``; spans and instants take
the reference's convention (``cat`` = tier, ``track`` = Perfetto row).
``NULL_TRACER`` is the no-op one; ``MetricsTracer`` keeps the metrics and no
spans. Names are dotted ``tier.metric``: the executor counts
``executor.compile_cache_builds`` / ``_hits`` (captures and their reuse);
the runner and the adaptive engine set the ``cluster.free_units`` gauge; the
engine marks ``engine.launch``, ``engine.preempt`` and
``engine.admission_hold`` instants.
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


class Counter:
    """Monotonic event counter."""

    def __init__(self, name: str = ""):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-value gauge."""

    def __init__(self, name: str = ""):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class MetricsRegistry:
    """Get-or-create registry of named counters and gauges (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter(name))

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge(name))

    def to_json(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {"counters": {k: c.value for k, c in sorted(self._counters.items())},
                    "gauges": {k: g.value for k, g in sorted(self._gauges.items())}}


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


class _NullSpan:
    span_id = 0


class _NullTracer:
    """Disabled tracer: every call is a no-op on shared singletons."""

    enabled = False
    metrics = _NullMetrics()
    _span = contextlib.nullcontext(_NullSpan())

    def span(self, name: str, **attrs):
        return self._span

    def add_span(self, name: str, t0: float, t1: float, **attrs) -> None:
        pass

    def instant(self, name: str, **attrs) -> None:
        pass


NULL_TRACER = _NullTracer()


class MetricsTracer(_NullTracer):
    """A tracer that records metrics (``self.metrics``) and no spans."""

    enabled = True

    def __init__(self):
        self.metrics = MetricsRegistry()
