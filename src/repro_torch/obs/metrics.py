"""Metrics registry: counters, gauges, and latency histograms (the port's
own copy of ``repro/obs/metrics.py``).

The quantitative half of the observability layer (`repro_torch.obs`): while the
tracer answers *where time went* on a timeline, the registry answers *how
much / how often / how slow* as scalars — compile-cache hit counters,
device-idle gauges, TTFT / inter-token-latency histograms with
p50/p95/p99 summaries.

Everything here is stdlib only (no torch, no numpy) and thread-safe; a
metric costs one lock + one list append, so always-on instrumentation of
per-step hot loops is fine. Gauges optionally keep a bounded ``(t, value)``
sample trail so :meth:`repro_torch.obs.trace.Tracer.to_chrome` can export them as
Perfetto counter tracks.

Null variants (:data:`NULL_METRICS`) back the disabled tracer: every
operation is a method call on a shared singleton that touches no state.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

# gauges keep at most this many (t, value) samples for trace export; beyond
# it the trail stops growing (the final value is still exact)
GAUGE_SAMPLE_CAP = 65536


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
    """Last-value gauge with an optional bounded sample trail.

    ``sample=True`` records ``(perf_counter, value)`` pairs on every ``set``
    (capped at :data:`GAUGE_SAMPLE_CAP`) — the raw material for Perfetto
    counter tracks."""

    def __init__(self, name: str = "", *, sample: bool = False):
        self.name = name
        self._value: float = 0.0
        self._lock = threading.Lock()
        self._samples: Optional[List[Tuple[float, float]]] = (
            [] if sample else None
        )

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            if (
                self._samples is not None
                and len(self._samples) < GAUGE_SAMPLE_CAP
            ):
                self._samples.append((time.perf_counter(), float(value)))

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def samples(self) -> List[Tuple[float, float]]:
        with self._lock:
            return list(self._samples or ())


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


class MetricsRegistry:
    """Get-or-create registry of named metrics (thread-safe).

    One registry per run; tiers reach it through their tracer
    (``tracer.metrics``) so a single ``--metrics-out`` JSON captures every
    layer. Names are dotted ``tier.metric`` (``serve.queue_depth``,
    ``executor.compile_cache_hits``); ``repro_torch.obs`` lists the names
    the port's tiers use."""

    def __init__(self, *, sample_gauges: bool = True):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._sample_gauges = sample_gauges

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(
                    name, sample=self._sample_gauges
                )
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            return h

    def gauges(self) -> List[Gauge]:
        with self._lock:
            return list(self._gauges.values())

    def to_json(self) -> Dict:
        """Machine-readable snapshot: ``{counters, gauges, histograms}``
        with histogram percentile summaries inlined."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {
                k: h.summary() for k, h in sorted(hists.items())
            },
        }


# ---------------------------------------------------------------------------
# Null variants (the disabled tracer's registry: shared stateless singletons)
# ---------------------------------------------------------------------------


class _NullCounter:
    name = ""
    value = 0

    def inc(self, n: int = 1) -> None:
        pass


class _NullGauge:
    name = ""
    value = 0.0

    def set(self, value: float) -> None:
        pass

    def samples(self) -> List[Tuple[float, float]]:
        return []


class _NullHistogram:
    name = ""
    count = 0

    def record(self, value: float) -> None:
        pass

    def values(self) -> List[float]:
        return []

    def summary(self) -> Dict[str, float]:
        return Histogram().summary()


class NullMetrics:
    """No-op registry: every lookup returns the same stateless singleton."""

    _counter = _NullCounter()
    _gauge = _NullGauge()
    _histogram = _NullHistogram()

    def counter(self, name: str) -> _NullCounter:
        return self._counter

    def gauge(self, name: str) -> _NullGauge:
        return self._gauge

    def histogram(self, name: str) -> _NullHistogram:
        return self._histogram

    def gauges(self) -> List[Gauge]:
        return []

    def to_json(self) -> Dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}


NULL_METRICS = NullMetrics()
