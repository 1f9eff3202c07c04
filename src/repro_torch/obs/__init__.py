"""Observability: structured tracing and metrics for every tier of the port
(its own copy of ``repro/obs``, stdlib only).

Two halves, one handle:

* :class:`~repro_torch.obs.trace.Tracer` — span-based tracing with Chrome
  trace-event export (Perfetto-loadable), cross-process stitching
  (``ingest``), and a true no-op disabled mode (:data:`NULL_TRACER`);
  :class:`~repro_torch.obs.trace.MetricsTracer` keeps the metrics and no
  spans;
* :class:`~repro_torch.obs.metrics.MetricsRegistry` — counters, gauges
  (with a sampled time series, exported as Perfetto counter tracks) and
  p50/p95/p99 histograms, reachable as ``tracer.metrics``.

The serve engine, the execution engine, the cluster runner, the slice
executor and the autotuner (``kernels/autotune.py``) take ``tracer=``;
``launch/train.py --trace-out/--metrics-out`` hands one tracer to the
autotuner and the executor and writes both files at the end. Names are
dotted ``tier.metric``: the executor counts
``executor.compile_cache_builds`` / ``_hits`` (captures and their reuse)
and opens ``executor.compile`` / ``executor.train`` spans; the runner and
the adaptive engine set the ``cluster.free_units`` gauge; the engine marks
``engine.launch``, ``engine.preempt`` and ``engine.admission_hold``
instants; the autotuner opens one ``autotune.measure`` span a candidate.
"""
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_METRICS,
    NullMetrics,
    percentile,
)
from .trace import (
    NULL_TRACER,
    MetricsTracer,
    Span,
    TIER_CATS,
    TraceCtx,
    Tracer,
    trace_tiers,
    validate_chrome_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_METRICS",
    "NullMetrics",
    "percentile",
    "NULL_TRACER",
    "MetricsTracer",
    "Span",
    "TIER_CATS",
    "TraceCtx",
    "Tracer",
    "trace_tiers",
    "validate_chrome_trace",
]
