"""Span-based structured tracer with Chrome trace-event export (the port's
own copy of ``repro/obs/trace.py``, stdlib only).

One :class:`Tracer` per run collects :class:`Span` records — named,
categorized intervals on a monotonic clock (`time.perf_counter`) — from
every tier of the stack and exports them as a single Chrome trace-event
JSON that loads in Perfetto or ``chrome://tracing``.

Span naming convention:

* names are dotted ``tier.operation`` — ``engine.replan``,
  ``runner.wait_units``, ``executor.train``, ``executor.compile``,
  ``serve.step``, ``autotune.measure``;
* ``cat`` is the tier — one of :data:`TIER_CATS` — and is what the CI
  trace check counts (``scripts/check_trace.py --min-tiers``);
* ``track`` picks the Perfetto row: device units (``unit3`` or
  ``units0-3``), hosts (``host1``), serve rows (``row2``), or the
  emitting thread name when unset.

Concurrency: span stacks are thread-local, so concurrently open spans on
different threads nest independently; the finished-span list and id
counter are lock-protected. Cross-process stitching (the multi-host
workers of ``cluster/multihost.py``) ships finished spans back as plain
dicts and re-ingests them with :meth:`Tracer.ingest`, which remaps ids,
rebases clocks, and reparents the worker's root onto the dispatcher-side
``dispatch.segment`` span.

Disabled tracing is a true no-op: :data:`NULL_TRACER` returns one shared
context-manager singleton from ``span()`` and touches no state, so
always-on call sites cost an attribute lookup and a method call.
:class:`MetricsTracer` keeps its metrics registry and records no spans.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

from .metrics import MetricsRegistry, NULL_METRICS

# tiers a span's `cat` may belong to; the CI trace check counts distinct
# members of this set present in a capture
TIER_CATS = (
    "engine",
    "runner",
    "executor",
    "dispatch",
    "host",
    "serve",
    "autotune",
)


@dataclass(frozen=True)
class TraceCtx:
    """Trace context crossing the multihost pickle boundary.

    What a worker needs to stitch its spans under the dispatcher's:
    ``trace_id`` names the dispatcher's trace, ``parent`` is the
    dispatcher-side span id the worker's root span stitches under. Plain
    picklable data."""

    trace_id: str
    parent: Optional[int] = None


@dataclass
class Span:
    """One finished (or still-open) interval on the trace timeline.

    ``start``/``end`` are absolute `time.perf_counter` seconds in the
    owning tracer's clock domain; export rebases them onto the tracer's
    ``t0``. ``args`` must stay JSON-serializable — it lands verbatim in
    the Chrome event's ``args``."""

    name: str
    cat: str = ""
    track: str = ""
    span_id: int = 0
    parent_id: Optional[int] = None
    root_id: int = 0
    start: float = 0.0
    end: float = 0.0
    args: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "cat": self.cat,
            "track": self.track,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "root_id": self.root_id,
            "start": self.start,
            "end": self.end,
            "args": self.args,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Span":
        return cls(
            name=d["name"],
            cat=d.get("cat", ""),
            track=d.get("track", ""),
            span_id=d.get("span_id", 0),
            parent_id=d.get("parent_id"),
            root_id=d.get("root_id", 0),
            start=d.get("start", 0.0),
            end=d.get("end", 0.0),
            args=dict(d.get("args") or {}),
        )


class _SpanCM:
    """Context manager handed out by :meth:`Tracer.span`.

    Not ``@contextmanager``: a plain object with ``__enter__``/``__exit__``
    is cheaper, and lets the disabled path reuse one shared instance."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._push(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        self._tracer._pop(self._span)
        return None


class _NullSpanCM:
    """Shared no-op context manager; yields a throwaway blank Span so
    call sites may still write ``sp.args[...]`` without branching."""

    __slots__ = ()
    _BLANK = Span(name="")

    def __enter__(self) -> Span:
        return self._BLANK

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_NULL_CM = _NullSpanCM()


class Tracer:
    """Collects spans from any thread; exports one Chrome trace.

    Parameters
    ----------
    enabled:
        ``False`` makes every operation a no-op (``span()`` returns the
        shared null context manager). :data:`NULL_TRACER` is the shared
        disabled instance — prefer it over constructing your own.
    metrics:
        A :class:`MetricsRegistry` to pair with this tracer; created on
        demand if omitted. Instrumented tiers reach it via ``.metrics``
        so one object threads both signals through the stack.
    """

    def __init__(self, enabled: bool = True,
                 metrics: Optional[MetricsRegistry] = None):
        self.enabled = enabled
        if metrics is not None:
            self.metrics = metrics
        else:
            self.metrics = MetricsRegistry() if enabled else NULL_METRICS
        self.trace_id = f"trace-{id(self):x}"
        self.t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._finished: List[Span] = []
        self._next_id = 1
        self._tls = threading.local()

    # -- internal span lifecycle -------------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _alloc_id(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            return sid

    def _push(self, span: Span) -> None:
        span.start = time.perf_counter()
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        span.end = time.perf_counter()
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        else:  # mis-nested exit; drop from wherever it sits
            try:
                st.remove(span)
            except ValueError:
                pass
        with self._lock:
            self._finished.append(span)

    # -- public recording API ----------------------------------------------

    def span(self, name: str, *, cat: str = "", track: str = "",
             parent: Optional[int] = None, **args: Any):
        """Open a span: ``with tracer.span("executor.train", cat="executor",
        track="unit0", job_id=3) as sp: ...``.

        ``parent`` overrides the implicit parent (top of this thread's
        stack) — used when the logical parent lives on another thread,
        e.g. engine-submitted work running on a pool thread."""
        if not self.enabled:
            return _NULL_CM
        if parent is None:
            st = self._stack()
            top = st[-1] if st else None
            parent_id = top.span_id if top else None
            root_id = top.root_id if top else None
        else:
            parent_id = parent
            root_id = None
            with self._lock:
                for s in reversed(self._finished):
                    if s.span_id == parent:
                        root_id = s.root_id
                        break
            if root_id is None:
                st = self._stack()
                for s in reversed(st):
                    if s.span_id == parent:
                        root_id = s.root_id
                        break
        sid = self._alloc_id()
        sp = Span(name=name, cat=cat, track=track, span_id=sid,
                  parent_id=parent_id,
                  root_id=root_id if root_id is not None else sid,
                  args=dict(args))
        return _SpanCM(self, sp)

    def instant(self, name: str, *, cat: str = "", track: str = "",
                **args: Any) -> None:
        """Record a zero-duration marker (rendered as a thin slice)."""
        if not self.enabled:
            return
        st = self._stack()
        top = st[-1] if st else None
        now = time.perf_counter()
        sid = self._alloc_id()
        sp = Span(name=name, cat=cat, track=track, span_id=sid,
                  parent_id=top.span_id if top else None,
                  root_id=top.root_id if top else sid,
                  start=now, end=now, args=dict(args))
        with self._lock:
            self._finished.append(sp)

    def add_span(self, name: str, start: float, end: float, *,
                 cat: str = "", track: str = "",
                 parent: Optional[int] = None, **args: Any) -> None:
        """Record a span from externally measured `perf_counter` times
        (e.g. a serve request's whole lifetime, assembled at retire)."""
        if not self.enabled:
            return
        sid = self._alloc_id()
        sp = Span(name=name, cat=cat, track=track, span_id=sid,
                  parent_id=parent, root_id=sid,
                  start=start, end=end, args=dict(args))
        with self._lock:
            self._finished.append(sp)

    def current_span_id(self) -> Optional[int]:
        if not self.enabled:
            return None
        st = self._stack()
        return st[-1].span_id if st else None

    # -- cross-process stitching -------------------------------------------

    def context(self) -> TraceCtx:
        """Snapshot (trace_id, current span id) for the wire."""
        return TraceCtx(trace_id=self.trace_id,
                        parent=self.current_span_id())

    def pop_root(self, root_id: int) -> List[Dict[str, Any]]:
        """Remove and return (as dicts) every finished span belonging to
        the tree rooted at ``root_id`` — the worker-side flush."""
        if not self.enabled:
            return []
        with self._lock:
            mine = [s for s in self._finished if s.root_id == root_id]
            self._finished = [
                s for s in self._finished if s.root_id != root_id
            ]
        return [s.to_dict() for s in mine]

    def ingest(self, span_dicts: Iterable[Dict[str, Any]], *,
               offset: float = 0.0, parent_id: Optional[int] = None,
               track_prefix: str = "") -> None:
        """Adopt spans recorded by another tracer (another process).

        Ids are remapped into this tracer's id space; times are shifted
        by ``offset`` (seconds) to rebase the foreign clock; parentless
        spans are attached under ``parent_id``; tracks get
        ``track_prefix`` so each host lands on its own Perfetto rows."""
        if not self.enabled:
            return
        spans = [Span.from_dict(d) for d in span_dicts]
        idmap: Dict[int, int] = {}
        for s in spans:
            idmap[s.span_id] = self._alloc_id()
        for s in spans:
            s.span_id = idmap[s.span_id]
            if s.parent_id is not None and s.parent_id in idmap:
                s.parent_id = idmap[s.parent_id]
            else:
                s.parent_id = parent_id
            s.root_id = idmap.get(s.root_id, s.span_id)
            s.start += offset
            s.end += offset
            s.track = track_prefix + (s.track or "worker")
        with self._lock:
            self._finished.extend(spans)

    # -- export ------------------------------------------------------------

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def to_chrome(self) -> Dict[str, Any]:
        """Build the Chrome trace-event dict: ``X`` events for spans (ts in
        µs relative to tracer start), ``M`` thread-name metadata per track,
        ``C`` counter events from sampled gauges."""
        with self._lock:
            finished = list(self._finished)
        events: List[Dict[str, Any]] = []
        tids: Dict[str, int] = {}

        def tid_for(track: str) -> int:
            t = tids.get(track)
            if t is None:
                t = tids[track] = len(tids) + 1
            return t

        for s in sorted(finished, key=lambda s: s.start):
            track = s.track or "main"
            args = dict(s.args)
            if s.parent_id is not None:
                args["parent_span"] = s.parent_id
            args["span_id"] = s.span_id
            events.append({
                "name": s.name,
                "cat": s.cat or "default",
                "ph": "X",
                "ts": max(0.0, (s.start - self.t0) * 1e6),
                "dur": max(0.0, (s.end - s.start) * 1e6),
                "pid": 1,
                "tid": tid_for(track),
                "args": args,
            })
        for g in self.metrics.gauges():
            samples = g.samples()
            if not samples:
                continue
            tid = tid_for(f"counter:{g.name}")
            for t, v in samples:
                events.append({
                    "name": g.name,
                    "cat": "metric",
                    "ph": "C",
                    "ts": max(0.0, (t - self.t0) * 1e6),
                    "pid": 1,
                    "tid": tid,
                    "args": {"value": v},
                })
        meta: List[Dict[str, Any]] = [{
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "args": {"name": f"repro:{self.trace_id}"},
        }]
        for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": track},
            })
            meta.append({
                "name": "thread_sort_index",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"sort_index": tid},
            })
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {"trace_id": self.trace_id},
        }

    def export(self, path: str) -> None:
        """Write the Chrome trace JSON to ``path``."""
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh)

    def export_metrics(self, path: str) -> None:
        """Write the metrics-registry snapshot JSON to ``path``."""
        with open(path, "w") as fh:
            json.dump(self.metrics.to_json(), fh, indent=2)


NULL_TRACER = Tracer(enabled=False)


def validate_chrome_trace(obj: Any) -> List[str]:
    """Validate a parsed trace dict against the Chrome trace-event schema
    subset this module emits. Returns a list of problems (empty = valid)."""
    problems: List[str] = []
    if not isinstance(obj, dict):
        return ["top level is not an object"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M", "C", "B", "E", "i", "I"):
            problems.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            problems.append(f"{where}: name missing")
        if "pid" not in ev:
            problems.append(f"{where}: pid missing")
        if ph == "X":
            for key in ("ts", "dur", "tid"):
                if not isinstance(ev.get(key), (int, float)):
                    problems.append(f"{where}: {key} missing or non-numeric")
            if isinstance(ev.get("ts"), (int, float)) and ev["ts"] < 0:
                problems.append(f"{where}: negative ts")
            if isinstance(ev.get("dur"), (int, float)) and ev["dur"] < 0:
                problems.append(f"{where}: negative dur")
        elif ph == "C":
            if not isinstance(ev.get("ts"), (int, float)):
                problems.append(f"{where}: ts missing or non-numeric")
            if not isinstance(ev.get("args"), dict):
                problems.append(f"{where}: counter args missing")
        elif ph == "M":
            if not isinstance(ev.get("args"), dict):
                problems.append(f"{where}: metadata args missing")
    return problems


def trace_tiers(obj: Dict[str, Any]) -> List[str]:
    """Distinct tier categories (members of :data:`TIER_CATS`) present in
    a parsed Chrome trace dict."""
    seen = set()
    for ev in obj.get("traceEvents", []):
        if isinstance(ev, dict) and ev.get("ph") == "X":
            cat = ev.get("cat", "")
            if cat in TIER_CATS:
                seen.add(cat)
    return sorted(seen)


class MetricsTracer(Tracer):
    """A tracer that keeps its metrics registry (``self.metrics``) and
    records no spans."""

    def __init__(self):
        super().__init__(enabled=True)

    def span(self, name: str, *, cat: str = "", track: str = "",
             parent: Optional[int] = None, **args: Any):
        return _NULL_CM

    def instant(self, name: str, *, cat: str = "", track: str = "",
                **args: Any) -> None:
        pass

    def add_span(self, name: str, start: float, end: float, *,
                 cat: str = "", track: str = "",
                 parent: Optional[int] = None, **args: Any) -> None:
        pass
