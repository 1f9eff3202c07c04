"""The port's tracer and metrics registry (``repro_torch.obs``) against the
JAX package's (``repro.obs``), on the CPU.

Both are stdlib only, so they are held to each other exactly: the same
calls on both give the same Chrome trace events up to timestamps (and the
trace id, which names the object), the same metrics JSON, and each side's
``validate_chrome_trace`` / ``trace_tiers`` accept the other's export.
"""
import json
import threading
import time

import pytest

from repro import obs as jobs
from repro_torch import obs as tobs

# wall-clock fields of the events: everything else must match
_CLOCK_KEYS = ("ts", "dur")


def _script(obs_mod, tr):
    """One sequence of every recording call the tracer offers; explicit
    times are relative to the tracer's own ``t0``."""
    with tr.span("engine.run_local", cat="engine", job_id=3) as root:
        with tr.span("executor.compile", cat="executor", track="unit0", n_pack=2):
            tr.instant("engine.launch", cat="engine", track="main", job_id=3)
        with tr.span("executor.train", cat="executor", track="unit0",
                     parent=root.span_id, n_steps=4) as sp:
            sp.args["extra"] = [1, 2]
        assert tr.current_span_id() == root.span_id
        ctx = tr.context()
        assert isinstance(ctx, obs_mod.TraceCtx) and ctx.parent == root.span_id
    tr.add_span("serve.request", tr.t0 + 50.0, tr.t0 + 50.5, cat="serve", track="row1",
                request_id=7)
    with tr.span("autotune.measure", cat="autotune", track="autotune",
                 shape=[2, 1024, 3584, 3584, 16], blocks=[2]) as msp:
        msp.args["seconds"] = 1e-3
    with tr.span("dispatch.segment", cat="dispatch", track="host0") as d:
        pass
    tr.ingest([
        {"name": "host0.segment", "cat": "host", "track": "", "span_id": 1,
         "parent_id": None, "root_id": 1, "start": 0.0, "end": 2.0, "args": {}},
        {"name": "executor.train", "cat": "executor", "track": "unit1", "span_id": 2,
         "parent_id": 1, "root_id": 1, "start": 0.5, "end": 1.5, "args": {"k": 1}},
    ], offset=tr.t0 + 100.0, parent_id=d.span_id, track_prefix="host0/")
    tr.metrics.counter("executor.compile_cache_builds").inc()
    tr.metrics.counter("executor.compile_cache_hits").inc(3)
    for v in (4, 2, 5):
        tr.metrics.gauge("cluster.free_units").set(v)
    for v in (0.25, 0.5, 1.0, 2.0):
        tr.metrics.histogram("serve.ttft_s").record(v)


def _events(chrome):
    """The trace's events with the clock fields and the trace id taken out."""
    out = []
    for ev in chrome["traceEvents"]:
        ev = {k: v for k, v in ev.items() if k not in _CLOCK_KEYS}
        if ev["name"] == "process_name":
            ev["args"] = {"name": ev["args"]["name"].split(":")[0]}
        out.append(ev)
    return out


def test_same_calls_give_the_same_chrome_events_and_metrics(tmp_path):
    jt, tt = jobs.Tracer(), tobs.Tracer()
    _script(jobs, jt)
    _script(tobs, tt)
    jc, tc = jt.to_chrome(), tt.to_chrome()
    assert _events(tc) == _events(jc)
    assert set(tc) == set(jc)
    assert tc["otherData"] == {"trace_id": tt.trace_id}
    for chrome in (jc, tc):  # each side's checks accept both exports
        assert tobs.validate_chrome_trace(chrome) == jobs.validate_chrome_trace(chrome) == []
        assert tobs.trace_tiers(chrome) == jobs.trace_tiers(chrome) == [
            "autotune", "dispatch", "engine", "executor", "host", "serve"]
    assert tt.metrics.to_json() == jt.metrics.to_json()
    assert [s.to_dict()["args"] for s in tt.spans()] == [s.to_dict()["args"] for s in jt.spans()]
    tt.export(str(tmp_path / "t.json"))
    tt.export_metrics(str(tmp_path / "m.json"))
    assert _events(json.loads((tmp_path / "t.json").read_text())) == _events(tc)
    assert json.loads((tmp_path / "m.json").read_text()) == jt.metrics.to_json()


def test_pop_root_flushes_one_tree_as_the_reference_does():
    got = []
    for mod in (jobs, tobs):
        tr = mod.Tracer()
        with tr.span("host0.segment", cat="host") as root:
            with tr.span("executor.train", cat="executor"):
                pass
        with tr.span("other", cat="engine"):
            pass
        flushed = tr.pop_root(root.root_id)
        got.append(([(d["name"], d["parent_id"], d["root_id"]) for d in flushed],
                    [s.name for s in tr.spans()]))
    assert got[0] == got[1] == ([("executor.train", 1, 1), ("host0.segment", None, 1)],
                                ["other"])


@pytest.mark.parametrize("mod", [jobs, tobs], ids=["reference", "port"])
def test_disabled_tracer_is_a_true_noop(mod):
    t = mod.NULL_TRACER
    cm = t.span("anything", cat="engine", job_id=1)
    assert cm is t.span("else", cat="serve")
    with cm as sp:
        assert sp.span_id == 0
    t.instant("marker", cat="engine")
    t.add_span("ext", 0.0, 1.0, cat="serve")
    t.ingest([{"name": "x"}])
    t.metrics.counter("x").inc()
    t.metrics.gauge("g").set(1.0)
    t.metrics.histogram("h").record(1.0)
    assert t.spans() == [] and t.current_span_id() is None and t.pop_root(1) == []
    assert t.metrics.to_json() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert t.to_chrome()["traceEvents"][0]["name"] == "process_name"


def test_metrics_tracer_keeps_metrics_and_no_spans():
    tr = tobs.MetricsTracer()
    assert tr.enabled
    with tr.span("executor.train", cat="executor") as sp:
        sp.args["seconds"] = 1.0  # the shared blank span takes the write
        tr.instant("engine.launch")
    tr.add_span("serve.request", 0.0, 1.0)
    tr.metrics.counter("executor.compile_cache_builds").inc()
    assert tr.spans() == []
    assert tr.metrics.to_json()["counters"] == {"executor.compile_cache_builds": 1}


@pytest.mark.parametrize("mod", [jobs, tobs], ids=["reference", "port"])
def test_thread_local_stacks_nest_independently(mod):
    tr = mod.Tracer()
    barrier = threading.Barrier(4)

    def work(i):
        with tr.span(f"outer{i}", track=f"t{i}"):
            barrier.wait(timeout=10)
            with tr.span(f"inner{i}", track=f"t{i}"):
                time.sleep(0.001)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    by_name = {s.name: s for s in tr.spans()}
    for i in range(4):
        assert by_name[f"inner{i}"].parent_id == by_name[f"outer{i}"].span_id


def test_metrics_registries_agree():
    regs = (jobs.MetricsRegistry(), tobs.MetricsRegistry())
    for m in regs:
        for v in range(1, 101):
            m.histogram("lat").record(float(v))
        m.counter("hits").inc(2)
        m.gauge("free").set(3)
        m.gauge("free").set(1)
    jj, tj = regs[0].to_json(), regs[1].to_json()
    assert tj == jj and set(tj) == {"counters", "gauges", "histograms"}
    assert tj["histograms"]["lat"]["p95"] == pytest.approx(95.05)
    assert [v for _, v in regs[1].gauge("free").samples()] == [3, 1]
    assert tobs.percentile([1.0, 2.0], 0.5) == jobs.percentile([1.0, 2.0], 0.5)
    empty = tobs.Histogram("e").summary()
    assert empty["count"] == 0 and empty["p50"] != empty["p50"]  # NaN
    assert set(empty) == set(jobs.Histogram("e").summary())


def test_validate_rejects_what_the_reference_rejects():
    bad = {"traceEvents": [
        {"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": -5.0, "dur": 1},
        {"ph": "Z", "name": "b", "pid": 1},
        {"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 1},
        {"ph": "C", "name": "c", "pid": 1},
        {"ph": "M", "name": "m", "pid": 1},
    ]}
    assert tobs.validate_chrome_trace(bad) == jobs.validate_chrome_trace(bad)
    assert len(tobs.validate_chrome_trace(bad)) == 6
    assert tobs.validate_chrome_trace([]) == jobs.validate_chrome_trace([])
    assert tobs.TIER_CATS == jobs.TIER_CATS
