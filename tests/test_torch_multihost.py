"""The port's multi-host dispatch tier: the wire protocol, ``HostDispatcher``
over the in-memory fakes, real worker processes on the CPU, and the
launcher's ``--hosts`` flags.

On the CPU (JAX imported inside the tests that hold the port against the
reference, so this file also runs where JAX is not installed):

  * the message dataclasses carry the reference's fields; segments, records
    and trees round-trip through ``pickle`` bit for bit, bf16 / int8 / nf4
    leaves included, without ``ml_dtypes`` on the port's side; the elastic
    ``DevicePool`` calls answer as the reference pool's do;
  * every fake-transport case of the reference's ``tests/test_multihost.py``
    (unit translation, resume shipping, a killed worker's requeue, death
    forever, kernel policy, payload re-init, a host-spanning slice, the
    adaptive engine over the tier, the four heartbeat cases, elastic join,
    graceful drain, drain during a death, the class-aware pick), the
    ``Runner`` conformance case and the two trace-stitching cases;
  * real spawned workers on the CPU (``device="cpu"``, reduced qwen25-7b):
    two hosts equal the in-process run bit for bit, a SIGKILL mid-segment
    recovers bit for bit with exact budgets, and a worker asked for CUDA
    where there is none fails with the worker's own message;
  * the launcher's ``--hosts``, ``--heartbeat``, ``--drain-after`` and
    ``--join-after``.

On the card (``gpu`` marker; without JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_multihost.py

the two-host run and the kill at a small depth, bf16, workers on the card
sharing it with this process: losses and pooled adapters ``torch.equal`` to
the in-process run's.
"""
import dataclasses
import pickle
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.cluster import ClusterRunner, DevicePool, Runner, SliceExecutor
from repro_torch.cluster.multihost import (
    CheckpointWrite,
    HealthReply,
    HeartbeatMsg,
    HostDispatcher,
    HostUnit,
    KernelPolicy,
    MemoryPool,
    RecordMsg,
    SegmentMsg,
    TransportError,
    WireArray,
    WorkerDied,
    decode_record,
    decode_segment,
    decode_tree,
    encode_record,
    encode_segment,
    encode_tree,
)
from repro_torch.cluster.pool import pick_class_units
from repro_torch.cluster.testing import DictPool, FakeHostTransport
from repro_torch.configs import LoraConfig, get_config, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.kernels.quant import quantize_weight
from repro_torch.models.model import init_model
from repro_torch.obs import TraceCtx, Tracer, trace_tiers, validate_chrome_trace
from repro_torch.sched import (
    A100_40G,
    Arrival,
    CostModel,
    ExecutionEngine,
    JobRecord,
    JobSegment,
    ProfiledCostModel,
    Schedule,
    ScheduledJob,
)
from repro_torch.train.checkpoint import CheckpointPool

SEQ = 16
CPU = torch.device("cpu")


def _cfg(rank=8, alpha=8.0, lr=1e-3, bs=1):
    return LoraConfig(rank=rank, alpha=alpha, learning_rate=lr, batch_size=bs, seq_len=SEQ)


def _seg(job_id=0, cids=(0,), degree=1, start_steps=None, run_steps=3, done=None,
         preempted=False, units=None, start=0.0, end=1.0):
    cids = tuple(cids)
    return JobSegment(
        job_id=job_id, config_ids=cids, degree=degree, start=start, end=end,
        start_steps=tuple(start_steps or (0,) * len(cids)), run_steps=run_steps,
        done_ids=tuple(cids if done is None else done), preempted=preempted,
        units=tuple(units if units is not None else range(degree)),
    )


def _wire(x):
    return pickle.loads(pickle.dumps(x))


# ---------------------------------------------------------------------------
# The wire protocol, held against the reference's
# ---------------------------------------------------------------------------


def test_messages_have_the_reference_fields():
    from repro.cluster import multihost as ref

    for ours, theirs in ((SegmentMsg, ref.SegmentMsg), (RecordMsg, ref.RecordMsg),
                         (CheckpointWrite, ref.CheckpointWrite), (HeartbeatMsg, ref.HeartbeatMsg),
                         (HealthReply, ref.HealthReply), (KernelPolicy, ref.KernelPolicy),
                         (HostUnit, ref.HostUnit)):
        assert [f.name for f in dataclasses.fields(ours)] == [
            f.name for f in dataclasses.fields(theirs)], ours.__name__
        assert [f.default for f in dataclasses.fields(ours)] == [
            f.default for f in dataclasses.fields(theirs)], ours.__name__
    from repro_torch.cluster import multihost as port

    for name in ("HOST_ALIVE", "HOST_SUSPECT", "HOST_DEAD", "HOST_DRAINING"):
        assert getattr(port, name) == getattr(ref, name)


def test_segment_and_record_roundtrip_bitexact():
    from repro.cluster import multihost as ref
    from repro.sched.engine import JobSegment as JJobSegment

    seg = _seg(job_id=7, cids=(3, 1), degree=2, start_steps=(5, 0), run_steps=11, done=(1,),
               preempted=True, units=(4, 5), start=1.25, end=9.75)
    assert decode_segment(_wire(encode_segment(seg))) == seg
    jseg = JJobSegment(**dataclasses.asdict(seg))
    assert dataclasses.asdict(_wire(encode_segment(seg))) == dataclasses.asdict(
        ref.encode_segment(jseg))
    rec = JobRecord(ScheduledJob((2, 0), 2, 0.5, 3.5), 1.25, np.asarray([1.5, 2.5], np.float32))
    out = decode_record(_wire(encode_record(rec)))
    assert out.job == rec.job and out.wall_seconds == rec.wall_seconds
    np.testing.assert_array_equal(out.final_losses, rec.final_losses)
    none = JobRecord(ScheduledJob((0,), 1, 0.0, 1.0), 0.0, None)
    assert decode_record(_wire(encode_record(none))).final_losses is None


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return str(x.dtype), tuple(x.shape), x.numpy().tobytes()
    return str(x.dtype), x.shape, x.tobytes()


def test_tree_roundtrip_bf16_int8_nf4_without_ml_dtypes(monkeypatch):
    """A bf16 leaf crosses as its raw words (the reference's ml_dtypes
    array's bits), int8 / nf4 ``{"codes", "scales"}`` dicts cross unchanged,
    f32 / f64 / int32 numpy stays numpy; the port's side imports no
    ``ml_dtypes`` (its import is made to fail)."""
    import jax.numpy as jnp

    from repro.cluster import multihost as ref

    gen = torch.Generator().manual_seed(0)
    w = torch.randn(64, 48, generator=gen)
    tree = {"bf16": w.to(torch.bfloat16), "f32": w,
            "int8": quantize_weight(w, "int8"), "nf4": quantize_weight(w, "nf4"),
            "np": {"f64": np.random.RandomState(0).randn(2, 3), "i32": np.arange(6, dtype=np.int32)},
            "none": None}
    want_bf16 = ref.encode_tree(jnp.asarray(w.numpy()).astype(jnp.bfloat16))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "ml_dtypes", None)
        wire = _wire(encode_tree(tree))
        back = decode_tree(wire)
        # an ml_dtypes array (a bf16 checkpoint read back) encodes the same way
        again = decode_tree(_wire(encode_tree({"x": want_bf16})))["x"]
    assert isinstance(wire["bf16"], WireArray) and wire["bf16"].bits.dtype == np.int16
    assert wire["bf16"].bits.tobytes() == want_bf16.view(np.uint16).tobytes()
    assert back["bf16"].dtype == torch.bfloat16 and _bits(back["bf16"]) == _bits(tree["bf16"])
    assert _bits(again) == _bits(tree["bf16"])
    assert _bits(back["f32"]) == _bits(w.numpy())
    for mode in ("int8", "nf4"):
        assert set(back[mode]) == set(tree[mode]) == {"codes", "scales"}
        for k in ("codes", "scales"):
            got, want = back[mode][k], tree[mode][k]
            if want.dtype == torch.bfloat16:
                assert _bits(got) == _bits(want)
            else:
                assert _bits(got) == _bits(want.numpy()), (mode, k)
    for k in ("f64", "i32"):
        assert _bits(back["np"][k]) == _bits(tree["np"][k])
    assert back["none"] is None


def test_frames_cross_a_pipe_bit_for_bit():
    """The process transport's frames: arrays out of band (contiguous ones
    read straight into buffers of their own, writable; others in band),
    bf16 words, scalars and dataclasses, in order on one pipe."""
    import multiprocessing as mp

    from repro_torch.cluster.multihost import recv_frame, send_frame

    rng = np.random.RandomState(0)
    f32 = rng.randn(33, 7).astype(np.float32)
    tree = encode_tree({"f32": f32, "strided": f32[:, ::2], "empty": np.zeros((0, 3), np.int8),
                        "bf16": torch.from_numpy(f32).to(torch.bfloat16)})
    r, w = mp.get_context("spawn").Pipe(duplex=False)
    msgs = [("init", {"base": tree, "seq": 16}), ("ping", HeartbeatMsg(seq=3, t_send=1.5))]
    t = threading.Thread(target=lambda: [send_frame(w, m) for m in msgs])
    t.start()
    got = [recv_frame(r) for _ in msgs]
    t.join(timeout=10)
    assert not t.is_alive()
    kind, payload = got[0]
    back = decode_tree(payload["base"])
    assert kind == "init" and payload["seq"] == 16 and got[1] == msgs[1]
    for k in ("f32", "strided", "empty"):
        assert _bits(back[k]) == _bits(tree[k])
    assert back["f32"].flags.writeable
    assert _bits(back["bf16"]) == _bits(torch.from_numpy(f32).to(torch.bfloat16))
    r.close()
    w.close()


def test_memory_pool_capture_contract():
    state = {"w": np.ones(2, np.float32)}
    mp_ = MemoryPool({"0003": (encode_tree(state), {"steps_done": 5})})
    assert mp_.has_adapter_state("0003") and not mp_.has_adapter_state("0001")
    tree, meta = mp_.load_adapter_state("0003")
    assert meta["steps_done"] == 5 and _bits(tree["w"]) == _bits(state["w"])
    mp_.save_adapter("adapter_0003", {"w": torch.zeros(2)}, {"final_loss": 1.0})
    mp_.save_adapter_state("0004", state, {"steps_done": 2})
    assert [w.kind for w in mp_.writes] == ["adapter", "state"]
    assert [w.adapter_id for w in mp_.writes] == ["adapter_0003", "0004"]
    assert isinstance(mp_.writes[0].tree["w"], np.ndarray)  # host memory on the wire


def test_elastic_pool_calls_match_the_reference():
    """``add_devices`` / ``retire_units`` / ``retired`` and the refusals
    that follow a retirement, call for call against the reference pool."""
    from repro.cluster.pool import DevicePool as JDevicePool

    def script(pool):
        out = [pool.add_devices(["d2", "d3"]), pool.total, pool.free]
        s = pool.acquire_units([1])
        done = threading.Event()
        t = threading.Thread(target=lambda: (pool.retire_units([1], timeout=5.0), done.set()))
        t.start()
        time.sleep(0.05)
        out.append(done.is_set())  # still busy: retire waits
        pool.release(s)
        t.join(timeout=5)
        out += [done.is_set(), pool.retired, pool.free]
        for call in (lambda: pool.acquire_units([1]), lambda: pool.release(s),
                     lambda: pool.add_devices([]), lambda: pool.retire_units([9])):
            try:
                call()
                out.append("ok")
            except (RuntimeError, ValueError) as e:
                out.append((type(e).__name__, str(e)))
        pool.retire_units([1])  # retiring twice is a no-op
        out += [pool.acquire_units([0, 2, 3]).units, pool.retired, pool.free]
        return out

    assert script(DevicePool(["d0", "d1"])) == script(JDevicePool(["d0", "d1"]))


# ---------------------------------------------------------------------------
# Dispatcher semantics over in-memory fake transports (no subprocesses)
# ---------------------------------------------------------------------------


def _fake_factory(made, kwargs_by_index=None):
    """Transport factory that records every instantiation; per-instantiation
    kwargs come from ``kwargs_by_index`` (key = 0-based creation index)."""
    kwargs_by_index = kwargs_by_index or {}

    def factory(host_id, n_devices):
        tr = FakeHostTransport(host_id, n_devices, **kwargs_by_index.get(len(made), {}))
        made.append(tr)
        return tr

    return factory


def test_dispatch_across_hosts_translates_units_and_applies_writes():
    made = []
    cfgs = {i: _cfg(alpha=8.0 * (i + 1)) for i in range(4)}
    segs = [_seg(job_id=i, cids=(i,), units=(i,)) for i in range(4)]
    pool = DictPool()
    with HostDispatcher([2, 2], transport_factory=_fake_factory(made)) as disp:
        result = disp.run(segs, cfgs, {i: 3 for i in range(4)}, None, None, seq=SEQ, pool=pool)
    assert len(result.records) == 4
    assert disp.n_restarts == 0
    # two workers, two segments each, with units translated host-locally
    assert sorted(tr.host_id for tr in made) == [0, 1]
    for tr in made:
        assert len(tr.runs) == 2
        assert sorted(r["units"] for r in tr.runs) == [(0,), (1,)]
    # checkpoint traffic flowed back through the message protocol
    assert sorted(pool.adapters) == [f"adapter_{i:04d}" for i in range(4)]


def test_dispatch_resume_ships_state_over_the_wire():
    made = []
    segs = [_seg(job_id=0, run_steps=2, done=(), preempted=True, units=(0,)),
            _seg(job_id=1, start_steps=(2,), run_steps=3, units=(0,), start=1.0)]
    pool = DictPool()
    with HostDispatcher([1], transport_factory=_fake_factory(made)) as disp:
        disp.run(segs, {0: _cfg()}, {0: 5}, None, None, seq=SEQ, pool=pool)
    (tr,) = made
    # the preempted segment's state write landed in the central pool, and
    # the resume segment received it over the wire (FakeHostTransport
    # asserts steps_done == start_steps)
    assert tr.resumed == [(1, "0000")]
    assert pool.adapters and pool.states["0000"][1]["steps_done"] == 2


def test_killed_worker_requeues_residual_through_preempt_path():
    """Worker death mid-(resumed)-segment: the dispatcher respawns the host
    and re-dispatches the same residual -- resumed from unchanged pool
    state, with nothing double-applied (writes are success-atomic)."""
    made = []
    segs = [_seg(job_id=0, run_steps=2, done=(), preempted=True, units=(0,)),
            _seg(job_id=1, start_steps=(2,), run_steps=3, units=(0,), start=1.0)]
    pool = DictPool()
    factory = _fake_factory(made, {0: {"die_on": lambda idx, payload: idx == 1}})
    with HostDispatcher([1], transport_factory=factory) as disp:
        result = disp.run(segs, {0: _cfg()}, {0: 5}, None, None, seq=SEQ, pool=pool)
    assert disp.n_restarts == 1
    assert len(made) == 2  # original + respawn
    retry = made[1].runs[0]
    assert retry["seg"].start_steps == (2,) and retry["seg"].run_steps == 3
    assert made[1].resumed == [(0, "0000")]
    assert len(result.records) == 2
    assert sorted(pool.adapters) == ["adapter_0000"]


def test_worker_dying_forever_raises_not_hangs():
    made = []
    factory = _fake_factory(made, {i: {"die_on": lambda idx, payload: True} for i in range(5)})
    with HostDispatcher([1], transport_factory=factory, max_restarts=1) as disp:
        with pytest.raises(WorkerDied, match="died 2 times"):
            disp.run([_seg(units=(0,))], {0: _cfg()}, {0: 3}, None, None, seq=SEQ,
                     pool=DictPool())
    assert len(made) == 2  # initial + one restart


def test_kernel_policy_ships_to_workers():
    """`impl`/`remat`/`base_dtype` ride the wire as a typed KernelPolicy with
    every segment."""
    made = []
    segs = [_seg(job_id=i, cids=(i,), units=(0,), start=float(i)) for i in range(2)]
    with HostDispatcher([1], transport_factory=_fake_factory(made)) as disp:
        disp.run(segs, {i: _cfg() for i in range(2)}, {i: 3 for i in range(2)}, None, None,
                 seq=SEQ, pool=DictPool(), impl="fused", remat="recompute", base_dtype="nf4")
    (tr,) = made
    assert tr.policies == [KernelPolicy("fused", "recompute", "nf4")] * 2


def test_kernel_policy_defaults_to_context():
    """With no explicit impl, the caller's context-local default is captured
    and shipped ("auto" normalizes to None = worker default)."""
    from repro_torch.kernels.ops import use_impl

    made = []
    with HostDispatcher([1], transport_factory=_fake_factory(made)) as disp:
        with use_impl("fused"):
            disp.run([_seg(units=(0,))], {0: _cfg()}, {0: 3}, None, None, seq=SEQ,
                     pool=DictPool())
        disp.run([_seg(units=(0,))], {0: _cfg()}, {0: 3}, None, None, seq=SEQ, pool=DictPool())
    (tr,) = made
    assert tr.policies[0] == KernelPolicy("fused", None)
    assert tr.policies[1] == KernelPolicy(None, None)  # "auto" -> None


def test_payload_reinit_on_new_workload():
    """The init-payload memo keys on *values*, not object ids -- a second
    workload with different configs re-initializes the workers, while a
    content-identical one (fresh dict objects) does not; nor does a change
    of the numeric settings go unnoticed."""
    made = []
    segs = [_seg(units=(0,))]
    threads = torch.get_num_threads()
    with HostDispatcher([1], transport_factory=_fake_factory(made)) as disp:
        disp.run(segs, {0: _cfg()}, {0: 3}, None, None, seq=SEQ, pool=DictPool())
        v1 = disp._payload_version
        assert disp._payload["numerics"]["num_threads"] == threads
        disp.run(segs, {0: _cfg()}, {0: 3}, None, None, seq=SEQ, pool=DictPool())
        assert disp._payload_version == v1  # same values: no re-init
        disp.run(segs, {0: _cfg(rank=16, alpha=16.0)}, {0: 3}, None, None, seq=SEQ,
                 pool=DictPool())
        assert disp._payload_version == v1 + 1  # new workload: re-init
        try:
            torch.set_num_threads(threads + 1)
            disp.run(segs, {0: _cfg(rank=16, alpha=16.0)}, {0: 3}, None, None, seq=SEQ,
                     pool=DictPool())
        finally:
            torch.set_num_threads(threads)
        assert disp._payload_version == v1 + 2  # other numerics: re-init
    assert disp.host_stats[0]["inits_sent"] == 3


def test_host_spanning_slice_rejected():
    with HostDispatcher([2, 2], transport_factory=_fake_factory([])) as disp:
        with pytest.raises(RuntimeError, match="span hosts"):
            disp.run([_seg(degree=2, units=(1, 2), run_steps=1)], {0: _cfg()}, {0: 1}, None,
                     None, seq=SEQ, pool=DictPool())


def _estimator():
    prior = CostModel(get_config("qwen25-7b"), A100_40G)
    prior.setup_time = 0.0
    return ProfiledCostModel(prior, drift_threshold=0.5)


def test_adaptive_engine_runs_over_dispatch_tier():
    """run_online_local's adaptive loop (probe -> checkpoint -> resume) runs
    unchanged over the dispatcher: probes round-trip their state through the
    message protocol and every budget lands exactly."""
    with HostDispatcher([1], transport_factory=_fake_factory([])) as disp:
        eng = ExecutionEngine(_estimator(), 1, host_size=1)
        records, sched = eng.run_online_local(
            [Arrival(0.0, _cfg(), 12)], reduced(get_config("qwen25-7b")), None, n_steps=12,
            seq=SEQ, pool=DictPool(), runner=disp, probe_steps=4)
    assert sched.n_probes == 1
    assert _executed_steps(sched) == 12
    assert sorted(sched.completed) == [0]


def _host_dispatcher_runner():
    return HostDispatcher([2], transport_factory=_fake_factory([]))


def test_runner_conformance_host_dispatcher():
    """The reference's Runner conformance case for ``HostDispatcher`` over
    the fake transport: the protocol's surface, records in virtual-start
    order, the pool drained back to its entry free count."""
    runner = _host_dispatcher_runner()
    try:
        assert isinstance(runner, Runner)
        assert hasattr(runner.executor, "run_segment")
        free0 = runner.device_pool.free
        n = 3
        segs = [JobSegment(job_id=i, config_ids=(i,), degree=1, start=float(i), end=i + 1.0,
                           start_steps=(0,), run_steps=2, done_ids=(i,), units=(0,))
                for i in range(n)]
        result = runner.run(segs, {i: _cfg(alpha=8.0 * (i + 1)) for i in range(n)},
                            {i: 2 for i in range(n)}, None, None, seq=SEQ, pool=DictPool())
        assert len(result.records) == n
        assert [tuple(r.job.config_ids) for r in result.records] == [(i,) for i in range(n)]
        assert result.makespan >= 0.0
        assert runner.device_pool.free == free0
    finally:
        runner.close()


# -- heartbeats, elastic membership, graceful drain --------------------------


def _state_spy(disp):
    """Record every membership transition deterministically (a sampler thread
    could miss a short-lived state)."""
    seen = []
    orig = disp._set_host_state

    def spy(host, state, **why):
        seen.append((host, state, why.get("reason")))
        orig(host, state, **why)

    disp._set_host_state = spy
    return seen


def test_heartbeat_pongs_keep_host_alive():
    made = []
    tracer = Tracer()
    with HostDispatcher([1], transport_factory=_fake_factory(made), tracer=tracer,
                        heartbeat_interval=0.02) as disp:
        disp.run([_seg(units=(0,))], {0: _cfg()}, {0: 3}, None, None, seq=SEQ, pool=DictPool())
        deadline = time.perf_counter() + 2.0
        while made[0].pings < 3 and time.perf_counter() < deadline:
            time.sleep(0.01)
    assert made[0].pings >= 3
    assert disp.host_state(0) == "ALIVE"
    assert disp.hosts_alive == 1
    assert disp.n_restarts == 0
    rtt = tracer.metrics.histogram("cluster.heartbeat_rtt").summary()
    assert rtt["count"] >= 3 and rtt["max"] < 2.0


def test_heartbeat_detects_hung_worker_and_recovers():
    """A worker that wedges mid-segment (silent, but the process stays
    alive) must not hang run(): the watchdog walks it ALIVE -> SUSPECT ->
    DEAD, fails the in-flight segment, and the restart path re-runs it on a
    fresh worker."""
    made = []
    factory = _fake_factory(made, {0: {"hang_on": lambda idx, payload: idx == 0}})
    with HostDispatcher([1], transport_factory=factory, heartbeat_interval=0.02,
                        heartbeat_timeout=0.04, heartbeat_dead_after=2) as disp:
        seen = _state_spy(disp)
        result = disp.run([_seg(units=(0,))], {0: _cfg()}, {0: 3}, None, None, seq=SEQ,
                          pool=DictPool())
    assert len(result.records) == 1
    assert len(made) == 2  # hung original + respawn
    assert made[0].error is None  # it wedged; it did not crash
    assert disp.n_restarts == 1  # died with a segment in flight
    reasons = {r for _, _, r in seen}
    assert {"heartbeat_timeout", "heartbeat_expired"} <= reasons
    states = [(h, s) for h, s, _ in seen]
    assert (0, "SUSPECT") in states and (0, "DEAD") in states
    assert states.index((0, "SUSPECT")) < states.index((0, "DEAD"))
    assert disp.host_state(0) == "ALIVE"  # respawn rejoined the fleet


def test_heartbeat_pong_recovers_suspect_host():
    """One late pong un-suspects a host (misses reset; no restart burned)."""
    with HostDispatcher([1], transport_factory=_fake_factory([])) as disp:
        disp.run([_seg(units=(0,))], {0: _cfg()}, {0: 3}, None, None, seq=SEQ, pool=DictPool())
        disp._set_host_state(0, "SUSPECT", reason="test")
        disp._hb_misses[0] = 2
        disp._on_pong(0, HealthReply(host=0, seq=7, t_send=time.perf_counter(), in_flight=0))
        assert disp.host_state(0) == "ALIVE"
        assert disp._hb_misses[0] == 0
    assert disp.n_restarts == 0


def test_heartbeat_idle_death_burns_no_restart_credit():
    """A worker dying *between* segments must not burn a ``max_restarts``
    credit; only in-flight deaths do."""
    made = []
    with HostDispatcher([1], transport_factory=_fake_factory(made), max_restarts=0) as disp:
        disp.run([_seg(units=(0,))], {0: _cfg()}, {0: 3}, None, None, seq=SEQ, pool=DictPool())
        disp.kill_host(0)  # idle: nothing in flight
        deadline = time.perf_counter() + 5.0
        while not disp._workers[0].dead and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert disp._workers[0].dead
        # with max_restarts=0 an (incorrectly) burned credit would raise
        result = disp.run([_seg(job_id=1, units=(0,), start=1.0)], {0: _cfg()}, {0: 3}, None,
                          None, seq=SEQ, pool=DictPool())
    assert disp.n_restarts == 0
    assert len(made) == 2  # respawned, just not *charged*
    assert len(result.records) == 1


def _adaptive_over(disp, arrivals, *, pool=None, probe_steps=4):
    eng = ExecutionEngine(_estimator(), disp.total_units, host_size=1)
    return eng.run_online_local(
        arrivals, reduced(get_config("qwen25-7b")), None, n_steps=max(a.steps for a in arrivals),
        seq=SEQ, pool=pool if pool is not None else DictPool(), runner=disp,
        probe_steps=probe_steps)


def _executed_steps(sched):
    return sum(min(sched.total_steps[cid] - s.start_steps[i], s.run_steps)
               for s in sched.segments for i, cid in enumerate(s.config_ids))


def test_elastic_join_mid_run_engine_replans_onto_new_host():
    """add_host() mid-run: the engine learns of the join through the
    membership feed and replans onto the new host's units -- both jobs
    finish their exact budgets, and the joiner really ran work."""
    made, box, joined = [], {}, []

    def on_run(idx, payload):
        if idx == 0 and not joined:  # first segment lands -> a host joins
            joined.append(box["disp"].add_host(1, host_class="fast"))

    def factory(host_id, n_devices):
        tr = FakeHostTransport(host_id, n_devices, real_time=True, iter_scale=0.02,
                               on_run=on_run if host_id == 0 else None)
        made.append(tr)
        return tr

    with HostDispatcher([1], transport_factory=factory) as disp:
        box["disp"] = disp
        # staggered so the jobs can't pack into one segment: the second
        # arrives while the first trains, after the join
        arrivals = [Arrival(0.0, _cfg(), 12), Arrival(0.05, _cfg(alpha=16.0), 12)]
        records, sched = _adaptive_over(disp, arrivals)
    assert joined == [1]
    assert disp.total_units == 2
    assert disp.host_classes == ("", "fast")
    assert sorted(sched.completed) == [0, 1]
    assert _executed_steps(sched) == 24
    assert {tr.host_id for tr in made if tr.runs} == {0, 1}  # the joiner executed segments


def test_graceful_drain_loses_zero_steps():
    """drain_host() mid-run: in-flight work finishes (checkpoints land
    through the normal success-atomic path), the residual migrates to the
    surviving host at the exact step count, and the drained host's units
    retire from the pool -- zero steps lost, zero double-run."""
    made, box, threads = [], {}, []

    def on_run(idx, payload):
        if idx == 0 and not threads:  # host 1's first segment is in flight
            t = threading.Thread(target=lambda: box["disp"].drain_host(1, timeout=30))
            t.start()
            threads.append(t)

    def factory(host_id, n_devices):
        tr = FakeHostTransport(host_id, n_devices, real_time=True, iter_scale=0.02,
                               on_run=on_run if host_id == 1 else None)
        made.append(tr)
        return tr

    pool = DictPool()
    with HostDispatcher([1, 1], transport_factory=factory) as disp:
        box["disp"] = disp
        arrivals = [Arrival(0.0, _cfg(), 12), Arrival(0.05, _cfg(alpha=16.0), 12)]
        records, sched = _adaptive_over(disp, arrivals, pool=pool)
        for t in threads:
            t.join(timeout=30)
    assert threads and not threads[0].is_alive()  # drain completed
    assert disp.host_state(1) == "DEAD"
    assert disp.device_pool.retired == (1,)
    assert sorted(sched.completed) == [0, 1]
    assert _executed_steps(sched) == 24  # nothing lost, nothing doubled
    tr1 = next(tr for tr in made if tr.host_id == 1)
    assert len(tr1.runs) == 1  # nothing dispatched after the drain announce
    resumed_on_0 = [aid for tr in made if tr.host_id == 0 for _, aid in tr.resumed]
    assert "0001" in resumed_on_0
    assert sorted(pool.adapters) == ["adapter_0000", "adapter_0001"]


def test_drain_mid_death_checkpoint_writes_atomic():
    """A host killed *mid-drain* (segment in flight) must leave the pool
    atomic -- the killed attempt's writes never half-apply, and the residual
    re-enters at the pre-drain step count."""
    made, box = [], {}

    def die1(idx, payload):
        if idx != 1:
            return False
        # the resumed continuation (start_steps=4) is in flight: start the
        # drain, let the announce land, then die silently (SIGKILL)
        t = threading.Thread(target=lambda: box["disp"].drain_host(0, timeout=60))
        t.start()
        box["drain"] = t
        time.sleep(0.05)
        return True

    def factory(host_id, n_devices):
        tr = FakeHostTransport(host_id, n_devices, die_on=die1)
        made.append(tr)
        return tr

    pool = DictPool()
    with HostDispatcher([1], transport_factory=factory) as disp:
        box["disp"] = disp
        records, sched = _adaptive_over(disp, [Arrival(0.0, _cfg(), 12)], pool=pool)
        box["drain"].join(timeout=60)
    assert not box["drain"].is_alive()
    assert disp.host_state(0) == "DEAD"
    assert disp.n_restarts == 1  # the mid-drain kill was in flight
    assert len(made) == 2
    assert pool.states["0000"][1]["steps_done"] == 4
    retry = made[1].runs[0]
    assert retry["seg"].start_steps == (4,)
    assert made[1].resumed == [(0, "0000")]
    assert _executed_steps(sched) == 12
    assert sorted(pool.adapters) == ["adapter_0000"]


def test_elastic_class_aware_unit_pick():
    """pick_class_units: wide jobs go to the fastest class, narrow jobs to
    the slowest, SUSPECT hosts are last resort -- and the reference's pick
    is the same on every case."""
    from repro.cluster.pool import pick_class_units as j_pick_class_units

    classes = {0: "fast", 1: "fast", 2: "slow"}
    ratios = {"fast": 1.0, "slow": 4.0}
    kw = dict(class_of_host=lambda h: classes[h], ratio_of_class=lambda c: ratios[c])
    free = [0, 1, 2, 3, 4, 5]  # hosts 0..2, 2 units each
    cases = [((free, 2, 2), {}), ((free, 1, 2), {}),
             ((free, 2, 2), {"avoid_host": lambda h: h == 0}), (([0], 2, 2), {})]
    got = [pick_class_units(*a, **kw, **extra) for a, extra in cases]
    assert got == [(0, 1), (4,), (2, 3), None]
    assert got == [j_pick_class_units(*a, **kw, **extra) for a, extra in cases]


# -- trace stitching ----------------------------------------------------------


def test_trace_ctx_rides_the_wire_and_worker_spans_stitch():
    tracer = Tracer()
    made = []
    cfgs = {i: _cfg(alpha=8.0 * (i + 1)) for i in range(4)}
    segs = [_seg(job_id=i, cids=(i,), units=(i,)) for i in range(4)]
    with HostDispatcher([2, 2], transport_factory=_fake_factory(made), tracer=tracer) as disp:
        result = disp.run(segs, cfgs, {i: 3 for i in range(4)}, None, None, seq=16,
                          pool=DictPool())
    assert len(result.records) == 4
    # every run request shipped a pickled TraceCtx of THIS trace
    ctxs = [c for trp in made for c in trp.trace_ctxs]
    assert len(ctxs) == 4
    for ctx in ctxs:
        assert isinstance(ctx, TraceCtx)
        assert ctx.trace_id == tracer.trace_id
        assert isinstance(ctx.parent, int)  # the dispatch span's id
    assert _wire(ctxs[0]) == ctxs[0]
    spans = tracer.spans()
    dispatch = {s.span_id: s for s in spans if s.name == "dispatch.segment"}
    assert len(dispatch) == 4
    hosts = [s for s in spans if s.cat == "host"]
    assert len(hosts) == 4
    for h in hosts:
        # stitched: the worker root's parent IS a dispatch span, and the
        # worker clock was rebased inside the dispatch window
        assert h.parent_id in dispatch
        d = dispatch[h.parent_id]
        assert h.track.startswith(f"host{d.args['host']}/")
        assert h.start >= d.start - 1e-6
    assert {h.name for h in hosts} == {"host0.segment", "host1.segment"}
    execs = [s for s in spans if s.name == "executor.segment"]
    assert len(execs) == 4
    host_ids = {h.span_id for h in hosts}
    assert all(e.parent_id in host_ids for e in execs)
    obj = tracer.to_chrome()
    assert validate_chrome_trace(obj) == []
    assert {"dispatch", "host", "executor", "runner"} <= set(trace_tiers(obj))


def test_untraced_dispatch_ships_no_ctx_or_spans():
    made = []
    with HostDispatcher([1], transport_factory=_fake_factory(made)) as disp:
        disp.run([_seg(job_id=0, cids=(0,), units=(0,))], {0: _cfg()}, {0: 3}, None, None,
                 seq=16, pool=DictPool())
    assert made[0].trace_ctxs == [None]


# ---------------------------------------------------------------------------
# Real worker processes on the CPU
# ---------------------------------------------------------------------------

CPU_THREADS = 2  # the in-process runs and the workers (they take this process's count)


def _grid4():
    return [_cfg(rank=8, alpha=8.0, lr=1e-3), _cfg(rank=8, alpha=16.0, lr=5e-4),
            _cfg(rank=16, alpha=16.0, lr=1e-3), _cfg(rank=16, alpha=32.0, lr=2e-4)]


def _two_jobs():
    """Two jobs of two adapters, one per host, both from t = 0."""
    return Schedule([ScheduledJob((0, 1), 1, 0.0, 1.0), ScheduledJob((2, 3), 1, 0.0, 1.0)],
                    1.0, 2)


def _losses(records):
    by = {}
    for r in records:
        for cid, loss in zip(r.job.config_ids, r.final_losses):
            by[cid] = loss
    return np.asarray([by[c] for c in sorted(by)])


def _pooled(pool, n):
    from repro_torch.tree import tree_leaves

    return [[np.asarray(a) for a in tree_leaves(pool.load_adapter(f"adapter_{i:04d}"))]
            for i in range(n)]


def _same_pooled(p, q):
    assert len(p) == len(q)
    for a, b in zip(p, q):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def _cm(cfg, base):
    """A cost model priced at the base's own storage (f32 on the CPU)."""
    from repro_torch.kernels.quant import base_storage

    return CostModel(cfg, A100_40G, base_dtype=base_storage(base))


def _in_process(cfg, base, grid, schedule, n_steps, pool, dev):
    cm = _cm(cfg, base)
    runner = ClusterRunner(SliceExecutor(), DevicePool([dev] * schedule.g), concurrent=False)
    recs, _ = ExecutionEngine(cm, schedule.g).run_local(
        schedule, grid, cfg, base, n_steps=n_steps, seq=SEQ, pool=pool, runner=runner)
    return _losses(recs)


def _killed_run(disp, cfg, base, grid, n_steps, pool):
    """Run one job on host 0 with a thread that SIGKILLs the worker once the
    segment is in flight; returns (losses, whether a kill landed mid-run)."""
    stop = threading.Event()

    def killer():
        while not stop.is_set():
            if disp.in_flight(0) > 0:
                time.sleep(0.05)
                if disp.in_flight(0) > 0 and not stop.is_set():
                    disp.kill_host(0)
                return
            time.sleep(0.005)

    restarts0 = disp.n_restarts
    th = threading.Thread(target=killer)
    th.start()
    try:
        recs, _ = ExecutionEngine(_cm(cfg, base), disp.total_units, host_size=1).run_local(
            Schedule([ScheduledJob((0,), 1, 0.0, 1.0)], 1.0, disp.total_units), grid, cfg, base,
            n_steps=n_steps, seq=SEQ, pool=pool, runner=disp)
    finally:
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive()
    return _losses(recs), disp.n_restarts > restarts0


@pytest.fixture(scope="module")
def cpu_world():
    """Reduced qwen25-7b's f32 base on the CPU, this module's thread count,
    and one two-host CPU dispatcher the real-process cases share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(CPU_THREADS)
    cfg = reduced(get_config("qwen25-7b"))
    base, _ = init_model(0, cfg, pack_meta(_grid4()), device=CPU)
    disp = HostDispatcher([1, 1], device="cpu", heartbeat_interval=0.5)
    try:
        yield cfg, base, disp
    finally:
        disp.close()
        torch.set_num_threads(threads)


def test_two_cpu_hosts_equal_in_process_bitwise(cpu_world, tmp_path):
    """Two jobs of two adapters on two spawned CPU workers: losses and pooled
    adapters equal the in-process run's bit for bit, and the hosts ran at
    once."""
    cfg, base, disp = cpu_world
    grid = _grid4()
    ref_pool = CheckpointPool(str(tmp_path / "ref"))
    ref = _in_process(cfg, base, grid, _two_jobs(), 3, ref_pool, CPU)
    pool = CheckpointPool(str(tmp_path / "mh"))
    recs, _ = ExecutionEngine(_cm(cfg, base), 2, host_size=1).run_local(
        _two_jobs(), grid, cfg, base, n_steps=3, seq=SEQ, pool=pool, runner=disp)
    out = _losses(recs)
    assert np.isfinite(ref).all()
    assert ref.tobytes() == out.tobytes()
    _same_pooled(_pooled(pool, 4), _pooled(ref_pool, 4))
    assert disp.last_result.max_overlap() >= 2
    assert [disp.host_state(h) for h in (0, 1)] == ["ALIVE", "ALIVE"]
    for h in (0, 1):
        st = disp.host_stats[h]
        assert st["spawns"] >= 1 and st["spawn_s"] > 0 and st["init_bytes"] > 0
        assert st["init_s"] >= 0 and st["peak_bytes"] is None  # the CPU has no peak


def test_sigkill_mid_segment_recovers_bitwise(cpu_world, tmp_path):
    """A SIGKILL of host 0's worker while its segment is in flight: the
    segment re-runs on a fresh worker from the unchanged pool, its losses
    equal the unkilled in-process run's bit for bit, and the adapter's
    budget is exact."""
    cfg, base, disp = cpu_world
    grid, n_steps = [_cfg()], 12
    ref = _in_process(cfg, base, grid, Schedule([ScheduledJob((0,), 1, 0.0, 1.0)], 1.0, 1),
                      n_steps, None, CPU)
    for attempt in range(3):  # a warm segment may finish before the kill lands
        pool = CheckpointPool(str(tmp_path / f"pool{attempt}"))
        out, killed = _killed_run(disp, cfg, base, grid, n_steps, pool)
        assert ref.tobytes() == out.tobytes()  # holds killed or not
        if killed:
            break
    assert killed
    meta = pool.load_meta("adapter_0000")
    assert meta["total_steps"] == n_steps and np.isfinite(meta["final_loss"])


def test_worker_asked_for_cuda_without_one_fails_with_its_message():
    """A worker on ``cuda`` where this machine has none reports ``fatal``,
    and the dispatcher raises ``TransportError`` with the worker's message:
    it never trains on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with HostDispatcher([1], device="cuda") as disp:
        assert disp.host_device(0) == "cuda:0"
        with pytest.raises(TransportError, match="sees no CUDA device"):
            disp.run([_seg(units=(0,), run_steps=1)], {0: _cfg()}, {0: 1},
                     reduced(get_config("qwen25-7b")), None, seq=SEQ)


# ---------------------------------------------------------------------------
# The launcher's --hosts flags
# ---------------------------------------------------------------------------


def test_launcher_hosts(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    pool = tmp_path / "pool"
    launch_train.main(["--reduced", "--device", "cpu", "--hosts", "2", "--steps", "2",
                       "--log-every", "0", "--pool", str(pool)])
    out = capsys.readouterr().out
    assert "multi-host plan:" in out and "0 worker restart(s)" in out
    p = CheckpointPool(str(pool))
    assert sorted(p.list()) == ["adapter_0000", "adapter_0001"]
    assert all(p.load_meta(a)["total_steps"] == 2 for a in p.list())


def test_launcher_hosts_drain_and_join(tmp_path, capsys):
    """``--heartbeat`` with ``--drain-after`` and ``--join-after`` (the
    adaptive loop): the drained host reads DEAD, the joined host appears,
    and every adapter reaches its budget."""
    from repro_torch.launch import train as launch_train

    pool = tmp_path / "pool"
    launch_train.main(["--reduced", "--device", "cpu", "--hosts", "2", "--steps", "6",
                       "--log-every", "0", "--heartbeat", "0.5", "--drain-after", "0.3",
                       "--join-after", "0.3", "--pool", str(pool)])
    out = capsys.readouterr().out
    assert "multi-host plan:" in out
    (line,) = [ln for ln in out.splitlines() if ln.startswith("membership:")]
    assert "host1=DEAD" in line and "host2=" in line
    p = CheckpointPool(str(pool))
    assert sorted(p.list()) == ["adapter_0000", "adapter_0001"]
    assert all(p.load_meta(a)["total_steps"] == 6 for a in p.list())


@pytest.mark.parametrize("argv, match", [
    (["--hosts", "2", "--devices-per-host", "2"], "wider than one device"),
    (["--hosts", "2", "--mesh", "2x1"], "not ported"),
    (["--hosts", "2", "--save-state", "--pool", "p"], "incompatible"),
    (["--heartbeat", "0.5"], "need the dispatch tier"),
    (["--hosts", "2", "--host-classes", "a"], "names 1 class"),
])
def test_launcher_hosts_refusals(argv, match, capsys):
    from repro_torch.launch import train as launch_train

    with pytest.raises(SystemExit):
        launch_train.main(["--reduced", "--device", "cpu"] + argv)
    assert match in capsys.readouterr().err


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the workers run on the card")
    return torch.device("cuda", 0)


def _gpu_world(dev):
    cfg = reduced(get_config("qwen25-7b"))
    base, _ = init_model(0, cfg, pack_meta(_grid4()), device=dev, dtype=torch.bfloat16)
    return cfg, base


@pytest.mark.gpu
def test_gpu_two_hosts_and_kill_equal_in_process(cuda, tmp_path):
    """Two workers on the card (sharing it with this process): two jobs of
    two adapters equal the in-process run's losses and pooled adapters bit
    for bit; then a SIGKILL of host 0 mid-segment recovers bit for bit with
    an exact budget; ``close()`` gives the workers' memory back."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, base = _gpu_world(cuda)
    grid = _grid4()
    ref_pool = CheckpointPool(str(tmp_path / "ref"))
    ref = _in_process(cfg, base, grid, _two_jobs(), 4, ref_pool, cuda)
    kill_ref = _in_process(cfg, base, [_cfg()], Schedule([ScheduledJob((0,), 1, 0.0, 1.0)], 1.0,
                                                         1), 12, None, cuda)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    used0 = torch.cuda.mem_get_info(cuda)
    with HostDispatcher([1, 1], heartbeat_interval=1.0) as disp:
        assert disp.host_device(1) == f"cuda:{1 % torch.cuda.device_count()}"
        pool = CheckpointPool(str(tmp_path / "mh"))
        recs, _ = ExecutionEngine(_cm(cfg, base), 2, host_size=1).run_local(
            _two_jobs(), grid, cfg, base, n_steps=4, seq=SEQ, pool=pool, runner=disp)
        assert _losses(recs).tobytes() == ref.tobytes()
        _same_pooled(_pooled(pool, 4), _pooled(ref_pool, 4))
        assert disp.last_result.max_overlap() >= 2
        assert all(rec.captured and rec.peak_bytes > 0 for rec in recs)
        for attempt in range(3):
            kpool = CheckpointPool(str(tmp_path / f"kill{attempt}"))
            out, killed = _killed_run(disp, cfg, base, [_cfg()], 12, kpool)
            assert out.tobytes() == kill_ref.tobytes()
            if killed:
                break
        assert killed
        assert kpool.load_meta("adapter_0000")["total_steps"] == 12
    deadline = time.perf_counter() + 20
    while time.perf_counter() < deadline:
        if torch.cuda.mem_get_info(cuda)[0] >= used0[0] - 64 * 2**20:
            break
        time.sleep(0.2)
    assert torch.cuda.mem_get_info(cuda)[0] >= used0[0] - 64 * 2**20
