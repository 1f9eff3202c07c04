"""The port's online and adaptive engine against the JAX package's, on the CPU.

``poisson_trace`` makes the same arrival times bit for bit; ``plan_online``
(pure Python on both sides) makes the same segments, makespan, completion
times and counts over repack and admission policies, migration budgets, pool
sizes and host widths, on the full qwen25-7b with the reference's memory
accounting; ``OnlineSchedule.validate``/``utilization`` agree, errors
included. The adaptive loop runs against a scripted executor defined here.
A reduced real run with a preemption agrees with the reference's
per-adapter losses within rtol 5e-3 / atol 1e-3 (the tolerance of
``tests/test_torch_engine.py``: two frameworks' f32 matmuls through 2
layers, amplified by Adam's m/sqrt(v)), its adapters' updates within
UPDATE_RTOL of the reference's, and the preempted adapter's state file
cross-loads between the packages. The chip smoke's online trace plans a
migration with every job under the load factor on the port's own memory
accounting.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import LoraConfig as JLoraConfig
from repro.configs.base import default_search_space as j_space
from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.core.adapter import pack_meta as j_pack_meta
from repro.models.model import init_model as j_init_model
from repro.sched import cost_model as jcm
from repro.sched.engine import Arrival as JArrival
from repro.sched.engine import ExecutionEngine as JEngine
from repro.sched.engine import JobSegment as JJobSegment
from repro.sched.engine import OnlineSchedule as JOnlineSchedule
from repro.sched.engine import poisson_trace as j_poisson_trace
from repro.sched.profile import ProfiledCostModel as JProfiled
from repro.train.checkpoint import CheckpointPool as JCheckpointPool
from repro_torch import bridge
from repro_torch.cluster import ClusterRunner, DevicePool, SliceExecutor
from repro_torch.configs import LoraConfig, default_search_space, get_config, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.core.packed_lora import extract_adapter
from repro_torch.sched import cost_model as tcm
from repro_torch.sched import plan
from repro_torch.sched.engine import (
    Arrival,
    ExecutionEngine,
    JobRecord,
    JobSegment,
    OnlineSchedule,
    poisson_trace,
)
from repro_torch.sched.planner import ScheduledJob
from repro_torch.sched.profile import ProfiledCostModel
from repro_torch.train.checkpoint import CheckpointPool
from repro_torch.tree import tree_map

CPU = torch.device("cpu")
SEQ = 1024
STEPS = 1000


def _models(hw="A100_40G"):
    """The reference's cost model and the port's with the reference's memory
    accounting, on the full qwen25-7b."""
    return (jcm.CostModel(j_get_config("qwen25-7b"), getattr(jcm, hw)),
            tcm.CostModel(get_config("qwen25-7b"), getattr(tcm, hw), **tcm.REFERENCE_MEMORY))


def _mixed_traces(n=16, mean_interarrival=800.0):
    """tests/test_online_engine.py's heterogeneous-residual Poisson workload,
    on both sides."""
    steps = np.random.RandomState(0).choice([200, 500, 1000, 2000, 4000], size=n)
    return (j_poisson_trace(j_space(n, SEQ), mean_interarrival, seed=1, steps=steps),
            poisson_trace(default_search_space(n, SEQ), mean_interarrival, seed=1, steps=steps))


def _segs(sched):
    return [dataclasses.astuple(s) for s in sched.segments]


def _same(port, ref):
    assert _segs(port) == _segs(ref)
    assert port.makespan == ref.makespan
    assert port.completed == ref.completed
    assert port.total_steps == ref.total_steps
    assert ((port.n_repacks, port.n_migrations, port.n_f_calls)
            == (ref.n_repacks, ref.n_migrations, ref.n_f_calls))


def _executed(sched):
    """Steps each config trains over the segments."""
    done = {cid: 0 for cid in sched.total_steps}
    for seg in sched.segments:
        for cid, st0 in zip(seg.config_ids, seg.start_steps):
            done[cid] += min(sched.total_steps[cid] - st0, seg.run_steps)
    return done


@pytest.mark.parametrize("mean", [50.0, 800.0, 5000.0])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_poisson_trace_matches_reference(seed, mean):
    steps = list(range(3, 15))
    jt = j_poisson_trace(j_space(12, SEQ), mean, seed=seed, steps=steps)
    tt = poisson_trace(default_search_space(12, SEQ), mean, seed=seed, steps=steps)
    assert [a.time for a in tt] == [a.time for a in jt]
    assert [(a.steps, a.config.key()) for a in tt] == [(a.steps, a.config.key()) for a in jt]
    assert all(a.steps is None for a in poisson_trace(default_search_space(3, SEQ), mean, seed))


PLAN_CASES = [
    (repack, admission, budget, g, host_size)
    for repack in ("event", "drain")
    for admission in ("patient", "eager")
    for budget in (0, 1, 2)
    for g in (1, 8)
    for host_size in (None, 2)
    if host_size is None or g % host_size == 0  # host_size must divide g
]


@pytest.mark.parametrize("repack,admission,budget,g,host_size", PLAN_CASES)
def test_plan_online_matches_reference(repack, admission, budget, g, host_size):
    jt, tt = _mixed_traces()
    jm, tm = _models()
    kw = dict(repack=repack, admission=admission, migration_budget=budget)
    ref = JEngine(jm, g, host_size=host_size).plan_online(jt, SEQ, STEPS, **kw)
    eng = ExecutionEngine(tm, g, host_size=host_size)
    port = eng.plan_online(tt, SEQ, STEPS, **kw)
    _same(port, ref)
    # the reference's own invariants, held inside the port
    assert _segs(eng.simulate_online(tt, SEQ, STEPS, **kw)) == _segs(port)  # deterministic
    port.validate(host_size=host_size)
    assert _executed(port) == port.total_steps
    assert sorted(port.completed) == list(range(len(tt)))
    assert port.makespan >= max(port.completed.values())
    assert port.n_migrations <= budget
    assert any(s.preempted for s in port.segments) == (port.n_migrations > 0)
    assert 0.0 < port.utilization() <= 1.0


# tests/test_online_engine.py's claims, each a case of one test
CLAIMS = ["t0_eager_is_plan", "repack_beats_drain", "migration_beneficial", "budget_capped"]


@pytest.mark.parametrize("claim", CLAIMS)
def test_online_claims_hold_in_the_port(claim):
    _, tm = _models()
    eng = ExecutionEngine(tm, 8)
    if claim == "t0_eager_is_plan":
        configs = default_search_space(24, SEQ)
        online = eng.plan_online([Arrival(0.0, c) for c in configs], SEQ, 100,
                                 admission="eager")
        assert online.makespan == pytest.approx(plan(tm, configs, 8, SEQ, 100).makespan,
                                                rel=1e-9)
        assert sorted(online.completed) == list(range(24))
        return
    _, tt = _mixed_traces()
    if claim == "repack_beats_drain":
        ev = eng.plan_online(tt, SEQ, STEPS, repack="event")
        dr = eng.plan_online(tt, SEQ, STEPS, repack="drain")
        assert ev.makespan <= dr.makespan
        return
    no_mig = eng.plan_online(tt, SEQ, STEPS, migration_budget=0)
    mig = eng.plan_online(tt, SEQ, STEPS, migration_budget=4)
    assert not any(s.preempted for s in no_mig.segments)
    if claim == "migration_beneficial":
        assert mig.n_migrations >= 1 and mig.makespan < no_mig.makespan
    else:
        assert 1 <= mig.n_migrations <= 4 and _executed(mig) == mig.total_steps


def _seg_pair(job_id, cids, degree, start, end, units, preempted=False):
    kw = dict(job_id=job_id, config_ids=cids, degree=degree, start=start, end=end,
              start_steps=(0,) * len(cids), run_steps=1, done_ids=cids, preempted=preempted,
              units=units)
    return JJobSegment(**kw), JobSegment(**kw)


# (segments as (job_id, cids, degree, start, end, units), g, host_size)
SCHEDULES = {
    "ok": ([(0, (0,), 2, 0.0, 4.0, (0, 1)), (1, (1,), 2, 0.0, 2.0, (2, 3)),
            (2, (2,), 4, 4.0, 6.0, (0, 1, 2, 3))], 4, 2),
    "oversubscribed": ([(0, (0,), 4, 0.0, 4.0, ()), (1, (1,), 2, 1.0, 2.0, ())], 4, None),
    "wrong_width": ([(0, (0,), 2, 0.0, 1.0, (0,))], 4, None),
    "out_of_range": ([(0, (0,), 1, 0.0, 1.0, (4,))], 4, None),
    "spans_hosts": ([(0, (0,), 2, 0.0, 1.0, (1, 2))], 4, 2),
    "shared_units": ([(0, (0,), 1, 0.0, 2.0, (1,)), (1, (1,), 1, 1.0, 3.0, (1,))], 4, None),
    "empty": ([], 4, None),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_online_schedule_validate_and_utilization_match_reference(case):
    rows, g, host_size = SCHEDULES[case]
    pairs = [_seg_pair(*r) for r in rows]
    makespan = max((r[4] for r in rows), default=0.0)
    ref = JOnlineSchedule([j for j, _ in pairs], makespan, g, {}, {})
    port = OnlineSchedule([t for _, t in pairs], makespan, g, {}, {})
    assert port.utilization() == ref.utilization()
    try:
        ref.validate(host_size=host_size)
        err = None
    except RuntimeError as e:
        err = str(e)
    if err is None:
        port.validate(host_size=host_size)
        assert case in ("ok", "empty")
    else:
        with pytest.raises(RuntimeError) as info:
            port.validate(host_size=host_size)
        assert str(info.value) == err


def test_unschedulable_trace_and_bad_host_sizes_raise():
    jm, tm = _models("TPU_V5E")  # a 15 GB bf16 base does not fit a 16 GB unit
    trace = [Arrival(0.0, LoraConfig(rank=8, alpha=8.0, seq_len=SEQ))]
    jtrace = [JArrival(0.0, JLoraConfig(rank=8, alpha=8.0, seq_len=SEQ))]
    for cm in (tm, tcm.CostModel(get_config("qwen25-7b"), tcm.TPU_V5E)):
        with pytest.raises(RuntimeError, match="never be scheduled") as info:
            ExecutionEngine(cm, 1).plan_online(trace, SEQ, 10)
    with pytest.raises(RuntimeError) as ref:
        JEngine(jm, 1).plan_online(jtrace, SEQ, 10)
    assert str(info.value) == str(ref.value)
    for g, hs in ((8, 3), (6, 3), (4, 0)):
        with pytest.raises(ValueError):
            ExecutionEngine(tm, g, host_size=hs)
        with pytest.raises(ValueError):
            JEngine(jm, g, host_size=hs)
    for bad in (dict(repack="sometimes"), dict(admission="lazy")):
        with pytest.raises(ValueError):
            ExecutionEngine(tm, 1).plan_online(trace, SEQ, 10, **bad)


# ---------------------------------------------------------------------------
# the adaptive loop, against a scripted executor
# ---------------------------------------------------------------------------

ASEQ = 64


class ScriptedExecutor:
    """``SliceExecutor.run_segment`` stand-in: no training, a wall time of
    ``slow`` x the prior's iteration time per step. Records each call as
    ``(config_ids, units, run_steps)``."""

    def __init__(self, prior, slow: float = 1.0):
        self.prior, self.slow, self.calls = prior, slow, []

    def pack_template(self, cfg, configs, seed=0, device=None):
        return None

    def run_segment(self, seg, configs_by_cid, total_steps, cfg, base, *, seq, pool,
                    data_iter_fn=None, seed=0, slice_=None, impl=None, remat=None,
                    base_dtype=None):
        self.calls.append((seg.config_ids, seg.units, seg.run_steps))
        sel = [configs_by_cid[c] for c in seg.config_ids]
        per_step = self.slow * self.prior.iter_time(sel, seg.degree, seq)
        return JobRecord(ScheduledJob(seg.config_ids, seg.degree, seg.start, seg.end),
                         per_step * seg.run_steps)


class FakeRunner:
    """The runner surface the adaptive loop reads: a scripted executor over
    a pool of plain tokens, run inline."""

    def __init__(self, executor, n_units: int):
        self.executor = executor
        self.device_pool = DevicePool([f"fake{i}" for i in range(n_units)])
        self.concurrent = False


class NoPool:
    """Placeholder checkpoint pool: the scripted executor never touches it."""


def _prior():
    cm = tcm.CostModel(get_config("qwen25-7b"), tcm.A100_40G)
    cm.setup_time = 0.0
    return cm


def _acfg(rank=8, alpha=8.0, bs=1):
    return LoraConfig(rank=rank, alpha=alpha, learning_rate=1e-3, batch_size=bs, seq_len=ASEQ)


def _adaptive(trace, slow, steps=20, probe_steps=4):
    est = ProfiledCostModel(_prior(), drift_threshold=0.5)
    fake = ScriptedExecutor(_prior(), slow=slow)
    records, sched = ExecutionEngine(est, 1).run_online_local(
        trace, reduced(get_config("qwen25-7b")), None, n_steps=steps, seq=ASEQ,
        pool=NoPool(), runner=FakeRunner(fake, 1), probe_steps=probe_steps)
    assert len(records) == len(sched.segments) == len(sched.timings)
    assert _executed(sched) == sched.total_steps
    return est, fake, sched


ADAPTIVE = ["drift_reassigns_once", "within_threshold_continues", "observed_key_skips_probe",
            "simulation_stays_on_prior"]


@pytest.mark.parametrize("case", ADAPTIVE)
def test_adaptive_loop(case):
    if case == "drift_reassigns_once":
        # a 3x-slow executor: the probe measures the drift and the residual
        # is re-planned once, priced at the measured rate
        _, _, sched = _adaptive([Arrival(0.0, _acfg(), 20)], slow=3.0)
        assert (sched.n_probes, sched.n_reassignments, len(sched.segments)) == (1, 1, 2)
        assert sched.segments[0].preempted and not sched.segments[1].preempted
        assert sorted(sched.completed) == [0]
        assert sched.timings[1].predicted_iter == pytest.approx(
            3.0 * sched.timings[0].predicted_iter, rel=1e-6)
        assert sched.timings[0].drift == pytest.approx(2.0)
    elif case == "within_threshold_continues":
        _, fake, sched = _adaptive([Arrival(0.0, _acfg(), 20)], slow=1.05)
        assert (sched.n_probes, sched.n_reassignments, len(sched.segments)) == (1, 0, 2)
        assert sched.segments[0].units == sched.segments[1].units
        assert [c[2] for c in fake.calls] == [4, 16]
    elif case == "observed_key_skips_probe":
        # the second config arrives after the first finished: same shape, so
        # it is not probed again and runs its steps in one segment
        trace = [Arrival(0.0, _acfg(), 20), Arrival(0.1, _acfg(alpha=9.0), 20)]
        est, _, sched = _adaptive(trace, slow=1.0)
        assert sched.n_probes == 1 and sorted(sched.completed) == [0, 1]
        per_cid = {}
        for s in sched.segments:
            per_cid.setdefault(s.config_ids[0], []).append(s.run_steps)
        assert sorted(len(v) for v in per_cid.values()) == [1, 2]
        assert est.observed([_acfg()], 1, ASEQ)
    else:
        # plan_online through a profiled estimator is the prior's plan,
        # whatever the store holds, and the reference's
        prior, jprior = _models()[1], _models()[0]
        est, jest = ProfiledCostModel(prior), JProfiled(jprior)
        jt, tt = _mixed_traces(12, 600.0)
        ref = JEngine(jprior, 8).plan_online(jt, SEQ, STEPS)
        before = ExecutionEngine(est, 8).plan_online(tt, SEQ, STEPS)
        for c, jc in zip(default_search_space(4, SEQ), j_space(4, SEQ)):
            for e, cc in ((est, c), (jest, jc)):
                e.observe([cc], 1, SEQ, 123.456)
                e.observe([cc], 4, SEQ, 0.001)
        after = ExecutionEngine(est, 8).plan_online(tt, SEQ, STEPS)
        _same(before, ref)
        _same(after, JEngine(jest, 8).plan_online(jt, SEQ, STEPS))
        _same(after, before)


def test_adaptive_unschedulable_raises():
    est = ProfiledCostModel(tcm.CostModel(get_config("qwen25-7b"), tcm.TPU_V5E))
    with pytest.raises(RuntimeError, match="never be scheduled"):
        ExecutionEngine(est, 1).run_online_local(
            [Arrival(0.0, LoraConfig(rank=8, alpha=8.0, seq_len=SEQ), 5)],
            get_config("qwen25-7b"), None, n_steps=5, seq=SEQ, pool=NoPool(),
            runner=FakeRunner(ScriptedExecutor(est.prior), 1))


# ---------------------------------------------------------------------------
# real execution at the reduced size, with a preemption, on both packages
# ---------------------------------------------------------------------------

RSEQ = 16
A = dict(rank=8, alpha=8.0, learning_rate=1e-3, batch_size=1, seq_len=RSEQ)
B = dict(rank=16, alpha=16.0, learning_rate=5e-4, batch_size=1, seq_len=RSEQ)


def _ref_lora_init(jcfg):
    def init(cfg, meta, seed):
        jmeta = j_pack_meta([JLoraConfig(rank=r) for r in meta.ranks])
        return jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(seed), jcfg, jmeta)[1])
    return init


def _leaves(tree):
    if isinstance(tree, dict):
        return [(k + "/" + p, v) for k, sub in sorted(tree.items()) for p, v in _leaves(sub)]
    return [("", np.asarray(tree, np.float32))]


# ||w - w_ref|| / ||w_ref - w0|| over an adapter's leaves: how far its
# update lies from the reference's, relative to that update. Adam moves an
# element by about the learning rate a step whatever its gradient, so where
# gradient noise near zero flips a step's sign the two packages' elements
# differ by a few steps (8 of 4,096 elements lie outside rtol 5e-3 / atol
# 1e-3 here); over the whole update the packages read 0.008 (final adapters)
# and 0.014 (the preempted adapter's state), and a resume that drops the
# Adam moments reads 0.49, one that skips the data already seen 0.72, one
# from the template 25.
UPDATE_RTOL = 0.05


def _update_err(a, b, w0):
    la, lb, l0 = _leaves(a), _leaves(b), _leaves(w0)
    assert [k for k, _ in la] == [k for k, _ in lb] == [k for k, _ in l0] and la
    diff = sum(float(np.sum((x - y) ** 2)) for (_, x), (_, y) in zip(la, lb))
    update = sum(float(np.sum((y - z) ** 2)) for (_, y), (_, z) in zip(lb, l0))
    return math.sqrt(diff / update)


def _initial_adapters(sched, configs, lora_init, cfg):
    """Each config's initial weights: its slot of the template of the first
    segment that trains it from step 0 (both packages' templates are the
    reference's ``init_model``)."""
    out = {}
    for seg in sched.segments:
        meta = pack_meta([configs[c] for c in seg.config_ids])
        for slot, (cid, st0) in enumerate(zip(seg.config_ids, seg.start_steps)):
            if st0 == 0 and cid not in out:
                out[cid] = extract_adapter(lora_init(cfg, meta, 0), slot, meta.ranks)
    return out


def test_run_online_local_preempt_resume_matches_reference(tmp_path):
    """The reference's ``test_run_online_local_preempt_resume`` on both
    packages: the same trace, base weights and data stream; the running
    pack is preempted by an arrival, its adapter resumes through the pool
    in a new pack, and every adapter finishes its exact step budget."""
    jcfg, cfg = j_reduced(j_get_config("qwen25-7b")), reduced(get_config("qwen25-7b"))
    # the reference's f32 tree, priced as "f32" (the port's engine refuses a
    # tree its model prices at another size)
    jcost = jcm.CostModel(jcfg, jcm.A100_40G)
    cost = tcm.CostModel(cfg, tcm.A100_40G, base_dtype="f32")
    jcost.setup_time = cost.setup_time = 0.0
    ja, jb, a, b = JLoraConfig(**A), JLoraConfig(**B), LoraConfig(**A), LoraConfig(**B)
    it = cost.iter_time([a], 1, RSEQ)
    assert it == jcost.iter_time([ja], 1, RSEQ)
    jtrace = [JArrival(0.0, ja, 6), JArrival(2.5 * it, jb, 5)]
    trace = [Arrival(0.0, a, 6), Arrival(2.5 * it, b, 5)]
    jbase, _ = j_init_model(jax.random.PRNGKey(0), jcfg, j_pack_meta([ja]))
    kw = dict(n_steps=6, seq=RSEQ, migration_budget=1, preempt_min_remaining=0.0)
    jpool = JCheckpointPool(str(tmp_path / "ref"))
    jrecs, jsched = JEngine(jcost, 1).run_online_local(jtrace, jcfg, jbase, pool=jpool, **kw)
    pool = CheckpointPool(str(tmp_path / "port"))
    lora_init = _ref_lora_init(jcfg)
    runner = ClusterRunner(SliceExecutor(lora_init=lora_init), DevicePool([CPU]))
    base = bridge.to_torch(jax.tree.map(np.asarray, jbase), CPU)
    eng = ExecutionEngine(cost, 1)
    with pytest.raises(ValueError, match="no CheckpointPool"):
        eng.run_online_local(trace, cfg, base, runner=runner, **kw)
    recs, sched = eng.run_online_local(trace, cfg, base, pool=pool, runner=runner, **kw)
    w0 = _initial_adapters(sched, [a, b], lora_init, cfg)
    # the repaired memory accounting plans as the reference's here
    _same(sched, jsched)
    assert sched.n_migrations == 1 and any(s.preempted for s in sched.segments)
    assert _executed(sched) == {0: 6, 1: 5}
    assert len(recs) == len(jrecs) == len(sched.segments)
    for r, jr in zip(recs, jrecs):
        assert r.job.config_ids == jr.job.config_ids
        np.testing.assert_allclose(r.final_losses, jr.final_losses, rtol=5e-3, atol=1e-3)
    assert pool.list() == jpool.list() == ["adapter_0000", "adapter_0001"]
    for name in pool.list():
        meta, jmeta = pool.load_meta(name), jpool.load_meta(name)
        assert meta["total_steps"] == jmeta["total_steps"]
        assert math.isfinite(meta["final_loss"])
        np.testing.assert_allclose(meta["final_loss"], jmeta["final_loss"], rtol=5e-3, atol=1e-3)
        assert _update_err(pool.load_adapter(name),
                           jax.tree.map(np.asarray, jpool.load_adapter(name)),
                           w0[int(name[-4:])]) <= UPDATE_RTOL
    # the preempted adapter's state: the same step, and each package reads
    # the other's file
    state, smeta = pool.load_adapter_state("0000")
    jstate, jsmeta = jpool.load_adapter_state("0000")
    assert 0 < smeta["steps_done"] == jsmeta["steps_done"] < 6
    cross = JCheckpointPool(str(tmp_path / "port")).load_adapter_state("0000")
    back = CheckpointPool(str(tmp_path / "ref")).load_adapter_state("0000")
    assert cross[1] == smeta and back[1] == jsmeta
    assert _update_err(jax.tree.map(np.asarray, cross[0])["w"],
                       jax.tree.map(np.asarray, jstate)["w"], w0[0]) <= UPDATE_RTOL
    assert _update_err(back[0]["w"], state["w"], w0[0]) <= UPDATE_RTOL
    assert all(np.array_equal(x, y) for (_, x), (_, y)
               in zip(_leaves(cross[0]), _leaves(state)))
    # the same run with the resume dropping the preempted adapter's Adam
    # moments (weights and data kept): its final update lies far outside
    # UPDATE_RTOL of the reference's
    faulty = SliceExecutor(lora_init=lora_init)
    resume = faulty._resume

    def no_moments(*args):
        lora, opt = resume(*args)
        if opt is not None:
            opt = dict(opt, m=tree_map(lambda t: t * 0, opt["m"]),
                       v=tree_map(lambda t: t * 0, opt["v"]))
        return lora, opt

    faulty._resume = no_moments
    fpool = CheckpointPool(str(tmp_path / "faulty"))
    eng.run_online_local(trace, cfg, base, pool=fpool, runner=ClusterRunner(
        faulty, DevicePool([CPU])), **kw)
    assert _update_err(fpool.load_adapter("adapter_0000"),
                       jax.tree.map(np.asarray, jpool.load_adapter("adapter_0000")),
                       w0[0]) > 5 * UPDATE_RTOL


# ---------------------------------------------------------------------------
# the chip smoke's online trace, planned here (pure Python)
# ---------------------------------------------------------------------------


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_online_trace_plans_a_migration_that_fits():
    smoke = _smoke()
    on = smoke.online_plan()
    cm, sched = on.cm, on.sched
    assert sched.n_migrations >= 1 and any(s.preempted for s in sched.segments)
    assert _executed(sched) == sched.total_steps
    cap = cm.load_factor * cm.hw.mem_bytes
    jobs = [[on.configs[c] for c in s.config_ids] for s in sched.segments]
    assert all(cm.job_mem_bytes(jc, 1, smoke.ONLINE_SEQ) <= cap for jc in jobs)
    assert any(sum(c.batch_size == 8 for c in jc) >= 1 for jc in jobs)
    sizes = {c.batch_size for c in on.configs}
    ranks = [c.rank for c in on.configs]
    assert sum(c.batch_size == 8 for c in on.configs) >= 2 and 128 in ranks
    assert min(ranks) <= 16 and 6 <= len(on.configs) <= 8 and 8 in sizes
    assert all(6 <= a.steps <= 8 for a in on.trace)
    # the reference's accounting, on the same trace, packs a job the port's
    # accounting prices above what it allows
    assert on.reference["largest_rows"] >= max(
        len(jc) * max(c.batch_size for c in jc) for jc in jobs)
