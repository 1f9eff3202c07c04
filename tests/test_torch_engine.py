"""The port's static execution engine, end to end on the CPU.

``run_local`` on the reduced qwen25-7b against the reference's: the same
schedule, per-adapter final losses and pool adapters within rtol 5e-3 /
atol 1e-3 (as ``tests/test_torch_train.py``'s trajectories: two frameworks'
f32 matmuls through 2 layers, amplified by Adam's m/sqrt(v) on near-zero
gradients). The base is carried across and the LoRA init comes from the
reference through the executor's ``lora_init``. Inside the port, bit for
bit: a segmented run (budgets, then a resume through the checkpoint pool)
equals the unbroken one, two CPU "devices" run concurrently equal the
sequential run, and the launcher's ``--save-state`` then ``--resume-state``
equals an unbroken run.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import LoraConfig as JLoraConfig
from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.core.adapter import pack_meta as j_pack_meta
from repro.models.model import init_model as j_init_model
from repro.sched.cost_model import A100_40G as J_A100
from repro.sched.cost_model import CostModel as JCostModel
from repro.sched.engine import ExecutionEngine as JEngine
from repro.sched.engine import JobRecord as JJobRecord
from repro.sched.engine import replay_measured as j_replay_measured
from repro.sched.planner import Schedule as JSchedule
from repro.sched.planner import ScheduledJob as JScheduledJob
from repro.sched.planner import plan as j_plan
from repro.train.checkpoint import CheckpointPool as JCheckpointPool
from repro_torch import bridge
from repro_torch.cluster import ClusterRunner, DevicePool, SliceExecutor
from repro_torch.configs import LoraConfig, get_config, reduced
from repro_torch.launch import train as launch_train
from repro_torch.sched import A100_40G, REFERENCE_MEMORY, CostModel, ExecutionEngine, plan
from repro_torch.sched.engine import JobRecord, JobSegment, replay_measured
from repro_torch.sched.planner import Schedule, ScheduledJob
from repro_torch.train.checkpoint import CheckpointPool

CPU = torch.device("cpu")
SEQ = 16
# the space of tests/test_engine_checkpoint.py::test_run_local_end_to_end
SPACE = [dict(rank=8, alpha=8.0, learning_rate=1e-3, batch_size=1, seq_len=SEQ),
         dict(rank=16, alpha=16.0, learning_rate=5e-4, batch_size=1, seq_len=SEQ),
         dict(rank=8, alpha=32.0, learning_rate=1e-4, batch_size=2, seq_len=SEQ)]


@pytest.fixture(scope="module")
def ref_model():
    jcfg = j_reduced(j_get_config("qwen25-7b"))
    base, _ = j_init_model(jax.random.PRNGKey(0), jcfg, j_pack_meta(
        [JLoraConfig(**c) for c in SPACE]))
    return jcfg, base


def _ref_lora_init(jcfg):
    """The reference executor's pack template (``init_model`` from
    ``PRNGKey(seed)`` on the pack's ranks), as numpy."""
    def init(cfg, meta, seed):
        jmeta = j_pack_meta([JLoraConfig(rank=r) for r in meta.ranks])
        return jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(seed), jcfg, jmeta)[1])
    return init


def _leaves(tree):
    if isinstance(tree, dict):
        return [(k + "/" + p, v) for k, sub in sorted(tree.items()) for p, v in _leaves(sub)]
    return [("", np.asarray(tree))]


def _adapters(pool):
    return {i: _leaves(pool.load_adapter(i)) for i in pool.list()}


def _same_adapters(p, q):
    """Every adapter of two pools, bit for bit."""
    a, b = _adapters(p), _adapters(q)
    assert list(a) == list(b) and a
    for name in a:
        assert [k for k, _ in a[name]] == [k for k, _ in b[name]]
        assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a[name], b[name])), name


def test_run_local_matches_reference(ref_model, tmp_path):
    jcfg, jbase = ref_model
    cfg = reduced(get_config("qwen25-7b"))
    # the port's engine refuses a tree its model prices at another size: the
    # reference's f32 tree is priced as "f32" (memory does not bind here, so
    # the plan is the reference's)
    jcm = JCostModel(jcfg, J_A100)
    cm = CostModel(cfg, A100_40G, base_dtype="f32", **REFERENCE_MEMORY)
    jconfigs, configs = [JLoraConfig(**c) for c in SPACE], [LoraConfig(**c) for c in SPACE]
    jsched, sched = j_plan(jcm, jconfigs, 2, SEQ, n_steps=2), plan(cm, configs, 2, SEQ, 2)
    assert [(j.config_ids, j.degree, j.start, j.end) for j in sched.jobs] == [
        (j.config_ids, j.degree, j.start, j.end) for j in jsched.jobs]
    jpool, pool = JCheckpointPool(str(tmp_path / "ref")), CheckpointPool(str(tmp_path / "port"))
    jrecs, jmk = JEngine(jcm, 2).run_local(jsched, jconfigs, jcfg, jbase, n_steps=2, seq=SEQ,
                                            pool=jpool)
    runner = ClusterRunner(SliceExecutor(lora_init=_ref_lora_init(jcfg)), DevicePool([CPU]))
    base = bridge.to_torch(jax.tree.map(np.asarray, jbase), CPU)
    recs, mk = ExecutionEngine(cm, 2).run_local(sched, configs, cfg, base, n_steps=2, seq=SEQ,
                                                pool=pool, runner=runner)
    assert mk > 0 and len(recs) == len(jrecs) == len(sched.jobs)
    jlosses = {r.job.config_ids: r.final_losses for r in jrecs}
    for r in recs:
        np.testing.assert_allclose(r.final_losses, jlosses[r.job.config_ids], rtol=5e-3, atol=1e-3)
    assert pool.list() == jpool.list() == [f"adapter_{i:04d}" for i in range(len(SPACE))]
    jads = {i: _leaves(jax.tree.map(np.asarray, jpool.load_adapter(i))) for i in jpool.list()}
    for name, leaves in _adapters(pool).items():
        meta, jmeta = pool.load_meta(name), jpool.load_meta(name)
        assert {k: meta[k] for k in ("rank", "alpha", "learning_rate", "batch_size",
                                     "total_steps")} == {
            k: jmeta[k] for k in ("rank", "alpha", "learning_rate", "batch_size", "total_steps")}
        np.testing.assert_allclose(meta["final_loss"], jmeta["final_loss"], rtol=5e-3, atol=1e-3)
        assert [k for k, _ in leaves] == [k for k, _ in jads[name]]
        for (k, a), (_, b) in zip(leaves, jads[name]):
            np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-3, err_msg=f"{name} {k}")


def test_engine_refuses_a_base_priced_at_another_size():
    """``run_local`` and ``run_online_local`` raise before they run anything
    when the cost model prices the tree at another size than it holds: an
    f32 tree under a model priced at 2 bytes (None or "bf16"), a bf16 tree
    under "f32"."""
    from repro_torch.sched import Arrival

    cfg, f32 = _port_base()
    bf16 = bridge.to_torch(bridge.to_numpy(f32), CPU, torch.bfloat16)
    configs = [LoraConfig(**SPACE[0])]
    sched = Schedule([ScheduledJob((0,), 1, 0.0, 1.0)], 1.0, 1)
    trace = [Arrival(0.0, configs[0], 1)]
    for base, dtype in ((f32, None), (f32, "bf16"), (bf16, "f32")):
        eng = ExecutionEngine(CostModel(cfg, A100_40G, base_dtype=dtype), 1)
        with pytest.raises(ValueError, match="prices the frozen base"):
            eng.run_local(sched, configs, cfg, base, n_steps=1, seq=SEQ)
        with pytest.raises(ValueError, match="prices the frozen base"):
            eng.run_online_local(trace, cfg, base, n_steps=1, seq=SEQ)


def _port_base():
    from repro_torch.models.model import init_model

    cfg = reduced(get_config("qwen25-7b"))
    return cfg, init_model(0, cfg, None, device=CPU)[0]


def _run(segments, configs, total, tmp_path, name, *, devices=1, concurrent=None):
    cfg, base = _port_base()
    pool = CheckpointPool(str(tmp_path / name))
    runner = ClusterRunner(SliceExecutor(), DevicePool([CPU] * devices), concurrent=concurrent)
    res = runner.run(segments, dict(enumerate(configs)), total, cfg, base, seq=SEQ, pool=pool)
    return res, pool


def _seg(job_id, cids, start_steps, run_steps, done, t, preempted=False, units=(0,)):
    return JobSegment(job_id=job_id, config_ids=cids, degree=1, start=t, end=t + 1.0,
                      start_steps=start_steps, run_steps=run_steps, done_ids=done,
                      preempted=preempted, units=units)


def test_segmented_run_with_budgets_equals_unbroken(tmp_path):
    """Adapter 0 has a budget of 3 steps, adapter 1 of 4. Cut after 2 steps
    (both checkpointed to the pool), resumed in a new segment that fast-
    forwards their data: adapters and losses equal the unbroken run's."""
    configs = [LoraConfig(**SPACE[0]), LoraConfig(**SPACE[1])]
    total = {0: 3, 1: 4}
    whole, wpool = _run([_seg(0, (0, 1), (0, 0), 4, (0, 1), 0.0)], configs, total, tmp_path, "w")
    parts, ppool = _run([_seg(0, (0, 1), (0, 0), 2, (), 0.0, preempted=True),
                         _seg(1, (0, 1), (2, 2), 2, (0, 1), 1.0)], configs, total, tmp_path, "p")
    assert ppool.list_states() == ["part_0000", "part_0001"]
    assert ppool.load_adapter_state("0000")[1]["steps_done"] == 2
    assert np.array_equal(parts.records[-1].final_losses, whole.records[0].final_losses)
    _same_adapters(ppool, wpool)
    # a resume with no state in the pool raises
    with pytest.raises(RuntimeError, match="no checkpointed state"):
        _run([_seg(0, (0, 1), (2, 2), 2, (0, 1), 0.0)], configs, total, tmp_path, "empty")


def test_two_cpu_devices_concurrent_equal_sequential(tmp_path):
    configs = [LoraConfig(**c) for c in SPACE]
    segs = [_seg(0, (0, 1), (0, 0), 2, (0, 1), 0.0, units=(0,)),
            _seg(1, (2,), (0,), 2, (2,), 0.0, units=(1,))]
    total = {i: 2 for i in range(3)}
    conc, cpool = _run(segs, configs, total, tmp_path, "c", devices=2, concurrent=True)
    seq, spool = _run(segs, configs, total, tmp_path, "s", devices=2, concurrent=False)
    assert conc.concurrent and not seq.concurrent
    for a, b in zip(conc.records, seq.records):
        assert np.array_equal(a.final_losses, b.final_losses)
    assert cpool.list() == ["adapter_0000", "adapter_0001", "adapter_0002"]
    _same_adapters(cpool, spool)


def test_launcher_resume_equals_unbroken_run(tmp_path):
    common = ["--reduced", "--device", "cpu", "--seq", str(SEQ), "--log-every", "0"]
    whole = launch_train.main(common + ["--steps", "4", "--pool", str(tmp_path / "w")])
    launch_train.main(common + ["--steps", "2", "--pool", str(tmp_path / "r"), "--save-state"])
    resumed = launch_train.main(common + ["--steps", "2", "--pool", str(tmp_path / "r"),
                                          "--save-state", "--resume-state"])
    assert np.array_equal(whole, resumed)
    w, r = CheckpointPool(str(tmp_path / "w")), CheckpointPool(str(tmp_path / "r"))
    assert r.load_meta("state_qwen25-7b-reduced")["steps_done"] == [4, 4]
    assert len(w.list()) == 2
    _same_adapters(w, r)
    with pytest.raises(SystemExit):
        launch_train.main(common + ["--resume-state"])  # needs --pool


def test_simulate_replay_and_the_default_runner(monkeypatch):
    cm = CostModel(get_config("qwen25-7b"), A100_40G)
    bad = Schedule([ScheduledJob((0,), 8, 0.0, 10.0), ScheduledJob((1,), 8, 5.0, 15.0)], 15.0, 8)
    with pytest.raises(RuntimeError, match="oversubscribes"):
        ExecutionEngine(cm, 8).simulate(bad)
    jobs = [((0,), 4, 0, 10), ((1,), 4, 0, 10), ((2,), 2, 10, 12)]
    sched = Schedule([ScheduledJob(*j) for j in jobs], 12, 8)
    jsched = JSchedule([JScheduledJob(*j) for j in jobs], 12, 8)
    for g in (8, 4, 2):
        recs = [JobRecord(j, w) for j, w in zip(sched.jobs, (3.0, 5.0, 1.5))]
        jrecs = [JJobRecord(j, w) for j, w in zip(jsched.jobs, (3.0, 5.0, 1.5))]
        assert replay_measured(sched, recs, g) == j_replay_measured(jsched, jrecs, g)
    assert ExecutionEngine(cm, 8).simulate(sched) == 12
    # no runner given: the default one runs on this host's CUDA devices only
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    cfg = reduced(get_config("qwen25-7b"))
    with pytest.raises(ValueError, match="no CUDA device"):
        ExecutionEngine(CostModel(cfg, A100_40G), 1).run_local(
            Schedule([ScheduledJob((0,), 1, 0.0, 1.0)], 1.0, 1), [LoraConfig(**SPACE[0])],
            cfg, None, n_steps=1, seq=SEQ)
