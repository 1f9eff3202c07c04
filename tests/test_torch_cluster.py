"""The port's checkpoint pool, device pool, runner and slice executor, on
the CPU.

Checkpoint files cross-load between the packages bit for bit; device-pool
accounting, unit assignment and resume dependencies equal the reference's;
the executor's step cache builds once per step shape. The CUDA-only path
(the captured step) is tested on the card by ``tests/test_torch_capture.py``
and ``chip_smoke.py``.
"""
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.cluster.pool import DevicePool as JDevicePool
from repro.cluster.pool import assign_units as j_assign_units
from repro.cluster.pool import pick_class_units as j_pick_class_units
from repro.cluster.pool import pick_host_units as j_pick_host_units
from repro.cluster.runner import peak_overlap as j_peak_overlap
from repro.cluster.runner import resume_deps as j_resume_deps
from repro.sched.engine import JobSegment as JJobSegment
from repro.train import checkpoint as jckpt
from repro_torch import bridge
from repro_torch.cluster import (
    ClusterRunner,
    DevicePool,
    MeshSlice,
    Runner,
    SliceExecutor,
    assign_units,
    peak_overlap,
    pick_class_units,
    pick_host_units,
    resume_deps,
)
from repro_torch.configs import LoraConfig, get_config, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.core.packed_lora import extract_adapter, inject_adapter
from repro_torch.kernels.ops import default_impl, use_impl
from repro_torch.models.model import init_model
from repro_torch.obs import MetricsTracer
from repro_torch.sched.engine import JobRecord, JobSegment
from repro_torch.sched.planner import ScheduledJob
from repro_torch.train import checkpoint as tckpt
from repro_torch.tree import tree_leaves, tree_map

CPU = torch.device("cpu")


def fake_pool(n: int) -> DevicePool:
    return DevicePool([f"fake{i}" for i in range(n)])


def _leaves(tree):
    if isinstance(tree, dict):
        return [(k + "/" + p, v) for k, sub in sorted(tree.items()) for p, v in _leaves(sub)]
    return [("", tree)]


def _bits(a):
    a = np.asarray(a)
    return a.dtype.str, a.shape, a.tobytes()


def _same_bits(x, y):
    lx, ly = _leaves(x), _leaves(y)
    assert [k for k, _ in lx] == [k for k, _ in ly]
    for (k, a), (_, b) in zip(lx, ly):
        assert _bits(a) == _bits(b), k


# ---------------------------------------------------------------------------
# CheckpointPool
# ---------------------------------------------------------------------------


def _tree(dtype):
    rng = np.random.RandomState(0)
    return {"layer": {"a": rng.randn(3, 5).astype(dtype), "b": rng.randn(4).astype(dtype)},
            "scalar": np.asarray(3.0, dtype)}


def test_checkpoint_f32_tree_crosses_packages(tmp_path):
    tree = _tree(np.float32)
    jckpt.save_tree(str(tmp_path / "ref.npz"), jax.tree.map(jnp.asarray, tree), {"note": 1})
    tckpt.save_tree(str(tmp_path / "port.npz"), bridge.to_torch(tree, CPU), {"note": 1})
    _same_bits(tckpt.load_tree(str(tmp_path / "ref.npz")), tree)
    _same_bits(jax.tree.map(np.asarray, jckpt.load_tree(str(tmp_path / "port"))), tree)
    assert (tmp_path / "port.npz.json").read_text() == (tmp_path / "ref.npz.json").read_text()


def test_checkpoint_bf16_tree_crosses_packages(tmp_path):
    """bf16 goes to disk as numpy writes ml_dtypes' bf16 (``|V2``): a torch
    bf16 tensor is written as the same bytes, and either file reads back as
    ml_dtypes bf16 in the port, bit for bit."""
    tree = _tree(ml_dtypes.bfloat16)
    jckpt.save_tree(str(tmp_path / "ref.npz"), jax.tree.map(jnp.asarray, tree))
    tckpt.save_tree(str(tmp_path / "port.npz"), bridge.to_torch(tree, CPU))
    with np.load(tmp_path / "ref.npz") as r, np.load(tmp_path / "port.npz") as p:
        assert sorted(r.files) == sorted(p.files)
        for k in r.files:
            assert _bits(r[k]) == _bits(p[k]), k
    for name in ("ref", "port"):
        back = tckpt.load_tree(str(tmp_path / name))
        assert back["layer"]["a"].dtype == ml_dtypes.bfloat16
        _same_bits(back, tree)


def _packed_state():
    cfg = reduced(get_config("qwen25-7b"))
    meta = pack_meta([LoraConfig(rank=8), LoraConfig(rank=16, alpha=4.0)])
    _, lora = init_model(3, cfg, meta, device=CPU)
    # + 0.0 turns the rank padding's -0.0 (randn * mask) into the +0.0 that
    # inject_adapter pads with
    lora = tree_map(lambda t: t + 0.0, lora)
    gen = torch.Generator().manual_seed(5)
    m = tree_map(lambda t: torch.where(t != 0, torch.randn(t.shape, generator=gen), 0.0), lora)
    return cfg, meta, lora, {"m": m, "v": lora, "step": torch.tensor([3, 7], dtype=torch.int32)}


def test_packed_state_crosses_packages(tmp_path):
    _, meta, lora, opt = _packed_state()
    meta_json = {"ranks": list(meta.ranks), "steps_done": [3, 7]}
    tpool, jpool = tckpt.CheckpointPool(str(tmp_path / "t")), jckpt.CheckpointPool(
        str(tmp_path / "j"))
    tpool.save_packed_state("s", lora, opt, meta_json)
    np_lora, np_opt = bridge.to_numpy(lora), bridge.to_numpy(opt)
    jpool.save_packed_state("s", jax.tree.map(jnp.asarray, np_lora),
                            jax.tree.map(jnp.asarray, np_opt), meta_json)
    for pool in (tpool, jpool):
        assert pool.list_states() == ["state_s"] and pool.list() == []
    jl, jo, jm = jpool.load_packed_state("s")  # the reference reads the port's file...
    assert jm == meta_json
    tl, to, tm = tckpt.CheckpointPool(str(tmp_path / "j")).load_packed_state("s")
    _same_bits(tl, np_lora)  # ...and the port reads the reference's
    _same_bits(to, np_opt)
    tl, to, _ = tpool.load_packed_state("s")
    _same_bits(jax.tree.map(np.asarray, jckpt.CheckpointPool(str(tmp_path / "t"))
                            .load_packed_state("s")[1]), to)
    _same_bits(jax.tree.map(np.asarray, jl), np_lora)
    _same_bits(jax.tree.map(np.asarray, jo), np_opt)


def test_extract_save_load_inject_is_bit_exact(tmp_path):
    _, meta, lora, opt = _packed_state()
    pool = tckpt.CheckpointPool(str(tmp_path))
    for slot in range(meta.n):
        ad = extract_adapter(lora, slot, meta.ranks)
        pool.save_adapter(f"adapter_{slot:04d}", ad, {"rank": meta.ranks[slot]})
        pool.save_adapter_state(f"{slot:04d}", {"w": ad, "m": extract_adapter(
            opt["m"], slot, meta.ranks), "v": ad}, {"steps_done": 3})
    assert pool.list() == ["adapter_0000", "adapter_0001"]
    assert pool.has_adapter_state("0001") and pool.load_meta("adapter_0001")["rank"] == 16
    back = bridge.to_torch(jax.tree.map(np.zeros_like, bridge.to_numpy(lora)), CPU)
    mback = bridge.to_torch(jax.tree.map(np.zeros_like, bridge.to_numpy(opt["m"])), CPU)
    for slot in range(meta.n):
        back = inject_adapter(back, pool.load_adapter(f"adapter_{slot:04d}"), slot)
        state, smeta = pool.load_adapter_state(f"{slot:04d}")
        mback = inject_adapter(mback, state["m"], slot)
    _same_bits(back, bridge.to_numpy(lora))
    _same_bits(mback, bridge.to_numpy(opt["m"]))


# ---------------------------------------------------------------------------
# DevicePool (mirrors tests/test_cluster.py's accounting cases)
# ---------------------------------------------------------------------------


def test_pool_acquire_release_accounting():
    pool = fake_pool(8)
    assert pool.total == 8 and pool.free == 8
    s1 = pool.acquire(3)
    assert s1.units == (0, 1, 2) and s1.width == 3
    s2 = pool.acquire(5)
    assert s2.units == (3, 4, 5, 6, 7) and pool.free == 0
    assert pool.try_acquire(1) is None
    pool.release(s1)
    s3 = pool.try_acquire(2)
    assert s3 is not None and set(s3.units) <= {0, 1, 2}
    pool.release(s2)
    pool.release(s3)
    assert pool.free == 8


def test_pool_exhaustion_errors_and_leases():
    pool = fake_pool(4)
    with pytest.raises(ValueError, match="only 4"):
        pool.acquire(5)
    s = pool.acquire(4)
    with pytest.raises(TimeoutError):
        pool.acquire(1, timeout=0.01)
    pool.release(s)
    with pytest.raises(RuntimeError, match="double release"):
        pool.release(s)
    s = pool.acquire_units((1, 3))
    assert s.units == (1, 3) and s.devices == ("fake1", "fake3")
    with pytest.raises(TimeoutError, match=r"\[1\]"):
        pool.acquire_units((0, 1), timeout=0.01)
    pool.release(s)
    for lease in (lambda: pool.lease(2), lambda: pool.lease_units((0, 3)),
                  lambda: pool.held(pool.acquire(1))):
        with pytest.raises(KeyError):
            with lease():
                raise KeyError("boom")
        assert pool.free == 4
    assert fake_pool(1).map_units((0, 3, 5)) == (0,)


def test_default_pool_is_the_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no CUDA device"):
        DevicePool()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert DevicePool().devices == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_wide_slice_raises():
    wide = MeshSlice(units=(0, 1), devices=(CPU, CPU))
    with pytest.raises(NotImplementedError, match="sharded"):
        wide.mesh()
    assert MeshSlice(units=(0,), devices=(CPU,)).mesh() == CPU
    cfg = reduced(get_config("qwen25-7b"))
    with pytest.raises(NotImplementedError, match="sharded"):
        SliceExecutor().train_pack(cfg, [LoraConfig(rank=8)], n_steps=1, seq=8, base=None,
                                   slice_=wide)


def test_unit_assignment_and_resume_deps_match_reference():
    free = [0, 1, 4, 5, 6, 7]
    for args in ((free, 3, None), (free, 2, 4), (free, 4, 4), ([0, 3, 4, 7], 2, 2),
                 ([0, 1], 4, 4)):
        assert pick_host_units(*args) == j_pick_host_units(*args)
    cls = {0: "fast", 1: "slow", 2: "fast"}
    kw = dict(class_of_host=cls.get, ratio_of_class={"fast": 1.0, "slow": 2.5}.get,
              avoid_host=lambda h: h == 2)
    for degree in (1, 2):
        assert (pick_class_units(list(range(6)), degree, 2, **kw)
                == j_pick_class_units(list(range(6)), degree, 2, **kw))
    intervals = [(0.0, 5.0, 2), (0.0, 3.0, 4), (3.0, 9.0, 4), (5.0, 6.0, 1), (6.0, 8.0, 2)]
    for host_size in (None, 4):
        assert assign_units(intervals, 8, host_size) == j_assign_units(intervals, 8, host_size)
    with pytest.raises(RuntimeError, match="oversubscribe"):
        assign_units([(0.0, 1.0, 4), (0.5, 2.0, 4)], 4)
    segs = [dict(job_id=0, config_ids=(0, 1), degree=1, start=0.0, end=1.0, start_steps=(0, 0),
                 run_steps=2, done_ids=(1,), preempted=True),
            dict(job_id=1, config_ids=(0, 2), degree=1, start=1.0, end=2.0, start_steps=(2, 0),
                 run_steps=0, done_ids=(), preempted=True),
            dict(job_id=2, config_ids=(0, 2), degree=1, start=2.0, end=3.0, start_steps=(2, 0),
                 run_steps=3, done_ids=(0, 2))]
    assert resume_deps([JobSegment(**s) for s in segs]) == j_resume_deps(
        [JJobSegment(**s) for s in segs]) == [[], [0], [1]]
    spans = [(0.0, 2.0), (1.0, 3.0), (2.5, 4.0), (5.0, 6.0)]
    assert peak_overlap(spans) == j_peak_overlap(spans) == 2
    assert JDevicePool(devices=["a"]).map_units((0, 3)) == fake_pool(1).map_units((0, 3))


# ---------------------------------------------------------------------------
# ClusterRunner over a scripted executor
# ---------------------------------------------------------------------------


class Crash(Exception):
    pass


class ScriptedExecutor:
    """Records dispatch order and the policy it was given; crashes on one
    segment if asked. No model: the runner's own semantics only."""

    def __init__(self, crash_on=None):
        self.crash_on = crash_on
        self.calls = []
        self.lock = threading.Lock()

    def pack_template(self, cfg, configs, seed=0, device=None):
        return {}, None

    def run_segment(self, seg, configs_by_cid, total_steps, cfg, base, *, slice_, impl, **kw):
        with self.lock:
            self.calls.append((seg.job_id, slice_.units, impl))
        if self.crash_on == seg.job_id:
            raise Crash(seg.job_id)
        return JobRecord(ScheduledJob(seg.config_ids, seg.degree, seg.start, seg.end),
                         0.01 * (seg.job_id + 1), np.zeros(len(seg.config_ids)),
                         real_start=0.0, real_end=0.0)


def _segments(n):
    return [JobSegment(job_id=i, config_ids=(i,), degree=1, start=float(i // 2), end=i // 2 + 1.0,
                       start_steps=(0,), run_steps=2, done_ids=(i,), units=(i % 2,))
            for i in range(n)]


@pytest.mark.parametrize("concurrent", [False, True], ids=["sequential", "concurrent"])
def test_runner_dispatch_policy_and_crash_release(concurrent):
    cfgs = {i: LoraConfig(rank=8, alpha=8.0 + i) for i in range(4)}
    tracer = MetricsTracer()
    pool = fake_pool(2)
    ex = ScriptedExecutor()
    runner = ClusterRunner(ex, pool, concurrent=concurrent, tracer=tracer)
    assert isinstance(runner, Runner)
    with use_impl("fused"):  # the caller's context default crosses the thread boundary
        res = runner.run(_segments(4), cfgs, {i: 2 for i in range(4)}, None, None, seq=16)
    assert [r.job.config_ids for r in res.records] == [(0,), (1,), (2,), (3,)]
    assert {impl for *_, impl in ex.calls} == {"fused"} and default_impl() == "auto"
    assert sorted(j for j, *_ in ex.calls) == [0, 1, 2, 3] and pool.free == 2
    assert [t.measured_iter for t in res.timings] == [0.005, 0.01, 0.015, 0.02]
    assert tracer.metrics.to_json()["gauges"]["cluster.free_units"] == 2
    with pytest.raises(Crash):
        ClusterRunner(ScriptedExecutor(crash_on=0), pool, concurrent=concurrent).run(
            _segments(2), cfgs, {0: 2, 1: 2}, None, None, seq=16)
    assert pool.free == pool.total


def test_default_impl_is_context_local():
    seen = []
    with use_impl("fused"):
        t = threading.Thread(target=lambda: seen.append(default_impl()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and seen == ["auto"] and default_impl() == "fused"
    assert default_impl() == "auto"
    with pytest.raises(ValueError, match="unknown impl"):
        with use_impl("xla"):
            pass


# ---------------------------------------------------------------------------
# SliceExecutor's step cache
# ---------------------------------------------------------------------------


def test_executor_builds_once_per_step_shape():
    """Two same-shape packs with different learning rates and alphas share
    one step: one build, one hit; a pack of another width builds again."""
    cfg = reduced(get_config("qwen25-7b"))
    base, _ = init_model(0, cfg, None, device=CPU)
    tracer = MetricsTracer()
    ex = SliceExecutor(tracer=tracer)
    cpu = DevicePool([CPU]).acquire(1)
    packs = [[LoraConfig(rank=8, alpha=16.0, learning_rate=lr, seq_len=8),
              LoraConfig(rank=8, alpha=4.0, learning_rate=2 * lr, seq_len=8)]
             for lr in (1e-3, 3e-4)]
    losses = [ex.train_pack(cfg, p, n_steps=1, seq=8, base=base, slice_=cpu).losses
              for p in packs]
    assert (ex.n_builds, ex.n_hits) == (1, 1)
    assert tracer.metrics.to_json()["counters"] == {
        "executor.compile_cache_builds": 1, "executor.compile_cache_hits": 1}
    assert all(np.isfinite(x).all() and x.shape == (2,) for x in losses)
    ex.train_pack(cfg, packs[0][:1], n_steps=1, seq=8, base=base, slice_=cpu)
    assert (ex.n_builds, ex.n_hits) == (2, 1) and ex.captures == []  # the CPU runs eager
    lora, opt = ex.pack_template(cfg, packs[1], seed=0, device=CPU)
    assert opt is None and all(t.device == CPU for t in tree_leaves(lora))
    again, _ = ex.pack_template(cfg, packs[0], seed=0, device=CPU)
    assert all(a is b for a, b in zip(tree_leaves(lora), tree_leaves(again)))


def test_in_place_step_equals_functional_step_bitwise():
    """The captured step's AdamW updates the state buffers in place: the
    same arithmetic as the functional step, so the same bits (budgets
    included), and the inputs it was given now hold the result."""
    from repro_torch.train.data import packed_batch_iterator
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import make_packed_step

    cfg = reduced(get_config("qwen25-7b"))
    configs = [LoraConfig(rank=8, alpha=16.0, learning_rate=1e-3),
               LoraConfig(rank=16, alpha=4.0, learning_rate=5e-4, batch_size=2)]
    meta = pack_meta(configs)
    base, lora = init_model(0, cfg, meta, device=CPU)
    it = packed_batch_iterator(cfg, configs, seq=8, device=CPU)
    batches = [next(it) for _ in range(3)]
    vecs = (meta.scales(CPU), meta.lr_vector(CPU), torch.tensor([2, 3], dtype=torch.int32))
    fn = make_packed_step(cfg, meta.n, ranks=meta.ranks)
    ip = make_packed_step(cfg, meta.n, ranks=meta.ranks, in_place=True)
    fl, fo = lora, init_opt_state(lora, n_pack=meta.n)
    il, io = tree_map(torch.clone, lora), init_opt_state(lora, n_pack=meta.n)
    for b in batches:
        fl, fo, fm = fn(base, fl, fo, b, *vecs)
        il2, io2, im = ip(base, il, io, b, *vecs)
        assert il2 is il and io2 is io
        assert torch.equal(fm["per_adapter_loss"], im["per_adapter_loss"])
    for a, b in zip(tree_leaves({"l": fl, "o": fo}), tree_leaves({"l": il, "o": io})):
        assert torch.equal(a, b)
    assert io["step"].tolist() == [2, 3]


def test_eager_pack_leaves_the_given_state_alone():
    """The eager path steps a copy of the state it is given in place: the
    caller's tensors keep their values, and the result equals the
    functional step's, step by step."""
    from repro_torch.train.data import packed_batch_iterator
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import make_packed_step

    cfg = reduced(get_config("qwen25-7b"))
    configs = [LoraConfig(rank=8, alpha=16.0, learning_rate=1e-3, seq_len=8),
               LoraConfig(rank=16, alpha=4.0, learning_rate=5e-4, batch_size=2, seq_len=8)]
    meta = pack_meta(configs)
    base, lora = init_model(0, cfg, meta, device=CPU)
    opt = init_opt_state(lora, n_pack=meta.n)
    given = [t.clone() for t in tree_leaves({"l": lora, "o": opt})]
    losses = []
    res = SliceExecutor().train_pack(
        cfg, configs, n_steps=3, seq=8, base=base, lora=lora, opt=opt,
        slice_=DevicePool([CPU]).acquire(1),
        step_callback=lambda i, m: losses.append(m["per_adapter_loss"].clone()))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves({"l": lora, "o": opt}), given))
    assert res.peak_bytes is None
    fn = make_packed_step(cfg, meta.n, ranks=meta.ranks)
    vecs = (meta.scales(CPU), meta.lr_vector(CPU), None)
    it = packed_batch_iterator(cfg, configs, seq=8, device=CPU)
    for want in losses:
        lora, opt, m = fn(base, lora, opt, next(it), *vecs)
        assert torch.equal(m["per_adapter_loss"], want)
    for a, b in zip(tree_leaves({"l": lora, "o": opt}), tree_leaves({"l": res.lora, "o": res.opt})):
        assert torch.equal(a, b)


def test_base_is_placed_once_per_device():
    """A base that does not lie on the slice's device is copied there once
    and the copy kept; a base already there is used as it is."""
    cfg = reduced(get_config("qwen25-7b"))
    base, _ = init_model(0, cfg, None, device=CPU)
    ex = SliceExecutor()
    meta_dev = torch.device("meta")
    assert ex._placed_base(base, CPU) is base
    copy = ex._placed_base(base, meta_dev)
    assert all(t.device == meta_dev for t in tree_leaves(copy))
    assert ex._placed_base(base, meta_dev) is copy
    other, _ = init_model(1, cfg, None, device=CPU)
    assert ex._placed_base(other, meta_dev) is not copy
    ex.clear()
    assert ex._placed_base(base, meta_dev) is not copy


def test_launch_counts_leave_a_capture_and_return_per_replay():
    """Calls made while a graph captures are taken out of the counts (they
    launched nothing) and kept for the replays to add back."""
    from repro_torch.kernels import launches
    from repro_torch.kernels.packed_matmul import packed_matmul

    launches.zero()
    packed_matmul.launches["fwd", "mma"] += 2  # an eager step
    with launches.recorded() as calls:
        packed_matmul.launches["fwd", "mma"] += 5
        packed_matmul.launches["bwd", "mma"] += 3
    assert calls == {("packed_matmul", "fwd", "mma"): 5, ("packed_matmul", "bwd", "mma"): 3}
    assert launches.read()["packed_matmul"] == 2 and launches.read()["packed_matmul_bwd"] == 0
    for _ in range(4):  # four replays
        launches.add(calls)
    assert launches.read() == {"packed_matmul": 22, "packed_matmul_bwd": 12, "fused_matmul": 0,
                               "fused_matmul_dx": 0, "fused_matmul_q": 0}
    with pytest.raises(KeyError):
        with launches.recorded():
            packed_matmul.launches["fwd", "mma"] += 1
            raise KeyError("a failed capture")
    assert launches.read()["packed_matmul"] == 22
    launches.zero()
