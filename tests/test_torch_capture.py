"""The slice executor's captured step on the card, at the reduced size.

These need a CUDA device and skip without one (a CUDA graph has no CPU
mode); the two-device test needs two. This file imports only torch and the
port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_capture.py

A captured ``train_pack`` runs the eager step's kernels in the same order on
the same buffers, so every comparison here is bit for bit: per-step losses,
final LoRA weights and optimizer state.
"""
import numpy as np
import pytest
import torch

from repro_torch.cluster import ClusterRunner, DevicePool, SliceExecutor
from repro_torch.cluster import executor as executor_mod
from repro_torch.configs import LoraConfig, get_config, reduced
from repro_torch.kernels import launches
from repro_torch.models.model import init_model
from repro_torch.sched.engine import JobSegment
from repro_torch.tree import tree_leaves

SEQ = 16
STEPS = 3
PACK = [LoraConfig(rank=8, alpha=16.0, learning_rate=1e-3, seq_len=SEQ),
        LoraConfig(rank=16, alpha=4.0, learning_rate=5e-4, batch_size=2, seq_len=SEQ),
        LoraConfig(rank=16, alpha=32.0, learning_rate=2e-4, seq_len=SEQ)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def model(cuda):
    cfg = reduced(get_config("qwen25-7b"))
    base, _ = init_model(0, cfg, None, dtype=torch.bfloat16, device=cuda)
    return cfg, base


def _train(ex, cfg, base, configs, device, steps=STEPS):
    """(per-step losses, final state as host tensors, the result)."""
    losses = []
    res = ex.train_pack(cfg, configs, n_steps=steps, seq=SEQ, base=base,
                        slice_=DevicePool([device]).acquire(1),
                        step_callback=lambda i, m: losses.append(m["per_adapter_loss"].clone()))
    state = [t.cpu() for t in tree_leaves({"lora": res.lora, "opt": res.opt})]
    return torch.stack(losses).cpu(), state, res


def _same(a, b):
    la, sa, _ = a
    lb, sb, _ = b
    assert torch.equal(la, lb)
    assert len(sa) == len(sb) and all(torch.equal(x, y) for x, y in zip(sa, sb))


@pytest.mark.gpu
def test_captured_pack_equals_eager_and_a_hit_takes_new_vectors(cuda, model):
    """The captured step equals the eager step bit for bit; a second pack
    of the same shape with other alphas and learning rates hits the cache
    (no second capture) and equals its own eager run."""
    cfg, base = model
    ex = SliceExecutor()
    eager = SliceExecutor(capture=False)
    _same(_train(ex, cfg, base, PACK, cuda), _train(eager, cfg, base, PACK, cuda))
    assert (ex.n_builds, ex.n_hits, len(ex.captures)) == (1, 0, 1)
    cap = ex.captures[0]
    assert cap["pool_bytes"] > 0 and cap["static_bytes"] > 0 and cap["transient_bytes"] > 0
    other = [LoraConfig(rank=c.rank, alpha=3.0 * c.alpha, learning_rate=0.25 * c.learning_rate,
                        batch_size=c.batch_size, seq_len=SEQ) for c in PACK]
    hit = _train(ex, cfg, base, other, cuda)
    assert (ex.n_builds, ex.n_hits, len(ex.captures)) == (1, 1, 1)
    _same(hit, _train(eager, cfg, base, other, cuda))
    assert hit[2].peak_bytes >= cap["static_bytes"]
    assert not torch.equal(hit[0], _train(eager, cfg, base, PACK, cuda)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("arch,stub", [("whisper-tiny", "frames"), ("internvl2-1b", "patches")])
def test_front_end_stubs_ride_in_the_captured_batch(cuda, arch, stub):
    """An encoder-decoder's frames and a VLM's patches are buffers of the
    captured step's static batch: the captured pack equals its eager run
    bit for bit, and a second pack of the graph's key (other alphas and
    learning rates) hits the cache, refills the same buffer and equals its
    own eager run."""
    cfg = reduced(get_config(arch))
    base, _ = init_model(0, cfg, None, dtype=torch.bfloat16, device=cuda)
    ex, eager = SliceExecutor(), SliceExecutor(capture=False)
    _same(_train(ex, cfg, base, PACK, cuda), _train(eager, cfg, base, PACK, cuda))
    (graph,) = ex._graphs.values()
    buf = graph.batch[stub]
    assert buf.shape[0] == len(PACK) * 2 and buf.dtype == torch.float32
    other = [LoraConfig(rank=c.rank, alpha=3.0 * c.alpha, learning_rate=0.25 * c.learning_rate,
                        batch_size=c.batch_size, seq_len=SEQ) for c in PACK]
    hit = _train(ex, cfg, base, other, cuda)
    assert (ex.n_builds, ex.n_hits, len(ex.captures)) == (1, 1, 1)
    (again,) = ex._graphs.values()
    assert again is graph and again.batch[stub].data_ptr() == buf.data_ptr()
    _same(hit, _train(eager, cfg, base, other, cuda))


@pytest.mark.gpu
def test_eviction_recaptures_and_replays_count_their_launches(cuda, model, monkeypatch):
    """With one graph per device, shapes A, B, A capture three times, and
    the third capture equals the eager run again. The kernels' counts take
    the warm-up step's launches and each replay's, not the capture's calls:
    a captured run of n steps counts n + WARMUP_STEPS eager steps' launches."""
    cfg, base = model
    monkeypatch.setattr(executor_mod, "MAX_GRAPHS", 1)
    ex, eager = SliceExecutor(), SliceExecutor(capture=False)
    narrow = PACK[:1]
    first = _train(ex, cfg, base, PACK, cuda)
    _train(ex, cfg, base, narrow, cuda)
    launches.zero()
    again = _train(ex, cfg, base, PACK, cuda)
    captured = launches.read()
    assert (ex.n_builds, ex.n_hits, len(ex.captures)) == (3, 0, 3)
    _same(first, again)
    launches.zero()
    _same(again, _train(eager, cfg, base, PACK, cuda))
    per_step = {k: v // STEPS for k, v in launches.read().items()}
    assert per_step["packed_matmul"] > 0 and per_step["packed_matmul_bwd"] > 0
    assert captured == {k: v * (STEPS + executor_mod.WARMUP_STEPS) for k, v in per_step.items()}


@pytest.mark.gpu
def test_a_new_shape_after_a_large_graph_peaks_as_on_a_fresh_executor(cuda, model):
    """A pack of a new shape drops the device's cached graph before its
    template and state are made, and its ``peak_bytes`` (the call's whole
    high-water mark) rises above what it leaves allocated by what it rises
    on a fresh executor: the large graph's buffers, hundreds of MB, are
    not part of it. (Measured above what the call leaves allocated, since
    each capture's streams leave their cuBLAS workspaces behind.)"""
    cfg, base = model
    small = PACK[:1]
    large = [LoraConfig(rank=128, alpha=16.0, learning_rate=1e-4, batch_size=4, seq_len=SEQ)] * 32

    def rise(ex, configs):
        res = _train(ex, cfg, base, configs, cuda)[2]
        return res.captured, res.peak_bytes - torch.cuda.memory_allocated(cuda)

    fresh = SliceExecutor()
    want = rise(fresh, small)[1]
    fresh.clear()
    del fresh
    torch.cuda.empty_cache()
    ex = SliceExecutor()
    assert rise(ex, large)[0]
    held = ex.captures[0]["static_bytes"]
    captured, got = rise(ex, small)
    assert captured and len(ex.captures) == 2 and held > 2e8
    assert got <= want + held // 4
    # a further pack of the small shape hits, and reports no capture
    assert not rise(ex, small)[0] and ex.n_hits == 1


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 3])
def test_init_lora_on_the_card_is_init_models_lora(cuda, seed):
    """The executor's templates on the card's generator: ``init_lora`` makes
    ``init_model``'s LoRA tree bit for bit."""
    from repro_torch.core.adapter import pack_meta
    from repro_torch.models.model import init_lora

    cfg = reduced(get_config("qwen25-7b"))
    meta = pack_meta(PACK)
    want = tree_leaves(init_model(seed, cfg, meta, device=cuda)[1])
    got = tree_leaves(init_lora(seed, cfg, meta, device=cuda))
    assert len(got) == len(want) > 0 and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_a_step_that_does_not_fit_raises_with_the_numbers(cuda, model, monkeypatch):
    cfg, base = model
    torch.cuda.empty_cache()
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (0, 80 * 2 ** 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    ex = SliceExecutor()
    with pytest.raises(torch.OutOfMemoryError, match="its buffers needs .* GB free of"):
        _train(ex, cfg, base, PACK, cuda)
    assert ex.captures == []


@pytest.mark.gpu
@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two CUDA devices")
def test_two_devices_run_concurrently_equal_one_device(cuda, model):
    """Two segments on two cards at once, the base given on card 0 (copied
    to card 1 once), each card holding its own graph, equal the same
    segments run one after the other on card 0."""
    cfg, base = model
    configs = {i: c for i, c in enumerate(PACK)}
    total = {i: STEPS for i in configs}
    segs = [JobSegment(0, (0, 1), 1, 0.0, 1.0, (0, 0), STEPS, (0, 1), units=(0,)),
            JobSegment(1, (2,), 1, 0.0, 1.0, (0,), STEPS, (2,), units=(1,))]
    two = ClusterRunner(SliceExecutor(), DevicePool())
    one = ClusterRunner(SliceExecutor(), DevicePool([cuda]))
    assert two.concurrent and not one.concurrent
    got = two.run(segs, configs, total, cfg, base, seq=SEQ)
    want = one.run(segs, configs, total, cfg, base, seq=SEQ)
    for a, b in zip(got.records, want.records):
        assert np.array_equal(a.final_losses, b.final_losses)
    devices = sorted(c["device"] for c in two.executor.captures)
    assert devices == ["cuda:0", "cuda:1"]
    assert len(two.executor._bases) == 1  # one copy of the base, on card 1


@pytest.mark.gpu
def test_run_local_with_the_default_runner(cuda, model, tmp_path):
    """``run_local`` with no runner: the host's CUDA devices, captured
    steps; every adapter lands in the pool with a finite loss."""
    from repro_torch.sched import A100_40G, CostModel, ExecutionEngine, plan
    from repro_torch.train.checkpoint import CheckpointPool

    cfg, base = model
    cm = CostModel(cfg, A100_40G)
    sched = plan(cm, PACK, 1, SEQ, 2)
    pool = CheckpointPool(str(tmp_path))
    records, makespan = ExecutionEngine(cm, 1).run_local(
        sched, PACK, cfg, base, n_steps=2, seq=SEQ, pool=pool)
    assert makespan > 0 and len(records) == len(sched.jobs)
    assert pool.list() == [f"adapter_{i:04d}" for i in range(len(PACK))]
    assert all(np.isfinite(pool.load_meta(n)["final_loss"]) for n in pool.list())
    assert all(r.peak_bytes > 0 for r in records)


@pytest.mark.gpu
def test_online_run_with_a_preemption_equals_eager(cuda, model, tmp_path):
    """``run_online_local`` on captured steps: an arrival preempts the
    running pack, its adapter resumes from the pool in a new pack with a
    new shape (a recapture); the pool and every segment's losses equal the
    same plan run by the eager executor, bit for bit."""
    from repro_torch.sched import A100_40G, Arrival, CostModel, ExecutionEngine
    from repro_torch.train.checkpoint import CheckpointPool

    cfg, base = model
    cm = CostModel(cfg, A100_40G, setup_time=0.0)
    a, b = PACK[0], PACK[1]
    trace = [Arrival(0.0, a, 6), Arrival(2.5 * cm.iter_time([a], 1, SEQ), b, 5)]
    runs = []
    for capture in (True, False):
        pool = CheckpointPool(str(tmp_path / str(capture)))
        ex = SliceExecutor(capture=capture)
        records, sched = ExecutionEngine(cm, 1).run_online_local(
            trace, cfg, base, n_steps=6, seq=SEQ, pool=pool,
            runner=ClusterRunner(ex, DevicePool([cuda])), migration_budget=1,
            preempt_min_remaining=0.0)
        runs.append((records, sched, pool, ex))
    (crec, csched, cpool, cex), (erec, esched, epool, _) = runs
    assert csched.segments == esched.segments and csched.n_migrations == 1
    assert len(cex.captures) == 2  # the preempted pack's shape, then the resumed pack's
    assert sum(r.captured for r in crec) == 2 and not any(r.captured for r in erec)
    assert all(np.array_equal(x.final_losses, y.final_losses) for x, y in zip(crec, erec))
    assert 0 < cpool.load_adapter_state("0000")[1]["steps_done"] < 6
    assert cpool.list() == epool.list() == ["adapter_0000", "adapter_0001"]
    for name in cpool.list():
        assert cpool.load_meta(name)["total_steps"] == epool.load_meta(name)["total_steps"]
        assert all(np.array_equal(x, y) for x, y in zip(
            tree_leaves(cpool.load_adapter(name)), tree_leaves(epool.load_adapter(name))))


@pytest.mark.gpu
def test_a_step_that_cannot_be_captured_raises(cuda, model, monkeypatch):
    """A step that waits on the device (``.item()``) runs eagerly in the
    warm-up but cannot be captured: ``train_pack`` raises and caches no
    graph; nothing falls back to eager. (Last in the file: it leaves a
    failed capture behind.)"""
    cfg, base = model
    real = SliceExecutor._step_closure

    def syncing_closure(self, key, in_place):
        step = real(self, key, in_place)

        def syncing(*args):
            out = step(*args)
            out[2]["loss"].item()
            return out
        return syncing

    monkeypatch.setattr(SliceExecutor, "_step_closure", syncing_closure)
    ex = SliceExecutor()
    with pytest.raises(RuntimeError):
        _train(ex, cfg, base, PACK, cuda)
    assert ex.captures == [] and not ex._graphs
