"""The port's planning layer against the JAX package's, on the CPU.

The cost model, the knapsack/DTM packer, the planner and its baselines and
the profiled estimator are pure Python and numpy on both sides, so the port
is held to the reference exactly (``==``): the same configurations give the
same numbers, config ids, degrees and start/end times.
"""
import dataclasses
import json

import pytest

from repro.configs.base import default_search_space as j_space
from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.sched import cost_model as jcm
from repro.sched.dtm import dtm as j_dtm
from repro.sched.knapsack import brute_force as j_brute_force
from repro.sched.knapsack import solve_pack as j_solve_pack
from repro.sched.planner import max_gpu_schedule as j_max_gpu
from repro.sched.planner import min_gpu_schedule as j_min_gpu
from repro.sched.planner import plan as j_plan
from repro.sched.planner import replan as j_replan
from repro.sched.planner import sequential_plora_schedule as j_sequential
from repro.sched.profile import ObservationStore as JStore
from repro.sched.profile import ProfiledCostModel as JProfiled
from repro_torch.configs import LoraConfig, default_search_space, get_config, reduced
from repro_torch.sched import cost_model as tcm
from repro_torch.sched.dtm import dtm
from repro_torch.sched.knapsack import brute_force, solve_pack
from repro_torch.sched.planner import (
    max_gpu_schedule,
    min_gpu_schedule,
    plan,
    replan,
    sequential_plora_schedule,
)
from repro_torch.sched.profile import ObservationStore, ProfiledCostModel

HW = ("A100_40G", "A10_24G", "TPU_V5E")


def _cfgs(reduce: bool):
    j, t = j_get_config("qwen25-7b"), get_config("qwen25-7b")
    return (j_reduced(j), reduced(t)) if reduce else (j, t)


def _pair(jcfg, tcfg, hw: str, **kw):
    """The reference's model and the port's with the reference's memory
    accounting (the port's own prices its f32 state and logits: C3)."""
    return jcm.CostModel(jcfg, getattr(jcm, hw), **kw), tcm.CostModel(
        tcfg, getattr(tcm, hw), **tcm.REFERENCE_MEMORY, **kw)


def _space(idx, seq):
    """The same slice of ``default_search_space`` on both sides."""
    js, ts = j_space(300, seq_len=seq), default_search_space(300, seq_len=seq)
    return [js[i] for i in idx], [ts[i] for i in idx]


def test_default_search_space_matches_reference():
    js, ts = j_space(300, seq_len=512), default_search_space(300, seq_len=512)
    assert [c.key() + (c.seq_len,) for c in ts] == [c.key() + (c.seq_len,) for c in js]
    assert len(default_search_space()) == len(j_space()) == 120


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("hw", HW)
def test_cost_model_matches_reference(reduce, hw):
    jcfg, tcfg = _cfgs(reduce)
    assert tcm.model_param_count(tcfg) == jcm.model_param_count(jcfg)
    assert tcm.active_param_count(tcfg) == jcm.active_param_count(jcfg)
    jm, tm = _pair(jcfg, tcfg, hw)
    assert tm.base_weight_bytes() == jm.base_weight_bytes()
    js, ts = _space(range(0, 120, 7), 1024)
    for seq in (128, 1024):
        for jc, tc in zip(js, ts):
            assert tcm.lora_param_count(tcfg, tc.rank) == jcm.lora_param_count(jcfg, jc.rank)
            assert tm.lora_bytes(tc, seq) == jm.lora_bytes(jc, seq)
            assert tm.min_degree([tc], seq) == jm.min_degree([jc], seq)
        for k in (1, 3, len(ts)):
            for d in (1, 2, 8):
                assert tm.job_mem_bytes(ts[:k], d, seq) == jm.job_mem_bytes(js[:k], d, seq)
                assert tm.fits(ts[:k], d, seq) == jm.fits(js[:k], d, seq)
                assert tm.iter_time(ts[:k], d, seq) == jm.iter_time(js[:k], d, seq)
                assert (tm.iter_time_sequential(ts[:k], d, seq)
                        == jm.iter_time_sequential(js[:k], d, seq))
                assert tm.throughput(ts[:k], d, seq) == jm.throughput(js[:k], d, seq)
        assert tm.min_degree(ts, seq) == jm.min_degree(js, seq)
    for dtype in ("int8", "nf4"):
        jq, tq = _pair(jcfg, tcfg, hw, base_dtype=dtype)
        assert tq.iter_time(ts, 1, 1024) == jq.iter_time(js, 1, 1024)
        assert tq.job_mem_bytes(ts, 1, 1024) == jq.job_mem_bytes(js, 1, 1024)


def _jobs(sched):
    return [(tuple(j.config_ids), j.degree, j.start, j.end) for j in sched.jobs]


def _plans(res):
    return [dataclasses.astuple(j) for j in res.jobs], res.n_f_calls


# (space indices, devices, seq): a homogeneous slice; mixed ranks, batch sizes
# and learning rates on fewer devices; the chip's sweep space on one device
PLAN_CASES = {
    "first12_g8": (range(12), 8, 1024),
    "mixed_g4": (range(3, 120, 13), 4, 512),
    "sweep_g1": (range(0, 300, 37), 1, 512),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_planner_matches_reference(case):
    idx, g, seq = PLAN_CASES[case]
    jcfg, tcfg = _cfgs(False)
    jm, tm = _pair(jcfg, tcfg, "A100_40G")
    js, ts = _space(idx, seq)
    assert solve_pack(tm, ts, g, seq) == j_solve_pack(jm, js, g, seq)
    assert _plans(dtm(tm, ts, g, seq, 50)) == _plans(j_dtm(jm, js, g, seq, 50))
    residual = [5 + i for i in range(len(ts))]
    assert _plans(replan(tm, ts, g, seq, 50, residual_steps=residual)) == _plans(
        j_replan(jm, js, g, seq, 50, residual_steps=residual))
    tp, jp = plan(tm, ts, g, seq, 50), j_plan(jm, js, g, seq, 50)
    assert _jobs(tp) == _jobs(jp) and tp.makespan == jp.makespan
    assert tp.n_f_calls == jp.n_f_calls and tp.ar() == jp.ar()
    for port, ref in ((min_gpu_schedule, j_min_gpu), (max_gpu_schedule, j_max_gpu),
                      (sequential_plora_schedule, j_sequential)):
        t, j = port(tm, ts, g, seq, 50), ref(jm, js, g, seq, 50)
        assert _jobs(t) == _jobs(j) and t.makespan == j.makespan


def test_brute_force_matches_reference_on_the_reduced_model():
    jcfg, tcfg = _cfgs(True)
    jm, tm = _pair(jcfg, tcfg, "A10_24G")
    js, ts = _space(range(0, 120, 11), 256)
    assert brute_force(tm, ts, 1, 256) == j_brute_force(jm, js, 1, 256)
    assert solve_pack(tm, ts, 1, 256) == j_solve_pack(jm, js, 1, 256)


def test_h100_preset_plans_as_the_reference_on_the_same_spec():
    """The port's H100 preset has no reference counterpart: hold it to the
    reference's CostModel built on a HardwareSpec with the same values."""
    jcfg, tcfg = _cfgs(False)
    spec = jcm.HardwareSpec(**dataclasses.asdict(tcm.H100))
    jm, tm = jcm.CostModel(jcfg, spec), tcm.CostModel(tcfg, tcm.H100, **tcm.REFERENCE_MEMORY)
    assert (tcm.H100.mem_bytes, tcm.H100.peak_flops, tcm.H100.hbm_bw, tcm.H100.link_bw) == (
        80e9, 989e12, 3.35e12, 450e9)
    js, ts = _space(range(0, 300, 37), 512)
    tp, jp = plan(tm, ts, 1, 512, 4), j_plan(jm, js, 1, 512, 4)
    assert _jobs(tp) == _jobs(jp) and tp.makespan == jp.makespan
    # the reference planner, on the A100's fitted constants, makes two jobs
    assert [j.config_ids for j in tp.jobs] == [(5, 6, 7, 8), (4, 3, 2, 0, 1)]
    t, j = min_gpu_schedule(tm, ts, 1, 512, 4), j_min_gpu(jm, js, 1, 512, 4)
    assert _jobs(t) == _jobs(j)


def _observe(store_cls, profiled_cls, cm, configs):
    est = profiled_cls(cm, store_cls())
    for k, t in ((1, 0.5), (2, 0.7), (2, 0.9), (3, 1.3)):
        est.observe(configs[:k], 1, 512, t)
    est.observe(configs[:2], 2, 512, 0.4)
    est.observe(configs[:1], 1, 512, 0.6, host_class="slow")
    return est


def test_observation_store_crosses_packages(tmp_path):
    jcfg, tcfg = _cfgs(False)
    jm, tm = _pair(jcfg, tcfg, "A100_40G")
    js, ts = _space(range(0, 60, 9), 512)
    jest = _observe(JStore, JProfiled, jm, js)
    test = _observe(ObservationStore, ProfiledCostModel, tm, ts)
    assert test.store.to_json() == jest.store.to_json()
    for k in range(1, len(ts) + 1):
        for d in (1, 2, 4):
            assert test.iter_time(ts[:k], d, 512) == jest.iter_time(js[:k], d, 512)
            assert test.iter_time(ts[:k], d, 512, "slow") == jest.iter_time(js[:k], d, 512, "slow")
    assert test.drift(ts[:2], 1, 512, 1.0) == jest.drift(js[:2], 1, 512, 1.0)
    # JSON written by either package loads in the other, and prices alike
    jest.store.save(str(tmp_path / "ref.json"))
    test.store.save(str(tmp_path / "port.json"))
    from_ref = ProfiledCostModel(tm, ObservationStore.load(str(tmp_path / "ref.json")))
    from_port = JProfiled(jm, JStore.load(str(tmp_path / "port.json")))
    assert from_ref.store.to_json() == from_port.store.to_json() == jest.store.to_json()
    assert json.loads((tmp_path / "ref.json").read_text()) == json.loads(
        (tmp_path / "port.json").read_text())
    for k in range(1, len(ts) + 1):
        assert from_ref.iter_time(ts[:k], 2, 512) == from_port.iter_time(js[:k], 2, 512)
    assert from_ref.fits(ts, 1, 512) == jm.fits(js, 1, 512)


def _nbytes(tree) -> int:
    from repro_torch.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def test_port_memory_prices_what_the_executor_allocates():
    """The port's accounting (C3): ``lora_state_bytes`` per bucket-padded
    LoRA parameter is exactly the f32 LoRA, its two Adam moments and its
    gradient that ``SliceExecutor`` holds for a mixed pack (reduced size,
    CPU); ``job_mem_bytes`` covers them with the base, the padding rows'
    and the adapters' logits workspace and the per-job term. With
    ``REFERENCE_MEMORY`` it is the reference's number."""
    import numpy as np
    import torch

    from repro.configs.base import LoraConfig as JLoraConfig
    from repro_torch.cluster import DevicePool, SliceExecutor
    from repro_torch.configs import LoraConfig
    from repro_torch.core.adapter import pack_meta
    from repro_torch.models.model import init_model
    from repro_torch.train.data import packed_batch_iterator
    from repro_torch.train.trainer import packed_value_and_grad

    cpu = torch.device("cpu")
    jcfg, cfg = _cfgs(True)
    kw = [dict(rank=8, alpha=8.0, learning_rate=1e-3, batch_size=1, seq_len=16),
          dict(rank=32, alpha=16.0, learning_rate=5e-4, batch_size=2, seq_len=16),
          dict(rank=16, alpha=4.0, learning_rate=2e-4, batch_size=1, seq_len=16)]
    configs, jconfigs = [LoraConfig(**k) for k in kw], [JLoraConfig(**k) for k in kw]
    meta = pack_meta(configs)
    base, _ = init_model(0, cfg, None, device=cpu)
    res = SliceExecutor().train_pack(cfg, configs, n_steps=1, seq=16, base=base,
                                     slice_=DevicePool([cpu]).acquire(1))
    batch = next(packed_batch_iterator(cfg, configs, seq=16, device=cpu))
    grads = packed_value_and_grad(res.lora, base, batch, cfg, meta.n, meta.scales(cpu))[2]
    held = _nbytes(res.lora) + _nbytes(res.opt["m"]) + _nbytes(res.opt["v"]) + _nbytes(grads)
    cm = tcm.CostModel(cfg, tcm.A100_40G)
    params = meta.n * tcm.lora_param_count(cfg, meta.r_bucket)
    assert cm.lora_state_bytes * params == held
    logits = cm.logits_bytes(meta.n * meta.max_batch, 16)
    assert logits == cm.logits_copies * meta.n * meta.max_batch * 16 * cfg.padded_vocab * 4
    # the bf16 base the card trains on: the model counts its matrices (not
    # the norms and biases, under 1 %)
    assert 0.99 < cm.base_weight_bytes() / (_nbytes(base) / 2) <= 1.0
    assert cm.job_mem_bytes(configs, 1, 16) >= (cm.base_weight_bytes() + held + logits
                                                + cm.job_overhead_bytes)
    # the reference's accounting, passed explicitly, is the reference's
    jm = jcm.CostModel(jcfg, jcm.A100_40G)
    tm = tcm.CostModel(cfg, tcm.A100_40G, **tcm.REFERENCE_MEMORY)
    for seq in (16, 512, 4096):
        assert tm.job_mem_bytes(configs, 1, seq) == jm.job_mem_bytes(jconfigs, 1, seq)
        assert tm.logits_bytes(8, seq) == 0.0
    # at full width the port's accounting prices the sweep's two jobs 2.1x
    # and 1.7x above the reference's (their peaks on the card: 1.9x, 1.6x)
    full = tcm.CostModel(_cfgs(False)[1], tcm.H100)
    ref = tcm.CostModel(_cfgs(False)[1], tcm.H100, **tcm.REFERENCE_MEMORY)
    space = default_search_space(300, seq_len=512)[::37]
    for ids in ((5, 6, 7, 8), (4, 3, 2, 0, 1)):
        jc = [space[i] for i in ids]
        assert full.job_mem_bytes(jc, 1, 512) > 1.5 * ref.job_mem_bytes(jc, 1, 512)
    assert np.isfinite(res.losses).all()


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8", "nf4"])
def test_base_storage_names_the_tree(storage):
    """``kernels.quant.base_storage`` names a reduced base tree's storage as
    ``CostModel``'s ``base_dtype`` does: its dense dtype, or its
    quantization scheme whatever dtype its embeddings keep."""
    import torch

    from repro_torch.kernels.quant import base_storage, quantize_base_params
    from repro_torch.models.model import init_model

    dtype = torch.bfloat16 if storage == "bf16" else torch.float32
    base, _ = init_model(0, _cfgs(True)[1], None, dtype=dtype, device=torch.device("cpu"))
    if storage in ("int8", "nf4"):
        base = quantize_base_params(base, storage)
    assert base_storage(base) == storage
    for bad in ({"w": torch.zeros(2, dtype=torch.float16)},
                {"w": torch.zeros(2), "b": torch.zeros(2, dtype=torch.bfloat16)}):
        with pytest.raises(ValueError, match="one float32 or bfloat16"):
            base_storage(bad)


def test_f32_base_priced_at_its_own_size():
    """An f32 base is priced at 4 bytes a parameter, for its weights and for
    its activations (it computes in f32); None and "bf16" keep
    ``prec_bytes`` (2), and None, int8 and nf4 stay ``==`` to the
    reference's at full size."""
    jcfg, tcfg = _cfgs(False)
    js, ts = _space(range(0, 120, 11), 512)
    for dtype in (None, "int8", "nf4"):
        jm, tm = _pair(jcfg, tcfg, "A100_40G", base_dtype=dtype)
        assert tm.base_weight_bytes() == jm.base_weight_bytes()
        assert tm.base_act_bytes(4, 512) == jm.base_act_bytes(4, 512)
        assert tm.job_mem_bytes(ts, 1, 512) == jm.job_mem_bytes(js, 1, 512)
    none, bf16, f32 = (tcm.CostModel(tcfg, tcm.H100, base_dtype=d) for d in (None, "bf16", "f32"))
    assert none.base_bytes_per_param() == bf16.base_bytes_per_param() == 2.0
    assert f32.base_bytes_per_param() == 4.0 == tcm.base_param_bytes("f32")
    assert f32.base_weight_bytes() == 2 * none.base_weight_bytes()
    assert f32.base_act_bytes(4, 512) == 2 * none.base_act_bytes(4, 512)
    # the launcher's pack: ranks 8 and 16, batch 2 each, seq 512
    pack = [LoraConfig(rank=r, alpha=2.0 * r, learning_rate=1e-4, batch_size=2, seq_len=512)
            for r in (8, 16)]
    grown = f32.job_mem_bytes(pack, 1, 512) - none.job_mem_bytes(pack, 1, 512)
    assert grown == none.base_weight_bytes() + none.base_act_bytes(4, 512)
    assert 39e9 < f32.job_mem_bytes(pack, 1, 512) < 42e9  # a 40 GB peak on an H100
    with pytest.raises(ValueError, match="unknown base_dtype"):
        tcm.base_param_bytes("fp8")
