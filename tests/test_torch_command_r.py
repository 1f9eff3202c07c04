"""command-r-35b in the port against the JAX package, on the CPU.

The family adds no layer: a sequential pre-norm RMSNorm SwiGLU decoder with
GQA and tied embeddings, as the reference models it. What it brings is a
base that one card holds only quantized, so this file holds the quantized
path: the streamed init (``init_model(..., quant=)``) bit for bit against
dense-then-quantize, the forward, a packed step and the serve engine on an
int8 or nf4 base against the reference on the reference's own quantized
tree (carried across by ``repro_torch.bridge``), the launcher's ``--quant``
tree, and the reference's command-r-35b cost-model and planner cases.

Reduced command-r-35b (kv4: ``reduced`` gives 4/4 heads) and its
n_kv_heads=2 variant; LoRA + 0.02 N(0, 1) from a seed, so every delta and
every gradient is non-zero. Tolerances: f32 at full f32 (no TF32):
whole-model logits 1e-4 of max |logit|, a packed step's per-adapter loss
and every LoRA gradient 1e-4 of the largest value of the compared array;
bf16 logits 3e-2 of max |logit| (every projection output rounds to bf16,
on each side in its own order, and the port's fused op keeps xA in f32
where the reference's XLA form rounds it). Served greedy tokens are equal.
"""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LoraConfig as JLoraConfig
from repro.configs.base import default_search_space as j_space
from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.core.adapter import pack_meta as j_pack_meta
from repro.core.packed_lora import extract_adapter as j_extract
from repro.kernels.ops import KernelConfig as JKernelConfig
from repro.kernels.quant import quantize_base_params as j_quantize_base_params
from repro.models import model as jm
from repro.sched import cost_model as jcm
from repro.sched.engine import ExecutionEngine as JEngine
from repro.sched.engine import poisson_trace as j_poisson_trace
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import ServeExecutor as JServeExecutor
from repro.serve.engine import ServeRequest as JServeRequest
from repro.train.data import packed_batch_iterator as j_batches
from repro.train.trainer import packed_loss_fn as j_packed_loss_fn
from repro_torch import bridge
from repro_torch.cluster import SliceExecutor
from repro_torch.configs import LoraConfig, default_search_space, get_config, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.kernels.ops import KernelConfig
from repro_torch.kernels.quant import quantize_base_params
from repro_torch.launch import train as launch_train
from repro_torch.models import model as tm
from repro_torch.sched import cost_model as tcm
from repro_torch.sched.engine import ExecutionEngine, poisson_trace
from repro_torch.sched.knapsack import solve_pack
from repro_torch.serve import ServeEngine, ServeRequest
from repro_torch.train.data import packed_batch_iterator
from repro_torch.train.trainer import packed_value_and_grad
from repro_torch.tree import tree_leaves

ARCH = "command-r-35b"
LOGITS = {"f32": 1e-4, "bf16": 3e-2}
STEP = 1e-4
NB, S = 4, 10
PACK = [dict(rank=8, alpha=8.0, learning_rate=1e-3, batch_size=2),
        dict(rank=16, alpha=4.0, learning_rate=5e-4, batch_size=2)]
MODES = ("int8", "nf4")


def _cfgs(kv=None, reduce=True):
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    if reduce:
        jc, tc = j_reduced(jc), reduced(tc)
    if kv is not None:
        jc = jc.replace(attention=dataclasses.replace(jc.attention, n_kv_heads=kv))
        tc = tc.replace(attention=dataclasses.replace(tc.attention, n_kv_heads=kv))
    return jc, tc


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))


def _close(got, want, rtol):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _bf16(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)


def _same_tree(got, want) -> bool:
    a, b = tree_leaves(got), tree_leaves(want)
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module", params=[None, 2], ids=["kv4", "kv2"])
def world(request):
    """The reference's model of the pack (f32), its LoRA perturbed from a
    seed; the quantized bases are made on demand, by the reference."""
    jcfg, cfg = _cfgs(request.param)
    jmeta = j_pack_meta([JLoraConfig(**c) for c in PACK])
    meta = pack_meta([LoraConfig(**c) for c in PACK])
    base, lora = jm.init_model(jax.random.PRNGKey(0), jcfg, jmeta)
    rng = np.random.RandomState(7)
    lora = jax.tree.map(lambda x: x + 0.02 * rng.standard_normal(x.shape).astype(np.float32), lora)
    return dict(jcfg=jcfg, cfg=cfg, jmeta=jmeta, meta=meta, base=_host(base), lora=_host(lora))


def _quantized(world, mode, dtype="f32"):
    """The reference's tree quantized by the reference (its dense leaves in
    ``dtype`` first: a bf16 base is quantized from its bf16 values), and the
    LoRA tree in ``dtype``, as (JAX trees, port trees)."""
    key = ("q", mode, dtype)
    if key not in world:
        base, lora = world["base"], world["lora"]
        if dtype == "bf16":
            base, lora = _bf16(base), _bf16(lora)
        qbase = _host(j_quantize_base_params(base, mode))
        world[key] = (qbase, lora), (bridge.to_torch(qbase, "cpu"), bridge.to_torch(lora, "cpu"))
    return world[key]


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_config_matches_reference_field_for_field(reduce):
    """Every field the port's config has equals the reference's (published
    dimensions; ``reduced``'s rules); the base is the reference's 30.28 B
    parameters."""
    jc, tc = _cfgs(reduce=reduce)
    for f in dataclasses.fields(tc):
        if f.name == "attention":
            for af in dataclasses.fields(tc.attention):
                assert getattr(tc.attention, af.name) == getattr(jc.attention, af.name), af.name
        else:
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert (tc.mlp_kind, tc.norm_kind, tc.tie_embeddings) == ("swiglu", "rmsnorm", True)
    if not reduce:
        assert tcm.model_param_count(tc) == jcm.model_param_count(jc) == 30_282_874_880


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_streamed_init_equals_dense_then_quantize(mode, dtype):
    """``init_model(..., quant=mode)`` quantizes layer by layer as it draws,
    and gives ``quantize_base_params(init_model(...), mode)`` bit for bit
    (codes, scales, the dense embedding and norms), with the LoRA tree of
    the dense init unchanged; on kv4 and kv2, two seeds."""
    meta = pack_meta([LoraConfig(**c) for c in PACK])
    for kv in (None, 2):
        _, cfg = _cfgs(kv)
        for seed in (0, 3):
            qbase, qlora = tm.init_model(seed, cfg, meta, dtype, "cpu", quant=mode)
            base, lora = tm.init_model(seed, cfg, meta, dtype, "cpu")
            want = quantize_base_params(base, mode)
            assert _same_tree(qbase, want)
            assert _same_tree(qlora, lora)
            assert _same_tree(tm.init_lora(seed, cfg, meta, dtype, "cpu"), lora)
            w = qbase["decoder"]["blocks"]["l0"]["mlp"]["gate"]["w"]
            assert w["codes"].dtype == (torch.int8 if mode == "int8" else torch.uint8)
            assert w["codes"].shape[0] == cfg.n_layers and qbase["embed"]["w"].dtype == dtype
            assert "lm_head" not in qbase  # tied: the embedding's transpose
    assert _same_tree(tm.init_model(1, cfg, meta, dtype, "cpu", quant="none")[0],
                      tm.init_model(1, cfg, meta, dtype, "cpu")[0])


# sha256 of the reduced families' init_model trees (ranks 8 and 16, seed 0;
# each leaf's path, shape, dtype and bytes in the tree's order), taken on
# the tree before the streamed init: their numbers in PERF.md rest on them
FAMILY_INIT_DIGESTS = {
    "starcoder2-7b": ("95320762a894c5405f9e2d70734fdadd6f848e623005adec93cef620a8300d38",
                      "128f3d20989a02c3a5a34f63a7de563a7fe64534b5907be3d84d4dff66ee7499"),
    "gemma3-1b": ("24c9f7dbfb3c8d2ffdfb3a9dde52f32d49835b215dc53f97b145ef40900302de",
                  "077992b762c3e9ca8b55b64f3cd3351696fe5e4d5d4e6a90745f7a271d3d1eba"),
}


def _digest(tree) -> str:
    h = hashlib.sha256()

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        else:
            h.update(f"{path}:{tuple(t.shape)}:{t.dtype}".encode())
            h.update(t.contiguous().numpy().tobytes())

    walk(tree, "")
    return h.hexdigest()


@pytest.mark.parametrize("arch", sorted(FAMILY_INIT_DIGESTS))
def test_family_random_init_is_unchanged(arch):
    """The streamed init leaves the dense families' trees as they were (the
    embedding is scaled in place: the same products)."""
    meta = pack_meta([LoraConfig(rank=8, alpha=8.0), LoraConfig(rank=16, alpha=4.0)])
    base, lora = tm.init_model(0, reduced(get_config(arch)), meta, device="cpu")
    assert (_digest(base), _digest(lora)) == FAMILY_INIT_DIGESTS[arch]


def _tokens(cfg, seed=4, s=S):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(NB, s)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_forward_logits_on_quantized_base(world, mode, dtype):
    """The forward on the reference's int8 / nf4 tree: both impls of the
    port (auto dequantizes each projection per call; fused takes the codes
    to the fused op) against the reference's, per dtype."""
    jc, tc = world["jcfg"], world["cfg"]
    (jbase, jlora), (tbase, tlora) = _quantized(world, mode, dtype)
    toks = _tokens(jc)
    for impl, jimpl in (("auto", None), ("fused", "fused_xla")):
        jh, _, _ = jm.forward(jbase, jlora, world["jmeta"].scales(), {"tokens": jnp.asarray(toks)},
                              jc, n_pack=2, kcfg=JKernelConfig(impl=jimpl, base_dtype=mode))
        want = jm.logits(jbase, jh, jc)
        th, _, _ = tm.forward(tbase, tlora, world["meta"].scales(), {"tokens": torch.from_numpy(toks)},
                           tc, n_pack=2, kcfg=KernelConfig(impl=impl, base_dtype=mode))
        got = tm.logits(tbase, th, tc)
        assert got.shape == (NB, S, tc.padded_vocab) and got.dtype == tbase["embed"]["w"].dtype
        _close(got, want, LOGITS[dtype])


@pytest.mark.parametrize("mode", MODES)
def test_packed_step_on_quantized_base_matches_reference(world, mode):
    """``packed_value_and_grad`` (what ``make_packed_step`` runs) on the
    reference's quantized tree, under auto and fused: per-adapter loss and
    every LoRA gradient against the reference's step on the same tree."""
    jc, tc, jmeta, meta = world["jcfg"], world["cfg"], world["jmeta"], world["meta"]
    (jbase, jlora), (tbase, tlora) = _quantized(world, mode)
    jb = next(j_batches(jc, [JLoraConfig(**c) for c in PACK], seq=16))
    (_, jper), jgrads = jax.jit(jax.value_and_grad(
        lambda lo: j_packed_loss_fn(lo, jbase, jb, jc, 2, jmeta.scales(),
                                    kcfg=jmeta.kernel_config(base_dtype=mode)),
        has_aux=True))(jlora)
    want = jax.tree_util.tree_leaves(jgrads)
    tb = next(packed_batch_iterator(tc, [LoraConfig(**c) for c in PACK], seq=16, device="cpu"))
    for impl in ("auto", "fused"):
        _, per, grads = packed_value_and_grad(
            tlora, tbase, tb, tc, 2, meta.scales("cpu"),
            kcfg=KernelConfig(impl=impl, ranks=meta.ranks, base_dtype=mode))
        _close(per, jper, STEP)
        got = jax.tree_util.tree_leaves(bridge.to_numpy(grads))
        assert len(got) == len(want) == 7 * 2  # q, k, v, o, gate, up, down: (a, b) each
        for g, w in zip(got, want):
            _close(g, w, STEP)


@pytest.mark.parametrize("world", [2], indirect=True, ids=["kv2"])
@pytest.mark.parametrize("mode,impl", [("int8", "auto"), ("int8", "fused"), ("nf4", "fused")])
def test_serve_engine_on_quantized_base_matches_reference(world, mode, impl):
    """``ServeEngine(base_dtype=...)`` on the reference's quantized tree
    emits the reference engine's greedy tokens (same adapters, prompts and
    arrivals; the reference on the CPU runs its XLA forms)."""
    jc, tc = world["jcfg"], world["cfg"]
    (jbase, _), (tbase, _) = _quantized(world, mode)
    rank, alpha = 8, 16.0
    meta = j_pack_meta([JLoraConfig(rank=rank, alpha=alpha)] * 3)
    _, lora = jm.init_model(jax.random.PRNGKey(1), jc, meta)
    lora = jax.tree.map(lambda x: x + 0.02, lora)
    adapters = {f"ad{i}": j_extract(lora, i) for i in range(3)}
    prompts = [np.random.RandomState(1).randint(0, jc.vocab_size, size=7).astype(np.int32)
               for _ in range(5)]
    kw = dict(rows=2, smax=32, r_bucket=rank)
    jeng = JServeEngine(jc, jbase, serve_executor=JServeExecutor(),
                        impl=None if impl == "auto" else impl, base_dtype=mode, **kw)
    eng = ServeEngine(tc, tbase, device="cpu", impl=impl, base_dtype=mode, **kw)
    assert eng.kcfg.base_dtype == mode and eng.kcfg1.base_dtype == mode
    for e in (jeng, eng):
        for aid, tree in adapters.items():
            e.publish(aid, tree, {"rank": rank, "alpha": alpha})
    want = jeng.serve([JServeRequest(i, f"ad{i % 3}", p, max_new_tokens=5, arrival=float(i))
                       for i, p in enumerate(prompts)])
    got = eng.serve([ServeRequest(i, f"ad{i % 3}", p, max_new_tokens=5, arrival=float(i))
                     for i, p in enumerate(prompts)])
    assert [r.request_id for r in got.results] == [r.request_id for r in want.results]
    for a, b in zip(got.results, want.results):
        assert a.error is None and b.error is None
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert got.steps == want.steps and got.tokens_emitted == want.tokens_emitted


def test_serve_engine_refuses_a_base_dtype_its_tree_lacks():
    _, cfg = _cfgs()
    base, _ = tm.init_model(0, cfg, None, device="cpu", quant="int8")
    with pytest.raises(ValueError, match="stored as 'int8'"):
        ServeEngine(cfg, base, device="cpu", base_dtype="nf4")
    dense, _ = tm.init_model(0, cfg, None, device="cpu")
    with pytest.raises(ValueError, match="stored as 'f32'"):
        ServeEngine(cfg, dense, device="cpu", base_dtype="int8")
    assert ServeEngine(cfg, base, device="cpu", remat="recompute").kcfg.remat == "recompute"


@pytest.mark.parametrize("mode", MODES)
def test_launcher_quant_trains_on_the_streamed_tree(mode):
    """``--arch command-r-35b --reduced --quant mode``: the tree the
    launcher hands its executor is dense-then-quantize's, bit for bit, and
    the losses are finite."""
    seen = []

    class Recording(SliceExecutor):
        def train_pack(self, *args, **kw):
            seen.append((kw["base"], kw["base_dtype"]))
            return super().train_pack(*args, **kw)

    per = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "1",
                             "--seq", "16", "--log-every", "0", "--quant", mode],
                            executor=Recording(capture=False))
    assert per.shape == (2,) and np.isfinite(per).all()
    (base, policy), = seen
    meta = pack_meta([LoraConfig(rank=r, alpha=2.0 * r, learning_rate=lr, batch_size=1,
                                 seq_len=16) for r, lr in ((8, 1e-3), (16, 5e-4))])
    want, _ = tm.init_model(0, reduced(get_config(ARCH)), meta, device="cpu")
    assert policy == mode and _same_tree(base, quantize_base_params(want, mode))


@pytest.mark.parametrize("base_dtype", [None, "int8", "nf4"], ids=["bf16", "int8", "nf4"])
@pytest.mark.parametrize("hw", ["A100_40G", "H100"])
def test_cost_model_matches_reference(hw, base_dtype):
    """Counts and prices at full width, under ``REFERENCE_MEMORY``: the
    reference's, ``==``, for each base storage (the port's H100 preset
    against the same specification on the reference's side)."""
    jc, tc = _cfgs(reduce=False)
    spec = getattr(jcm, hw) if hasattr(jcm, hw) else jcm.HardwareSpec(
        **{f.name: getattr(tcm.H100, f.name) for f in dataclasses.fields(tcm.H100)})
    jmod = jcm.CostModel(jc, spec, base_dtype=base_dtype)
    tmod = tcm.CostModel(tc, getattr(tcm, hw), base_dtype=base_dtype, **tcm.REFERENCE_MEMORY)
    assert tmod.base_weight_bytes() == jmod.base_weight_bytes()
    js, ts = j_space(300, seq_len=512)[::37], default_search_space(300, seq_len=512)[::37]
    for r in (8, 16, 32, 128):
        assert tcm.lora_param_count(tc, r) == jcm.lora_param_count(jc, r)
    for k in (1, 2, 4, len(ts)):
        for d in (1, 2, 4, 8):
            assert tmod.job_mem_bytes(ts[:k], d, 512) == jmod.job_mem_bytes(js[:k], d, 512)
            assert tmod.iter_time(ts[:k], d, 512) == jmod.iter_time(js[:k], d, 512)
        assert tmod.min_degree(ts[:k], 512) == jmod.min_degree(js[:k], 512)


def test_a_35b_base_does_not_fit_one_a100_40g():
    """The reference's planner cases: ``min_degree >= 2`` and no pack on one
    A100 40G (``tests/test_sched.py``), on the port's own memory
    accounting and on the reference's; one H100 holds it only quantized."""
    _, tc = _cfgs(reduce=False)
    c = LoraConfig(rank=32, alpha=32, batch_size=1, seq_len=1024)
    for mem in ({}, tcm.REFERENCE_MEMORY):
        cm = tcm.CostModel(tc, tcm.A100_40G, **mem)
        assert cm.min_degree([c], 1024) >= 2
        assert solve_pack(cm, default_search_space(5, 1024), 1, 1024) is None
    pack = [LoraConfig(rank=r, alpha=2.0 * r, batch_size=b, seq_len=512)
            for r, b in zip((8, 16, 16, 32), (1, 2, 1, 2))]  # the chip smoke's train pack
    assert not tcm.CostModel(tc, tcm.H100).fits(pack, 1, 512)
    for mode in MODES:
        assert tcm.CostModel(tc, tcm.H100, base_dtype=mode).fits(pack, 1, 512)


def test_plan_online_matches_reference():
    """``plan_online`` on the memory-bound 35B model (packs split across
    degrees; ``tests/test_online_engine.py``'s workload) makes the
    reference's segments, makespan and counts."""
    jc, tc = _cfgs(reduce=False)
    n, seq, steps_budget = 16, 1024, 1000
    steps = np.random.RandomState(0).choice([200, 500, 1000, 2000, 4000], size=n)
    jt = j_poisson_trace(j_space(n, seq), 800.0, seed=1, steps=steps)
    tt = poisson_trace(default_search_space(n, seq), 800.0, seed=1, steps=steps)
    ref = JEngine(jcm.CostModel(jc, jcm.A100_40G), 8).plan_online(jt, seq, steps_budget,
                                                                  migration_budget=2)
    port = ExecutionEngine(tcm.CostModel(tc, tcm.A100_40G, **tcm.REFERENCE_MEMORY), 8).plan_online(
        tt, seq, steps_budget, migration_budget=2)
    assert [dataclasses.astuple(s) for s in port.segments] == [
        dataclasses.astuple(s) for s in ref.segments]
    assert (port.makespan, port.completed, port.total_steps) == (
        ref.makespan, ref.completed, ref.total_steps)
    assert (port.n_repacks, port.n_migrations) == (ref.n_repacks, ref.n_migrations)
    assert max(s.degree for s in port.segments) >= 2
