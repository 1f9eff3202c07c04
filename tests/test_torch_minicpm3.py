"""minicpm3-4b in the port against the JAX package, on the CPU.

The family brings multi-head latent attention (MLA): q through a low-rank
``q_a`` -> RMSNorm -> ``q_b``, k/v through a compressed latent ``kv_a`` ->
RMSNorm -> ``kv_b_k`` / ``kv_b_v``, q/k heads of a "nope" part and a
rotated part shared by every head, v heads narrower than q/k. Train and
prefill expand the latent; decode attends in the latent space (the absorbed
decode). LoRA targets "q" and "kv" adapt ``q_a`` and ``kv_a``.

Reduced minicpm3-4b (2 layers, d 256, 4 heads, q rank 48, kv rank 32, q/k
heads of 16 nope + 16 rope, v heads of 32); weights from the reference's
``init_model`` (LoRA + 0.02 N(0, 1) from a seed) through
``repro_torch.bridge``. Tolerances, f32 at full f32 (no TF32): one MLA
layer rtol/atol 1e-5; whole-model logits 1e-4 of max |logit|; a packed
step's per-adapter loss and every LoRA gradient 1e-4 of the largest value
of the compared array; the absorbed decode against the same model's
prefill 2e-3 (the reference's own check, ``tests/test_attention.py``: the
absorbed form reassociates the products); served greedy tokens equal.
"""
import dataclasses

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
from repro.models.layers import attention as jattn
from repro.models.layers.rope import rope_tables as j_rope_tables
from repro.sched import cost_model as jcm
from repro.sched.planner import plan as j_plan
from repro.serve.decode import pad_caches as j_pad
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import ServeExecutor as JServeExecutor
from repro.serve.engine import ServeRequest as JServeRequest
from repro.train.data import packed_batch_iterator as j_batches
from repro.train.trainer import packed_loss_fn as j_packed_loss_fn
from repro_torch import bridge
from repro_torch.configs import LoraConfig, default_search_space, get_config, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.kernels.ops import KernelConfig
from repro_torch.kernels.quant import is_quantized, quantize_base_params
from repro_torch.launch import train as launch_train
from repro_torch.models import model as tm
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers.rope import rope_tables
from repro_torch.sched import cost_model as tcm
from repro_torch.sched.planner import plan
from repro_torch.serve import ServeEngine, ServeRequest
from repro_torch.serve.decode import pad_caches
from repro_torch.train.checkpoint import CheckpointPool
from repro_torch.train.data import packed_batch_iterator
from repro_torch.train.trainer import packed_value_and_grad
from repro_torch.tree import tree_leaves

ARCH = "minicpm3-4b"
F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = 1e-4
STEP = 1e-4
ABSORBED = dict(rtol=2e-3, atol=2e-3)
NB, S, CHUNK_Q = 4, 40, 16
PACK = [dict(rank=8, alpha=8.0, learning_rate=1e-3, batch_size=2),
        dict(rank=16, alpha=4.0, learning_rate=5e-4, batch_size=2)]


def _cfgs(reduce=True):
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    return (j_reduced(jc), reduced(tc)) if reduce else (jc, tc)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))


def _close(got, want, rtol):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return bridge.to_torch(_host(tree), "cpu")


@pytest.fixture(scope="module")
def world():
    jcfg, cfg = _cfgs()
    jmeta = j_pack_meta([JLoraConfig(**c) for c in PACK])
    meta = pack_meta([LoraConfig(**c) for c in PACK])
    base, lora = jm.init_model(jax.random.PRNGKey(0), jcfg, jmeta)
    rng = np.random.RandomState(7)
    lora = jax.tree.map(lambda x: x + 0.02 * rng.standard_normal(x.shape).astype(np.float32), lora)
    base, lora = _host(base), _host(lora)
    return dict(jcfg=jcfg, cfg=cfg, jmeta=jmeta, meta=meta, base=base, lora=lora,
                tbase=_port(base), tlora=_port(lora))


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_config_matches_reference_field_for_field(reduce):
    """Every field the port's config has equals the reference's, the MLA
    widths too (published, and ``reduced``'s 48 / 32 / 16 / 16 / 32)."""
    jc, tc = _cfgs(reduce=reduce)
    for f in dataclasses.fields(tc):
        if f.name == "attention":
            for af in dataclasses.fields(tc.attention):
                assert getattr(tc.attention, af.name) == getattr(jc.attention, af.name), af.name
        else:
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    a = tc.attention
    assert a.is_mla and (tc.mlp_kind, tc.norm_kind, tc.tie_embeddings) == ("swiglu", "rmsnorm",
                                                                           False)
    assert tc.lora_targets == ("q", "kv", "o", "gate", "up", "down")
    if reduce:
        assert (a.q_lora_rank, a.kv_lora_rank, a.qk_nope_head_dim, a.qk_rope_head_dim,
                a.v_head_dim, tc.n_layers) == (48, 32, 16, 16, 32, 2)
    else:
        assert tcm.model_param_count(tc) == jcm.model_param_count(jc) == 4_261_519_360
        assert not get_config("qwen25-7b").attention.is_mla


def test_param_and_cache_trees_match_reference_layout(world):
    """``init_model``'s base and LoRA trees, ``lora_zeros`` and the decode
    caches have the reference's leaves and shapes (``q_a``, ``q_norm``,
    ``q_b``, ``kv_a``, ``kv_norm``, ``kv_b_k``, ``kv_b_v``, ``o``; LoRA on
    ``q_a``, ``kv_a``, ``o``; caches ``ckv`` and ``k_rope``)."""
    jc, tc, meta = world["jcfg"], world["cfg"], world["meta"]
    tbase, tlora = tm.init_model(0, tc, meta, device="cpu")

    def shapes(tree):
        return jax.tree.map(lambda t: tuple(t.shape), tree)

    assert shapes(bridge.to_numpy(tbase)) == shapes(world["base"])
    assert shapes(bridge.to_numpy(tlora)) == shapes(world["lora"])
    assert shapes(bridge.to_numpy(tm.lora_zeros(tc, meta, device="cpu"))) == shapes(world["lora"])
    assert set(tlora["decoder"]["blocks"]["l0"]["attn"]) == {"q_a", "kv_a", "o"}
    lora = tm.init_lora(0, tc, meta, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(lora), tree_leaves(tlora)))
    want = jm.init_caches(jc, NB, 24, jnp.float32)
    got = tm.init_caches(tc, NB, 24, torch.float32, device="cpu")
    assert shapes(bridge.to_numpy(got)) == shapes(_host(want))
    assert set(got["blocks"]["l0"]["attn"]) == {"ckv", "k_rope"}


def _layer(world):
    """The first layer's MLA params and LoRA (the reference's), as (JAX,
    port) pairs, and the module's inputs: x (NB, S, d) from a seed."""
    jp = jax.tree.map(lambda t: t[0], world["base"]["decoder"]["blocks"]["l0"]["attn"])
    jl = jax.tree.map(lambda t: t[0], world["lora"]["decoder"]["blocks"]["l0"]["attn"])
    x = (0.5 * np.random.RandomState(3).standard_normal((NB, S, world["cfg"].d_model))).astype(
        np.float32)
    return (jp, jl), (_port(jp), _port(jl)), x


def _ropes(acfg, positions):
    jr = j_rope_tables(jnp.asarray(positions), acfg.qk_rope_head_dim, acfg.rope_theta)
    tr = rope_tables(torch.from_numpy(np.asarray(positions)), acfg.qk_rope_head_dim,
                     acfg.rope_theta)
    return jr, tr


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_apply_mla_train_path_matches_reference(world, impl):
    """One MLA layer over S = 40 in query chunks of 16: the latent expanded
    through kv_b_k / kv_b_v (K 32 wide, V 32: the port takes V's width from
    V), the output and the prefill caches (ckv, k_rope)."""
    acfg, jmeta, meta = world["cfg"].attention, world["jmeta"], world["meta"]
    (jp, jl), (tp, tl), x = _layer(world)
    jr, tr = _ropes(acfg, np.arange(S))
    want, jc = jattn.apply_mla(jp, jl, jmeta.scales(), jnp.asarray(x), acfg=world["jcfg"].attention,
                               n_pack=2, rope=jr, make_cache=True, chunk_q=CHUNK_Q)
    got, tc = tattn.apply_mla(tp, tl, meta.scales("cpu"), torch.from_numpy(x), acfg=acfg,
                              n_pack=2, rope=tr, make_cache=True, chunk_q=CHUNK_Q,
                              kcfg=KernelConfig(impl=impl))
    assert got.shape == (NB, S, world["cfg"].d_model)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    for k in ("ckv", "k_rope"):
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **F32)


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
def test_apply_mla_absorbed_decode_matches_reference(world, per_row):
    """The absorbed decode against the reference's: prefill caches of S
    tokens padded to S + 8, then three single-token steps at a shared
    position or at per-row positions (each row written in place at its own
    slot); the outputs and the updated caches. And the port's own absorbed
    decode, token by token from an empty cache over the first 20
    positions, against its train path (the reference's check,
    ``tests/test_attention.py:173-197``)."""
    jacfg, acfg = world["jcfg"].attention, world["cfg"].attention
    jmeta, meta = world["jmeta"], world["meta"]
    (jp, jl), (tp, tl), x = _layer(world)
    js, ts = jmeta.scales(), meta.scales("cpu")
    jr, _ = _ropes(acfg, np.arange(S))
    _, jc = jattn.apply_mla(jp, jl, js, jnp.asarray(x), acfg=jacfg, n_pack=2, rope=jr,
                            make_cache=True, chunk_q=CHUNK_Q)
    jc = j_pad(jc, S + 8)
    tc = bridge.to_torch(_host(jc), "cpu")
    pos = np.array([S, S - 3, S - 1, S - 7]) if per_row else np.array(S)
    step = (0.5 * np.random.RandomState(5).standard_normal((NB, 1, x.shape[-1]))).astype(np.float32)
    for _ in range(3):
        rp = pos[:, None] if per_row else pos[None]
        jr, tr = _ropes(acfg, rp)
        want, jc = jattn.apply_mla(jp, jl, js, jnp.asarray(step), acfg=jacfg, n_pack=2, rope=jr,
                                   cache=jc, pos=jnp.asarray(pos))
        got, tc = tattn.apply_mla(tp, tl, ts, torch.from_numpy(step), acfg=acfg, n_pack=2,
                                  rope=tr, cache=tc, pos=torch.from_numpy(pos))
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        for k in ("ckv", "k_rope"):
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **F32)
        pos = np.asarray(pos + 1)
    _, tr = _ropes(acfg, np.arange(S))
    full, _ = tattn.apply_mla(tp, tl, ts, torch.from_numpy(x), acfg=acfg, n_pack=2, rope=tr,
                              chunk_q=CHUNK_Q)
    cache = tattn.init_mla_cache(NB, S, acfg, torch.float32)
    outs = []
    for t in range(S // 2):
        _, tr = _ropes(acfg, np.array([t]))
        o, cache = tattn.apply_mla(tp, tl, ts, torch.from_numpy(x[:, t:t + 1]), acfg=acfg,
                                   n_pack=2, rope=tr, cache=cache, pos=torch.tensor(t))
        outs.append(o)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full[:, : S // 2]), **ABSORBED)
    with pytest.raises(ValueError, match="one token per row"):
        tattn.apply_mla(tp, tl, ts, torch.from_numpy(x[:, :2]), acfg=acfg, n_pack=2,
                        rope=_ropes(acfg, np.arange(2))[1], cache=cache,
                        pos=torch.zeros((NB,), dtype=torch.long))
    # a scalar position takes a prefill chunk: the second half in two chunks
    # on the cache the steps above filled, expanded as the train path does
    outs = []
    for p0 in (S // 2, 3 * S // 4):
        o, cache = tattn.apply_mla(tp, tl, ts, torch.from_numpy(x[:, p0:p0 + S // 4]), acfg=acfg,
                                   n_pack=2, rope=_ropes(acfg, np.arange(p0, p0 + S // 4))[1],
                                   cache=cache, pos=torch.tensor(p0))
        outs.append(o)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full[:, S // 2:]), **F32)


def _tokens(cfg, seed=4, s=S):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(NB, s)).astype(np.int32)


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_forward_logits_match_reference(world, impl):
    """The whole model at S = 40 over query chunks of 16, under both impls,
    against the reference's default one (the fused op keeps xA in f32:
    within the tolerance)."""
    jc, tc = world["jcfg"], world["cfg"]
    toks = _tokens(jc)
    if "forward" not in world:
        jh, _, _ = jm.forward(world["base"], world["lora"], world["jmeta"].scales(),
                              {"tokens": jnp.asarray(toks)}, jc, n_pack=2, chunk_q=CHUNK_Q)
        world["forward"] = jm.logits(world["base"], jh, jc)
    th, _, _ = tm.forward(world["tbase"], world["tlora"], world["meta"].scales(),
                       {"tokens": torch.from_numpy(toks)}, tc, n_pack=2, chunk_q=CHUNK_Q,
                       kcfg=KernelConfig(impl=impl))
    got = tm.logits(world["tbase"], th, tc)
    assert got.shape == (NB, S, tc.padded_vocab)
    _close(got, world["forward"], LOGITS)


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_packed_step_loss_and_grads_match_reference(world, impl):
    """A packed step's per-adapter loss and every LoRA gradient (q_a, kv_a,
    o, gate, up, down) against the reference's, on its batch stream."""
    jc, tc, jmeta, meta = world["jcfg"], world["cfg"], world["jmeta"], world["meta"]
    if "step" not in world:
        jb = next(j_batches(jc, [JLoraConfig(**c) for c in PACK], seq=S))
        (_, jper), jgrads = jax.jit(jax.value_and_grad(
            lambda lo: j_packed_loss_fn(lo, world["base"], jb, jc, 2, jmeta.scales(),
                                        chunk_q=CHUNK_Q, kcfg=jmeta.kernel_config()),
            has_aux=True))(world["lora"])
        world["step"] = jper, jax.tree_util.tree_leaves(jgrads)
    jper, want = world["step"]
    tb = next(packed_batch_iterator(tc, [LoraConfig(**c) for c in PACK], seq=S, device="cpu"))
    _, per, grads = packed_value_and_grad(
        world["tlora"], world["tbase"], tb, tc, 2, meta.scales("cpu"), chunk_q=CHUNK_Q,
        kcfg=KernelConfig(impl=impl, ranks=meta.ranks))
    _close(per, jper, STEP)
    got = jax.tree_util.tree_leaves(bridge.to_numpy(grads))
    assert len(got) == len(want) == 6 * 2  # 6 projections x (a, b), the 2 layers stacked
    for g, w in zip(got, want):
        assert np.abs(_np(w)).max() > 0
        _close(g, w, STEP)


def test_prefill_then_decode_steps_match_reference(world):
    """``prefill`` of 40 tokens (the last position's logits, the latent
    caches), then three ``decode_step``s at per-row positions through the
    absorbed decode, on the reference's padded caches."""
    jc, tc = world["jcfg"], world["cfg"]
    toks = _tokens(jc, seed=6)
    jlg, jcaches = jm.prefill(world["base"], world["lora"], world["jmeta"].scales(),
                              {"tokens": jnp.asarray(toks)}, jc, n_pack=2, chunk_q=CHUNK_Q)
    tlg, tcaches = tm.prefill(world["tbase"], world["tlora"], world["meta"].scales(),
                              {"tokens": torch.from_numpy(toks)}, tc, n_pack=2, chunk_q=CHUNK_Q)
    _close(tlg, jlg, LOGITS)
    for a, b in zip(tree_leaves(tcaches), jax.tree_util.tree_leaves(_host(jcaches))):
        _close(a, b, LOGITS)
    jcaches = j_pad(jcaches, S + 8)
    tcaches = bridge.to_torch(_host(jcaches), "cpu")
    pos = np.array([S, S - 1, S, S - 5])
    tok = np.argmax(np.asarray(jlg)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(3):
        jlg, jcaches = jm.decode_step(world["base"], world["lora"], world["jmeta"].scales(),
                                      jnp.asarray(tok), jcaches, jnp.asarray(pos), jc, n_pack=2)
        tlg, tcaches = tm.decode_step(world["tbase"], world["tlora"], world["meta"].scales(),
                                      torch.from_numpy(tok), tcaches, torch.from_numpy(pos),
                                      tc, n_pack=2)
        _close(tlg, jlg, LOGITS)
        tok = np.argmax(np.asarray(jlg)[:, -1], -1).astype(np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_serve_engine_tokens_match_reference(world, impl):
    """``ServeEngine.serve`` on the absorbed decode emits the reference
    engine's greedy tokens (same adapters, prompts and arrivals; 5 requests
    over 2 rows, so rows retire and admit mid-run at other positions; one
    prompt length, so the reference compiles one prefill)."""
    jc, tc = world["jcfg"], world["cfg"]
    rank, alpha = 8, 16.0
    meta = j_pack_meta([JLoraConfig(rank=rank, alpha=alpha)] * 3)
    _, lora = jm.init_model(jax.random.PRNGKey(1), jc, meta)
    lora = jax.tree.map(lambda x: x + 0.02, lora)
    adapters = {f"ad{i}": j_extract(lora, i) for i in range(3)}
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, jc.vocab_size, size=8).astype(np.int32) for _ in range(5)]
    kw = dict(rows=2, smax=32, r_bucket=rank)
    jeng = JServeEngine(jc, world["base"], serve_executor=JServeExecutor(),
                        impl=None if impl == "auto" else impl, **kw)
    eng = ServeEngine(tc, world["tbase"], device="cpu", impl=impl, **kw)
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


def test_pad_caches_grows_the_latent_leaves_and_refuses_unknown_ones(world):
    """``pad_caches`` pads ``ckv`` / ``k_rope`` along their sequence axis
    (2 under the stacked blocks) as the reference does, and raises on a
    sequence-indexed leaf it does not know rather than pass it unpadded."""
    jc, tc = world["jcfg"], world["cfg"]
    toks = _tokens(jc, s=12)
    _, jcaches = jm.prefill(world["base"], world["lora"], world["jmeta"].scales(),
                            {"tokens": jnp.asarray(toks)}, jc, n_pack=2)
    want = _host(j_pad(jcaches, 30))
    got = pad_caches(bridge.to_torch(_host(jcaches), "cpu"), 30)
    assert jax.tree.map(lambda t: t.shape, bridge.to_numpy(got)) == jax.tree.map(
        lambda t: t.shape, want)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert got["blocks"]["l0"]["attn"]["ckv"].shape == (2, NB, 30, 32)
    bad = {"blocks": {"l0": {"attn": {"ckv": torch.zeros(2, NB, 12, 32),
                                      "latent": torch.zeros(2, NB, 12, 8)}}}}
    with pytest.raises(ValueError, match="'latent'"):
        pad_caches(bad, 30)
    with pytest.raises(ValueError, match="longer than"):
        pad_caches(got, 20)


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_int8_tree_matches_reference_quantizer_and_forward(world, impl):
    """``init_model(..., quant="int8")`` gives the reference's
    ``quantize_base_params`` of the same dense draws bit for bit: ``q_a``,
    ``q_b``, ``kv_a``, ``o`` and the MLP quantized, ``kv_b_k`` / ``kv_b_v``,
    the embedding, the head and the norms left dense. The forward on the
    reference's int8 tree matches the reference's (#3's plain version
    under "fused", dequantize-then-matmul under "auto")."""
    jc, tc, meta = world["jcfg"], world["cfg"], world["meta"]
    dense, _ = tm.init_model(0, tc, meta, device="cpu")
    qbase, _ = tm.init_model(0, tc, meta, device="cpu", quant="int8")
    want = _host(j_quantize_base_params(bridge.to_numpy(dense), "int8"))
    assert jax.tree.map(lambda t: (t.shape, str(t.dtype)), bridge.to_numpy(qbase)) == jax.tree.map(
        lambda t: (t.shape, str(t.dtype)), want)
    for a, b in zip(jax.tree_util.tree_leaves(bridge.to_numpy(qbase)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    attn = qbase["decoder"]["blocks"]["l0"]["attn"]
    assert {k for k, v in attn.items() if is_quantized(v.get("w"))} == {"q_a", "q_b", "kv_a", "o"}
    assert not is_quantized(attn["kv_b_k"]["w"]) and not is_quantized(attn["kv_b_v"]["w"])
    assert not is_quantized(qbase["lm_head"]["w"]) and not is_quantized(qbase["embed"]["w"])
    jq = _host(j_quantize_base_params(world["base"], "int8"))
    toks = _tokens(jc, seed=8, s=24)
    if ("int8", impl) not in world:
        jh, _, _ = jm.forward(jq, world["lora"], world["jmeta"].scales(),
                              {"tokens": jnp.asarray(toks)}, jc, n_pack=2, chunk_q=CHUNK_Q,
                              kcfg=JKernelConfig(impl=None if impl == "auto" else impl,
                                                 base_dtype="int8"))
        world["int8", impl] = jm.logits(jq, jh, jc)
    tq = bridge.to_torch(jq, "cpu")
    assert tcm.CostModel(tc, tcm.H100, base_dtype="int8").base_dtype == "int8"
    th, _, _ = tm.forward(tq, world["tlora"], meta.scales(), {"tokens": torch.from_numpy(toks)}, tc,
                       n_pack=2, chunk_q=CHUNK_Q, kcfg=KernelConfig(impl=impl, base_dtype="int8"))
    _close(tm.logits(tq, th, tc), world["int8", impl], LOGITS)
    assert _same(quantize_base_params(dense, "int8"), qbase)


def _same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("base_dtype", [None, "int8", "nf4"], ids=["bf16", "int8", "nf4"])
def test_cost_model_counts_match_reference_at_reduced(base_dtype):
    """At ``reduced()`` MLA's ``o`` reads n_heads x v_head_dim = n_heads x
    head_dim = 128 inputs, so the port's LoRA count and the reference's
    agree; with ``REFERENCE_MEMORY`` every price is the reference's."""
    jc, tc = _cfgs()
    assert tcm.model_param_count(tc) == jcm.model_param_count(jc)
    for r in (8, 16, 32, 128):
        assert tcm.lora_param_count(tc, r) == jcm.lora_param_count(jc, r)
    jmod = jcm.CostModel(jc, jcm.A100_40G, base_dtype=base_dtype)
    tmod = tcm.CostModel(tc, tcm.A100_40G, base_dtype=base_dtype, **tcm.REFERENCE_MEMORY)
    assert tmod.base_weight_bytes() == jmod.base_weight_bytes()
    js, ts = j_space(300, seq_len=512)[::37], default_search_space(300, seq_len=512)[::37]
    for k in (1, 3, len(ts)):
        assert tmod.job_mem_bytes(ts[:k], 1, 512) == jmod.job_mem_bytes(js[:k], 1, 512)
        assert tmod.iter_time(ts[:k], 1, 512) == jmod.iter_time(js[:k], 1, 512)


def test_lora_count_leaves_out_the_reference_o_phantom():
    """At full width the reference bills MLA's ``o`` adapter at n_heads x
    head_dim = 3,840 inputs; the projection reads n_heads x v_head_dim =
    2,560. The port counts what the executor allocates: n_layers x r x
    1,280 fewer, 1,269,760 at r = 16 (37,870,592 parameters an adapter)."""
    jc, tc = _cfgs(reduce=False)
    for r in (8, 16, 64):
        assert jcm.lora_param_count(jc, r) - tcm.lora_param_count(tc, r) == 62 * r * 1280
    assert tcm.lora_param_count(tc, 16) == 37_870_592
    meta = pack_meta([LoraConfig(rank=16, alpha=16.0)])
    n = sum(t.numel() for t in tree_leaves(tm.lora_zeros(reduced(tc).replace(n_layers=1),
                                                           meta, device="cpu")))
    assert n == tcm.lora_param_count(reduced(tc).replace(n_layers=1), 16)
    assert tcm.lora_param_count(tc, 16) == 62 * 16 * (
        (2560 + 768) + (2560 + 288) + (2560 + 2560) + 2 * (2560 + 6400) + (6400 + 2560))


def test_planner_matches_reference_on_the_reduced_model():
    """The reduced model, the reference's memory accounting: the port's
    cost model and plan ``==`` the reference's (the LoRA counts agree
    there)."""
    jc, tc = _cfgs()
    jcmod = jcm.CostModel(jc, jcm.A100_40G.scaled(mem_bytes=2e9))
    tcmod = tcm.CostModel(tc, tcm.A100_40G.scaled(mem_bytes=2e9), **tcm.REFERENCE_MEMORY)
    idx = range(3, 120, 13)
    js, ts = j_space(300, seq_len=256), default_search_space(300, seq_len=256)
    js, ts = [js[i] for i in idx], [ts[i] for i in idx]
    for seq in (128, 256):
        assert tcmod.job_mem_bytes(ts, 1, seq) == jcmod.job_mem_bytes(js, 1, seq)
        assert tcmod.iter_time(ts, 1, seq) == jcmod.iter_time(js, 1, seq)
    tp, jp = plan(tcmod, ts, 4, 256, 50), j_plan(jcmod, js, 4, 256, 50)
    assert len(tp.jobs) > 1
    assert [(tuple(j.config_ids), j.degree, j.start, j.end) for j in tp.jobs] == [
        (tuple(j.config_ids), j.degree, j.start, j.end) for j in jp.jobs]
    assert tp.makespan == jp.makespan


def test_launcher_trains_and_saves_adapters(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch minicpm3-4b --reduced
    --device cpu``: finite losses, the adapters (q_a, kv_a, o and the MLP)
    in the pool."""
    per = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                             "--seq", "16", "--log-every", "0", "--pool", str(tmp_path)])
    assert per.shape == (2,) and np.isfinite(per).all()
    assert "arch=minicpm3-4b-reduced" in capsys.readouterr().out
    pool = CheckpointPool(str(tmp_path))
    assert pool.list() == [f"{ARCH}-reduced_adapter_000", f"{ARCH}-reduced_adapter_001"]
    ad = pool.load_adapter(pool.list()[0])
    assert set(ad["decoder"]["blocks"]["l0"]["attn"]) == {"q_a", "kv_a", "o"}
    assert set(ad["decoder"]["blocks"]["l0"]["mlp"]) == {"gate", "up", "down"}
    assert np.isfinite(pool.load_meta(pool.list()[1])["final_loss"])
