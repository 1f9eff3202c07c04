"""jamba-v0.1-52b, the attention/SSD hybrid with MoE, in the port against
the JAX package, on the CPU.

Jamba mixes every kind of layer the port has: one attention layer in each
period of 8 (layers 3, 11, 19, 27), SSD mixers on the other 7, a mixture of
experts (16 of 14,336, top-2) on the odd layers and a dense SwiGLU on the
even ones. Each layer carries the adapters of its own mixer -- q/k/v/o on
the attention layers, zx/out ("ssm_in"/"ssm_out") on the SSD ones -- so
the LoRA tree's layout follows each layer's spec, for every config ported.

Reduced jamba (the reference's hybrid rule: 4 layers, ``attn_every=4``,
``attn_offset=1``: SSD + dense, attention + MoE, SSD + dense, SSD + MoE; d
256, 4 experts of 64, top-2, capacity factor 2: nothing dropped). Weights
are the port's ``init_model`` draws (LoRA + 0.02 N(0, 1) from a seed)
carried to the reference through ``repro_torch.bridge``; the layouts are
held against the reference's ``init_model`` by ``jax.eval_shape``. Each
reference function is compiled once and shared. Tolerances, f32 at full
f32: logits 1e-4 of max |logit| (bf16: 5e-2, on the tokens whose routing
agrees, the others reported); step 1's loss 1e-5 and every f32 LoRA
gradient 1e-4 of the largest value of the compared array; prefill and
decode against the reference's full forward 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LoraConfig as JLoraConfig
from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.core.adapter import pack_meta as j_pack_meta
from repro.models import model as jm
from repro.models import transformer as jtr
from repro.models.layers import moe as jmoe
from repro.sched import cost_model as jcm
from repro.train.data import packed_batch_iterator as j_batches
from repro.train.trainer import packed_loss_fn as j_packed_loss_fn
from repro_torch import bridge
from repro_torch.configs import LoraConfig, get_config, list_archs, reduced
from repro_torch.configs.base import lora_leaves
from repro_torch.core.adapter import pack_meta
from repro_torch.core.packed_lora import extract_adapter, inject_adapter
from repro_torch.kernels.ops import KernelConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import model as tm
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import moe as tmoe
from repro_torch.sched import cost_model as tcm
from repro_torch.serve.decode import pad_caches
from repro_torch.train.checkpoint import CheckpointPool
from repro_torch.train.data import packed_batch_iterator
from repro_torch.train.trainer import packed_value_and_grad
from repro_torch.tree import tree_leaves, tree_map

JAMBA = "jamba-v0.1-52b"
LOGITS, LOGITS_BF16 = 1e-4, 5e-2
LOSS, GRAD = 1e-5, 1e-4
NB, S = 4, 40
PACK = [dict(rank=8, alpha=8.0, learning_rate=1e-3, batch_size=2),
        dict(rank=16, alpha=4.0, learning_rate=5e-4, batch_size=2)]


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _close(got, want, rtol):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _keys_shapes(tree):
    return [(jax.tree_util.keystr(p), tuple(t.shape))
            for p, t in jax.tree_util.tree_leaves_with_path(tree)]


def _bf16(tree):
    """The reference's bf16 tree: every leaf bf16 but the router, which its
    ``init_moe`` keeps f32 whatever the dtype."""
    def cast(path, t):
        keep = any(getattr(k, "key", None) == "router" for k in path)
        return jnp.asarray(t, jnp.float32 if keep else jnp.bfloat16)
    return jax.tree_util.tree_map_with_path(cast, tree)


@pytest.fixture(scope="module")
def worlds():
    return {}


def _world(worlds, n_layers=4):
    """The reduced hybrid at ``n_layers`` (4: one period; 8: two stacked
    blocks of it) on both sides, its weights the port's draws."""
    if n_layers not in worlds:
        jc, tc = j_reduced(j_get_config(JAMBA)), reduced(get_config(JAMBA))
        jc, tc = jc.replace(n_layers=n_layers), tc.replace(n_layers=n_layers)
        meta = pack_meta([LoraConfig(**c) for c in PACK])
        base, lora = tm.init_model(0, tc, meta, device="cpu")
        rng = np.random.RandomState(7)
        lora = tree_map(lambda t: t + torch.from_numpy(
            0.02 * rng.standard_normal(t.shape).astype(np.float32)), lora)
        worlds[n_layers] = dict(
            jcfg=jc, cfg=tc, jmeta=j_pack_meta([JLoraConfig(**c) for c in PACK]), meta=meta,
            base=bridge.to_numpy(base), lora=bridge.to_numpy(lora), tbase=base, tlora=lora)
    return worlds[n_layers]


def _tokens(cfg, seed=4, s=S):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(NB, s)).astype(np.int32)


def _ref_logits(worlds, n_layers, bf16):
    """The reference's logits and aux on the world's weights and tokens,
    and each MoE layer's top-k ``idx`` in layer order (a
    ``jax.debug.callback`` in its ``_router``: its blocks run in a scan);
    one compile per (depth, dtype), shared."""
    key = ("logits", n_layers, bf16)
    if key not in worlds:
        w = _world(worlds, n_layers)
        jc = w["jcfg"]
        routes, j_router = [], jmoe._router

        def j_wrap(x, params, mcfg):
            out = j_router(x, params, mcfg)
            jax.debug.callback(lambda i: routes.append(np.asarray(i).copy()), out[1],
                               ordered=True)
            return out

        def ref(b, lo, sc, t):
            h, _, a = jm.forward(b, lo, sc, {"tokens": t}, jc, n_pack=2)
            return jnp.asarray(jm.logits(b, h, jc), jnp.float32), a

        jb, jl = (_bf16(w["base"]), _bf16(w["lora"])) if bf16 else (w["base"], w["lora"])
        jmoe._router = j_wrap
        try:
            lg, aux = jax.jit(ref)(jb, jl, w["jmeta"].scales(), jnp.asarray(_tokens(jc)))
            jax.effects_barrier()
        finally:
            jmoe._router = j_router
        worlds[key] = np.asarray(lg), float(aux), routes
    return worlds[key]


# ---------------------------------------------------------------------------
# the config and the LoRA layout of every ported config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_config_matches_reference_field_for_field(reduce):
    """Every field of the port's jamba equals the reference's, the
    attention, SSD and MoE blocks' too, and so do ``layer_kinds`` and
    ``ffn_kinds`` (the port of ``tests/test_models.py::
    test_jamba_layer_pattern``: 4 attention layers of 32, the first at 3;
    16 MoE layers, every other one). ``reduced`` keeps one period of 4:
    SSD + dense, attention + MoE, SSD + dense, SSD + MoE."""
    jc, tc = j_get_config(JAMBA), get_config(JAMBA)
    if reduce:
        jc, tc = j_reduced(jc), reduced(tc)
    for f in dataclasses.fields(tc):
        if f.name in ("attention", "ssm", "moe"):
            for sub in dataclasses.fields(getattr(tc, f.name)):
                assert getattr(getattr(tc, f.name), sub.name) == getattr(
                    getattr(jc, f.name), sub.name), (f.name, sub.name)
        else:
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.layer_kinds() == jc.layer_kinds() and tc.ffn_kinds() == jc.ffn_kinds()
    assert [(s.mixer, s.ffn, s.window, s.theta) for s in ttr.layer_specs(tc)] == [
        (s.mixer, s.ffn, s.window, s.theta) for s in jtr.layer_specs(jc)]
    assert ttr.find_period(ttr.layer_specs(tc)) == jtr.find_period(jtr.layer_specs(jc))
    if reduce:
        assert list(zip(tc.layer_kinds(), tc.ffn_kinds())) == [
            ("ssm", "dense"), ("attn", "moe"), ("ssm", "dense"), ("ssm", "moe")]
    else:
        kinds, ffns = tc.layer_kinds(), tc.ffn_kinds()
        assert kinds.count("attn") == 4 and kinds[3] == "attn" and ffns.count("moe") == 16
        assert [i for i, k in enumerate(kinds) if k == "attn"] == [3, 11, 19, 27]
        assert ttr.find_period(ttr.layer_specs(tc)) == 8
        assert "arXiv:2403.19887" in tc.citation
    assert set(lora_leaves(tc, "attn", "moe").values()) == {"q", "k", "v", "o"}
    assert set(lora_leaves(tc, "ssm", "dense").values()) == {"zx", "out"}


@pytest.mark.parametrize("arch", list_archs())
def test_lora_trees_match_reference_layout(arch):
    """``init_lora`` and ``lora_zeros`` build the reference's ``init_model``
    LoRA tree, by keys and shapes, at ``reduced()`` size, for every ported
    config: each layer holds its own mixer's adapters (and, on a dense FFN,
    the MLP's), which for a config whose layers all carry one layout is the
    layout the port had before."""
    jc, tc = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    jmeta = j_pack_meta([JLoraConfig(**c) for c in PACK])
    meta = pack_meta([LoraConfig(**c) for c in PACK])
    _, jl = jax.eval_shape(lambda: jm.init_model(jax.random.PRNGKey(0), jc, jmeta))
    want = _keys_shapes(jl)
    assert want
    assert _keys_shapes(bridge.to_numpy(tm.init_lora(0, tc, meta, device="cpu"))) == want
    assert _keys_shapes(bridge.to_numpy(tm.lora_zeros(tc, meta, device="cpu"))) == want


def test_full_jamba_lora_zeros_follows_each_layer_spec():
    """Full jamba (32 layers, 4 blocks of the period of 8), on the meta
    device: each layer position of ``lora_zeros``' tree holds its spec's
    adapters at full width -- an attention layer q/k/v/o (4,096 -> 4,096,
    1,024, 1,024; 4,096 -> 4,096), an SSD layer zx (4,096 -> 16,384) and out
    (8,192 -> 4,096) -- and the one-adapter count is the port's
    ``lora_param_count``."""
    tc = get_config(JAMBA)
    meta = pack_meta([LoraConfig(rank=16, alpha=16.0)])
    tree = tm.lora_zeros(tc, meta, device="meta")["decoder"]
    specs = ttr.layer_specs(tc)
    assert tree["rest"] == {} and sorted(tree["blocks"]) == [f"l{i}" for i in range(8)]
    want = {"attn": {"q": (4096, 4096), "k": (4096, 1024), "v": (4096, 1024),
                     "o": (4096, 4096)},
            "ssm": {"zx": (4096, 16384), "out": (8192, 4096)}}
    for i in range(8):
        layer = tree["blocks"][f"l{i}"]
        grp = specs[i].mixer
        assert set(layer) == {grp}
        assert {nm: (ab["a"].shape[-2], ab["b"].shape[-1]) for nm, ab in layer[grp].items()} == (
            want[grp])
        for ab in layer[grp].values():
            assert ab["a"].shape[:2] == (4, 1) and ab["a"].shape[-1] == ab["b"].shape[-2] == 16
    held = sum(t.numel() for t in tree_leaves(tree))
    assert held == tcm.lora_param_count(tc, 16) == 16_384_000


def test_init_model_draws_the_reference_layout():
    """The port's ``init_model`` base tree is the reference's, leaf for
    leaf (keys, shapes, dtypes: the router f32 in a bf16 tree), at 8
    reduced layers (two stacked blocks of the period)."""
    jc = j_reduced(j_get_config(JAMBA)).replace(n_layers=8)
    tc = reduced(get_config(JAMBA)).replace(n_layers=8)
    jb, _ = jax.eval_shape(lambda: jm.init_model(jax.random.PRNGKey(0), jc, None, jnp.bfloat16))
    tb, _ = tm.init_model(0, tc, None, dtype=torch.bfloat16, device="cpu")
    got = bridge.to_numpy(tb)
    assert [(k, s, str(t.dtype)) for (k, s), t in zip(_keys_shapes(jb), jax.tree_util.tree_leaves(
        jb))] == [(k, s, str(t.dtype)) for (k, s), t in zip(_keys_shapes(got),
                                                             jax.tree_util.tree_leaves(got))]
    assert tb["decoder"]["blocks"]["l1"]["moe"]["router"]["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the reduced model against the reference
# ---------------------------------------------------------------------------


def _record_routes(monkeypatch, replay=None):
    """Record every MoE layer's top-k ``idx`` of the port, in layer order.
    ``replay``: the reference's ``idx`` per layer, which the port's router
    then takes in place of its own top-k (its own probabilities gathered at
    those experts and renormalized, as ``scripts/moe_routing.py`` replays a
    path's choices)."""
    got, t_router = [], tmoe._router

    def t_wrap(x, params, mcfg):
        gates, idx, aux = t_router(x, params, mcfg)
        if replay is not None:
            idx = torch.from_numpy(replay[len(got)]).to(idx.dtype)
            probs = torch.softmax(x.float() @ params["router"]["w"].float(), dim=-1)
            gates = probs.gather(-1, idx)
            gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
        got.append(idx.numpy().copy())
        return gates, idx, aux

    monkeypatch.setattr(tmoe, "_router", t_wrap)
    return got


@pytest.mark.parametrize("n_layers,dtype,impl", [(4, "f32", "auto"), (8, "f32", "fused"),
                                                 (8, "bf16", "auto")])
def test_forward_logits_match_reference(worlds, monkeypatch, n_layers, dtype, impl):
    """The reduced hybrid, one period (4 layers) and two stacked blocks of
    it (8), against the reference's, routing first. In f32 every MoE
    layer's top-2 ``idx`` equals the reference's, the logits lie within
    1e-4 of max |logit| and the aux within 1e-6. On a bf16 base and LoRA
    (the router f32 on both sides) the port routes on its f32 stream's
    norm, after SSD layers computed in f32 (ROADMAP C), and the reference
    on bf16 roundings, so a token near a tie between its 2nd and 3rd expert
    may take another one and its outputs then differ by O(1): the flipped
    (MoE layer, row, position) are reported and held to 1 in 16 of the
    routed pairs, and the tokens that neither flipped nor follow a flip of
    an earlier layer in their row (the attention and SSD layers after it
    read it) are held within 5e-2. Then the port replays the reference's
    choices, and every token's logits are held within 5e-2."""
    w = _world(worlds, n_layers)
    tc = w["cfg"]
    bf16 = dtype == "bf16"
    want, jaux, want_routes = _ref_logits(worlds, n_layers, bf16)
    tb, tl = ((bridge.to_torch(w["base"], "cpu", torch.bfloat16),
               bridge.to_torch(w["lora"], "cpu", torch.bfloat16)) if bf16
              else (w["tbase"], w["tlora"]))
    toks = {"tokens": torch.from_numpy(_tokens(tc))}

    def run(replay=None):
        got_routes = _record_routes(monkeypatch, replay)
        th, caches, aux = tm.forward(tb, tl, w["meta"].scales(), toks, tc, n_pack=2,
                                     kcfg=KernelConfig(impl=impl))
        assert caches is None and aux.dtype == torch.float32 and th.shape == (NB, S, tc.d_model)
        return _np(tm.logits(tb, th, tc)), aux, got_routes

    got, aux, got_routes = run()
    moe_layers = tc.ffn_kinds().count("moe")
    assert len(got_routes) == len(want_routes) == moe_layers
    flipped = sorted((layer, t // S, t % S) for layer, (g, r) in enumerate(zip(got_routes,
                                                                             want_routes))
                     for t in range(g.shape[0]) if set(g[t]) != set(r[t]))
    if not bf16:
        for g, r in zip(got_routes, want_routes):
            np.testing.assert_array_equal(g, r)
        _close(got, want, LOGITS)
        np.testing.assert_allclose(aux.item(), jaux, rtol=1e-6)
        return
    keep = np.ones((NB, S), bool)
    for layer, row, pos in flipped:
        if layer < moe_layers - 1:
            keep[row, pos:] = False
        keep[row, pos] = False
    print(f"bf16 routing, {n_layers} layers: {len(flipped)} (MoE layer, row, position) of "
          f"{NB * S} tokens x {moe_layers} MoE layers took another expert: {flipped}; "
          f"{int(keep.sum())} tokens held unreplayed")
    assert len(flipped) <= NB * S * moe_layers // 16, flipped
    _close(got[keep], want[keep], LOGITS_BF16)
    replayed, _, routes = run(replay=want_routes)
    assert all(np.array_equal(g, r) for g, r in zip(routes, want_routes))
    _close(replayed, want, LOGITS_BF16)


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_packed_step_matches_reference(worlds, impl):
    """Step 1 of the packed loss with the aux (weight 0.01), one period:
    the total loss and each adapter's CE within 1e-5 of the reference's,
    every f32 LoRA gradient (q/k/v/o on the attention layer, zx/out on the
    three SSD layers; a and b) within 1e-4 of the largest value of the
    reference's."""
    w = _world(worlds)
    jc, tc, jmeta, meta = w["jcfg"], w["cfg"], w["jmeta"], w["meta"]
    if "step" not in worlds:
        jb = next(j_batches(jc, [JLoraConfig(**c) for c in PACK], seq=S))
        (jtot, jper), jgrads = jax.jit(jax.value_and_grad(
            lambda lo: j_packed_loss_fn(lo, w["base"], jb, jc, 2, jmeta.scales(),
                                        kcfg=jmeta.kernel_config()),
            has_aux=True))(w["lora"])
        worlds["step"] = float(jtot), jper, jax.tree_util.tree_leaves(jgrads)
    jtot, jper, want = worlds["step"]
    tb = next(packed_batch_iterator(tc, [LoraConfig(**c) for c in PACK], seq=S, device="cpu"))
    tot, per, grads = packed_value_and_grad(w["tlora"], w["tbase"], tb, tc, 2, meta.scales("cpu"),
                                            kcfg=KernelConfig(impl=impl, ranks=meta.ranks))
    np.testing.assert_allclose(tot.item(), jtot, rtol=LOSS)
    _close(per, jper, LOSS)
    got = jax.tree_util.tree_leaves(bridge.to_numpy(grads))
    assert len(got) == len(want) == (4 + 3 * 2) * 2
    for g, ref in zip(got, want):
        assert np.abs(_np(ref)).max() > 0
        _close(g, ref, GRAD)


def test_prefill_then_decode_match_the_reference_forward(worlds):
    """(The port of ``tests/test_serve.py::
    test_prefill_then_decode_matches_full_forward`` for jamba.) Prefill 36
    tokens, then decode the next 3 at a shared position, one period in f32:
    the last prefill logits and each decode step's equal the reference's
    full forward at those positions within 1e-4 of max |logit|. One cache
    tree holds the attention layer's k/v and the SSD layers' conv windows
    and states (f32); ``pad_caches`` grows the k/v alone."""
    w = _world(worlds)
    tc = w["cfg"]
    want = _ref_logits(worlds, 4, False)[0]
    toks = torch.from_numpy(_tokens(tc))
    s0 = S - 4
    lg, caches = tm.prefill(w["tbase"], w["tlora"], w["meta"].scales(), {"tokens": toks[:, :s0]},
                            tc, n_pack=2)
    _close(lg[:, 0], want[:, s0 - 1], LOGITS)
    assert {k for k in caches["blocks"]["l0"]} == {"ssm"}
    assert {k for k in caches["blocks"]["l1"]} == {"attn"}
    ssm0 = caches["blocks"]["l0"]["ssm"]
    assert {t.dtype for t in ssm0.values()} == {torch.float32}
    caches = pad_caches(caches, S)
    assert caches["blocks"]["l1"]["attn"]["k"].shape[2] == S
    assert caches["blocks"]["l0"]["ssm"] is ssm0
    for i in range(3):
        lg, caches = tm.decode_step(w["tbase"], w["tlora"], w["meta"].scales(),
                                    toks[:, s0 + i:s0 + i + 1], caches, torch.tensor(s0 + i), tc,
                                    n_pack=2)
        _close(lg[:, 0], want[:, s0 + i], LOGITS)


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_cost_model_counts_match_reference(reduce):
    """The parameter counts are the reference's (51.46 B at full size, the
    first period 13.27 B), the active and quantized counts follow them, and
    with ``REFERENCE_MEMORY`` the base's price is the reference's. The LoRA
    count is the size of the reference's own ``init_model`` LoRA tree
    (16,384,000 at r = 16 at full size, 122,880 reduced); the reference
    bills every target on every layer, and its excess is exactly q/k/v/o on
    the SSD layers and zx/out on the attention ones (30,408,704 and
    229,376)."""
    jc, tc = j_get_config(JAMBA), get_config(JAMBA)
    if reduce:
        jc, tc = j_reduced(jc), reduced(tc)
    assert tcm.model_param_count(tc) == jcm.model_param_count(jc)
    assert tcm.active_param_count(tc) == jcm.active_param_count(jc)
    one = pack_meta([LoraConfig(rank=16, alpha=16.0)])
    _, jl = jax.eval_shape(lambda: jm.init_model(
        jax.random.PRNGKey(0), jc, j_pack_meta([JLoraConfig(rank=16, alpha=16.0)])))
    held = sum(int(np.prod(t.shape)) for t in jax.tree_util.tree_leaves(jl))
    assert tcm.lora_param_count(tc, 16) == held
    d, a = tc.d_model, tc.attention
    attn = 16 * (2 * (d + a.n_heads * a.head_dim) + 2 * (d + a.n_kv_heads * a.head_dim))
    ssd = 16 * (d + 2 * tc.ssm.d_inner(d) + tc.ssm.d_inner(d) + d)
    n_attn = tc.layer_kinds().count("attn")
    n_ssd = tc.n_layers - n_attn
    assert jcm.lora_param_count(jc, 16) - held == n_ssd * attn + n_attn * ssd
    if reduce:
        assert (held, jcm.lora_param_count(jc, 16)) == (122_880, 229_376)
    else:
        assert (held, jcm.lora_param_count(jc, 16)) == (16_384_000, 30_408_704)
        assert tcm.model_param_count(tc) == 51_458_342_912
        assert tcm.model_param_count(tc.replace(n_layers=8)) == jcm.model_param_count(
            jc.replace(n_layers=8)) == 13_267_238_912
        # the quantizer leaves the experts and routers dense
        assert tcm.quantized_param_count(tc, "int8") == (
            tcm.model_param_count(tc) - 2 * tc.vocab_size * d
            - 16 * tcm.moe_param_count(tc)
            - 28 * d * (2 * tc.ssm.d_state + tc.ssm.n_heads(d)))
    assert sum(t.numel() for t in tree_leaves(tm.lora_zeros(tc, one, device="meta"))) == held
    jmod = jcm.CostModel(jc, jcm.A100_40G)
    tmod = tcm.CostModel(tc, tcm.A100_40G, **tcm.REFERENCE_MEMORY)
    assert tmod.base_weight_bytes() == jmod.base_weight_bytes()


def test_per_job_term_counts_the_ssd_layers_a_backward_holds():
    """The port's per-job memory term for a decoder with SSD layers: the
    scan's working set (``ssm_scan_copies`` f32 (rows, H, Q, Q) tensors a
    chunk) for each SSD layer whose activations the backward holds at once
    -- one checkpointed block's and the unchecked remainder's. Jamba's
    first 8 layers stack as a block of 6 and a remainder of 2 (7 SSD
    layers), its 32 as 4 blocks of 8 (7); mamba2's block is one layer; an
    attention decoder keeps ``job_overhead_bytes``; ``REFERENCE_MEMORY``
    drops the term."""
    jamba = get_config(JAMBA)
    one = 3 * 128 * 256 * 256 * 4.0 * 2  # 3 rows of 512: two chunks of 256
    for n in (8, 32):
        cfg = jamba.replace(n_layers=n)
        assert tcm.CostModel(cfg, tcm.H100).job_fixed_bytes(3, 512) == 6 * one * 7
        assert tcm.CostModel(cfg, tcm.H100, **tcm.REFERENCE_MEMORY).job_fixed_bytes(3, 512) == 0
    assert ttr.find_period(ttr.layer_specs(jamba.replace(n_layers=8))) == 6
    assert tcm.CostModel(jamba.replace(n_layers=4), tcm.H100).job_fixed_bytes(3, 512) == 6 * one * 3
    mamba = get_config("mamba2-370m")
    assert tcm.CostModel(mamba, tcm.H100).job_fixed_bytes(3, 512) == 6 * one * 32 / 128
    assert tcm.CostModel(get_config("qwen25-7b"), tcm.H100).job_fixed_bytes(3, 512) == 1e9


# ---------------------------------------------------------------------------
# the port's own invariants
# ---------------------------------------------------------------------------


def test_packed_adapter_equals_the_adapter_alone(worlds):
    """Port against port, one period (nothing dropped) with
    ``aux_weight=0``: adapter 1's CE and LoRA gradients in the pack of 2
    equal its own run alone within 1e-5."""
    w = _world(worlds)
    tc, meta = w["cfg"], w["meta"]
    batch = next(packed_batch_iterator(tc, [LoraConfig(**c) for c in PACK], seq=S, device="cpu"))
    _, per, grads = packed_value_and_grad(w["tlora"], w["tbase"], batch, tc, 2,
                                          meta.scales("cpu"), aux_weight=0.0,
                                          kcfg=KernelConfig(ranks=meta.ranks))
    alone = tree_map(lambda t: t[:, 1:2], w["tlora"])  # the pack axis of the stacked leaves
    meta1 = pack_meta([LoraConfig(**PACK[1])])
    one = {k: v[2:] for k, v in batch.items()}
    _, per1, grads1 = packed_value_and_grad(alone, w["tbase"], one, tc, 1, meta1.scales("cpu"),
                                            aux_weight=0.0)
    _close(per1, per[1:], 1e-5)
    for g, g1 in zip(tree_leaves(grads), tree_leaves(grads1)):
        _close(g1, g[:, 1:2], 1e-5)


def test_extract_inject_roundtrip_on_the_mixed_tree(worlds):
    """extract -> inject -> extract of each adapter of the pack is bit-exact
    on the mixed tree (SSD and attention leaves), unpadded to its rank, and
    the injected pack of zeros is ``lora_zeros``' layout."""
    w = _world(worlds, 8)
    tc, meta = w["cfg"], w["meta"]
    for i in range(meta.n):
        ad = extract_adapter(w["tlora"], i, meta.ranks)
        assert set(ad["decoder"]["blocks"]["l1"]) == {"attn"}
        assert set(ad["decoder"]["blocks"]["l0"]["ssm"]) == {"zx", "out"}
        assert ad["decoder"]["blocks"]["l0"]["ssm"]["zx"]["a"].shape[-1] == meta.ranks[i]
        tmpl = tree_map(lambda t: t.numpy(), tm.lora_zeros(tc, meta, device="cpu"))
        packed = inject_adapter(tmpl, ad, i)
        assert _keys_shapes(packed) == _keys_shapes(tmpl)
        again = extract_adapter(packed, i, meta.ranks)
        assert all(np.array_equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(ad)))


def test_launcher_trains_and_saves_adapters(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch jamba-v0.1-52b --reduced
    --device cpu``: finite losses; each adapter in the pool holds zx/out on
    the SSD layers and q/k/v/o on the attention layer."""
    per = launch_train.main(["--arch", JAMBA, "--reduced", "--device", "cpu", "--steps", "2",
                             "--seq", "16", "--log-every", "0", "--pool", str(tmp_path)])
    assert per.shape == (2,) and np.isfinite(per).all()
    assert f"arch={JAMBA}-reduced" in capsys.readouterr().out
    pool = CheckpointPool(str(tmp_path))
    assert pool.list() == [f"{JAMBA}-reduced_adapter_000", f"{JAMBA}-reduced_adapter_001"]
    ad = pool.load_adapter(pool.list()[0])["decoder"]["blocks"]
    assert {k: set(v) for k, v in ad.items()} == {"l0": {"ssm"}, "l1": {"attn"}, "l2": {"ssm"},
                                                  "l3": {"ssm"}}
    assert set(ad["l1"]["attn"]) == {"q", "k", "v", "o"} and set(ad["l0"]["ssm"]) == {"zx", "out"}
    assert np.isfinite(pool.load_meta(pool.list()[1])["final_loss"])
