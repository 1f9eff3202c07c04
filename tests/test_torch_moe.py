"""Mixture of experts in the port against the JAX package, on the CPU.

``models/layers/moe.py``: the router (f32 logits, softmax, top-k, gates
renormalized, the Switch aux loss), the dense path (every expert on every
token: grok-1-314b's path and the exact oracle) and the capacity-bounded
dispatch with every expert local (qwen3-moe-30b-a3b's "ep" path), whose
dispatch and combine the port writes as gathers (no atomic add). Then the
two MoE configs at ``reduced()`` size (2 layers, d 256, 4 heads of 32, 4
experts of 64, top-2, capacity factor 2: nothing dropped) through the
model, a packed step with the aux loss, prefill and decode, the bridge,
the cost model, the planner and the launcher.

Weights come from the reference's ``init_model`` / ``init_moe`` (LoRA +
0.02 N(0, 1) from a seed) through ``repro_torch.bridge``. Tolerances, f32
at full f32: the router's ``idx`` exactly, gates and aux 1e-6; an MoE
layer 1e-5 of max |y| (bf16: 2e-2); its input gradient 1e-4; logits 1e-4
of max |logit| (bf16: 5e-2); step 1's loss 1e-5 and every f32 LoRA
gradient 1e-4 of the largest value of the compared array.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LoraConfig as JLoraConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import default_search_space as j_space
from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.core.adapter import pack_meta as j_pack_meta
from repro.models import model as jm
from repro.models.layers import moe as jmoe
from repro.sched import cost_model as jcm
from repro.sched.planner import plan as j_plan
from repro.train.data import packed_batch_iterator as j_batches
from repro.train.trainer import packed_loss_fn as j_packed_loss_fn
from repro_torch import bridge
from repro_torch.configs import LoraConfig, MoEConfig, default_search_space, get_config, reduced
from repro_torch.configs.base import lora_leaves
from repro_torch.core.adapter import pack_meta
from repro_torch.kernels.ops import KernelConfig
from repro_torch.kernels.quant import base_storage
from repro_torch.launch import train as launch_train
from repro_torch.models import model as tm
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import moe as tmoe
from repro_torch.sched import cost_model as tcm
from repro_torch.sched.planner import plan
from repro_torch.serve.decode import pad_caches
from repro_torch.train.checkpoint import CheckpointPool
from repro_torch.train.data import packed_batch_iterator
from repro_torch.train.trainer import packed_value_and_grad
from repro_torch.tree import tree_leaves

QWEN, GROK = "qwen3-moe-30b-a3b", "grok-1-314b"
F32, BF16 = 1e-5, 2e-2
LOGITS, LOGITS_BF16 = 1e-4, 5e-2
LOSS, GRAD = 1e-5, 1e-4
NB, S = 4, 24
PACK = [dict(rank=8, alpha=8.0, learning_rate=1e-3, batch_size=2),
        dict(rank=16, alpha=4.0, learning_rate=5e-4, batch_size=2)]


def _cfgs(arch=QWEN, reduce=True):
    jc, tc = j_get_config(arch), get_config(arch)
    return (j_reduced(jc), reduced(tc)) if reduce else (jc, tc)


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _close(got, want, rtol):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree, dtype=None):
    return bridge.to_torch(_host(tree), "cpu", dtype)


def _bf16(tree):
    """The reference's bf16 tree: every leaf bf16 but the router, which its
    ``init_moe`` keeps f32 whatever the dtype."""
    def cast(path, t):
        keep = any(getattr(k, "key", None) == "router" for k in path)
        return jnp.asarray(t, jnp.float32 if keep else jnp.bfloat16)
    return jax.tree_util.tree_map_with_path(cast, tree)


def _layer(e=4, k=2, f=8, d=16, cf=None, seed=0):
    """One MoE layer's weights from the reference's ``init_moe`` (f32), the
    configs on both sides and the port's tree."""
    kw = dict(n_experts=e, top_k=k, d_expert=f, capacity_factor=e / k if cf is None else cf,
              impl="ep")
    jp = _host(jmoe.init_moe(jax.random.PRNGKey(seed), d, JMoEConfig(**kw)))
    return JMoEConfig(**kw), MoEConfig(**kw), jp, _port(jp)


def _tlayer(e=4, k=2, f=8, d=16, cf=None, seed=0):
    """The port's own ``init_moe`` from a seed (port-only tests): its config
    and tree."""
    cfg = MoEConfig(n_experts=e, top_k=k, d_expert=f, capacity_factor=e / k if cf is None else cf,
                    impl="ep")
    return cfg, tmoe.init_moe(torch.Generator().manual_seed(seed), d, cfg, device="cpu")


def _x(t, d=16, seed=1):
    return np.random.RandomState(seed).randn(t, d).astype(np.float32)


@pytest.fixture(scope="module")
def worlds():
    return {}


def _world(worlds, arch=QWEN):
    if arch not in worlds:
        jcfg, cfg = _cfgs(arch)
        jmeta = j_pack_meta([JLoraConfig(**c) for c in PACK])
        meta = pack_meta([LoraConfig(**c) for c in PACK])
        base, lora = jm.init_model(jax.random.PRNGKey(0), jcfg, jmeta)
        rng = np.random.RandomState(7)
        lora = jax.tree.map(lambda x: x + 0.02 * rng.standard_normal(x.shape).astype(np.float32),
                            lora)
        base, lora = _host(base), _host(lora)
        worlds[arch] = dict(jcfg=jcfg, cfg=cfg, jmeta=jmeta, meta=meta, base=base, lora=lora,
                            tbase=_port(base), tlora=_port(lora))
    return worlds[arch]


def _tokens(cfg, seed=4, s=S):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(NB, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", [QWEN, GROK])
def test_config_matches_reference_field_for_field(arch, reduce):
    """Every field of the port's config equals the reference's, the MoE
    block's too (published: 128 experts of 768, top-8, "ep", capacity 1.25;
    grok 8 of 32,768, top-2, "dense"; ``reduced``: 4 of 64, top-2, capacity
    2); every layer's FFN is a mixture of experts with no adapter (the LoRA
    leaves are the attention's)."""
    jc, tc = _cfgs(arch, reduce)
    for f in dataclasses.fields(tc):
        if f.name == "attention":
            for af in dataclasses.fields(tc.attention):
                assert getattr(tc.attention, af.name) == getattr(jc.attention, af.name), af.name
        else:
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    for f in dataclasses.fields(tc.moe):
        assert getattr(tc.moe, f.name) == getattr(jc.moe, f.name), f.name
    assert tc.moe.enabled and tc.ffn_kinds() == jc.ffn_kinds() == ("moe",) * tc.n_layers
    assert hash(tc) == hash(tc.replace())
    assert {(s.mixer, s.ffn) for s in ttr.layer_specs(tc)} == {("attn", "moe")}
    assert set(lora_leaves(tc, "attn", "moe").values()) == {"q", "k", "v", "o"}
    if reduce:
        assert (tc.moe.n_experts, tc.moe.top_k, tc.moe.d_expert, tc.moe.capacity_factor) == (
            4, 2, 64, 2.0)
    # moe_every = 2: the MoE layers are the odd ones, as the reference's
    two = tc.replace(moe=dataclasses.replace(tc.moe, moe_every=2), n_layers=4)
    assert two.ffn_kinds() == jc.replace(moe=dataclasses.replace(jc.moe, moe_every=2),
                                         n_layers=4).ffn_kinds() == ("dense", "moe") * 2


# ---------------------------------------------------------------------------
# one MoE layer
# ---------------------------------------------------------------------------


def test_router_matches_reference():
    """``_router``: ``idx`` exactly, the renormalized gates and the aux loss
    within 1e-6, over 48 tokens and 8 experts at top-2 and top-3."""
    for k in (2, 3):
        jcfg, tcfg, jp, tp = _layer(e=8, k=k)
        x = _x(48)
        jg, ji, ja = jmoe._router(jnp.asarray(x), jp, jcfg)
        tg, ti, ta = tmoe._router(torch.from_numpy(x), tp, tcfg)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("path", ["dense", "ep"])
def test_moe_paths_match_reference(path, dtype):
    """``_moe_dense`` and ``_moe_ep_local`` (every expert local, no token
    dropped) on 40 tokens: y within 1e-5 of max |y| in f32 (2e-2 in bf16),
    aux within 1e-6; in f32 the gradient of sum(y * g) + aux with respect
    to x within 1e-4 (the port's combine and dispatch are gathers, the
    reference's a scatter-add: the sums over k run in another order)."""
    jcfg, tcfg, jp, tp = _layer()
    x = _x(40)
    cast = dtype == "bf16"
    jx = jnp.asarray(x, jnp.bfloat16 if cast else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if cast else torch.float32).requires_grad_(True)
    jpp = {k: (v if k == "router" or not cast else jnp.asarray(v, jnp.bfloat16))
           for k, v in jp.items()}
    tpp = {k: (v if k == "router" or not cast else v.to(torch.bfloat16)) for k, v in tp.items()}
    cap = 40

    def jrun(xx):
        if path == "dense":
            return jmoe._moe_dense(jpp, xx, jcfg)
        return jmoe._moe_ep_local(jpp, xx, jcfg, 0, 4, cap)

    if cast:
        jy, ja = jax.jit(jrun)(jx)
    else:
        gy = _x(40, seed=2)
        (_, (jy, ja)), jgx = jax.jit(jax.value_and_grad(
            lambda xx: (lambda y, a: ((y * gy).sum() + a, (y, a)))(*jrun(xx)), has_aux=True))(jx)
    ty, ta = (tmoe._moe_dense(tpp, tx, tcfg) if path == "dense"
              else tmoe._moe_ep_local(tpp, tx, tcfg, 0, 4, cap))
    # the combine sums in f32 (the reference's in the input's dtype)
    assert ty.dtype == torch.float32 and ty.shape == tx.shape
    _close(ty, jy, BF16 if cast else F32)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)
    if not cast:
        ((ty * torch.from_numpy(gy)).sum() + ta).backward()
        _close(tx.grad, jgx, GRAD)


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_dropping_follows_the_reference_drop_order(cf):
    """At a capacity factor that drops pairs (64 tokens, 8 experts, top-2):
    y and the input gradient are the reference's (so the same pairs were
    dropped), pairs were dropped, and within each expert the kept pairs
    are its earliest tokens' (the stable sort's order)."""
    jcfg, tcfg, jp, tp = _layer(e=8, k=2, cf=cf)
    x = _x(64)
    cap = tmoe.moe_capacity(64, tcfg)
    assert cap == jmoe.moe_capacity(64, jcfg)
    (_, jy), jgx = jax.jit(jax.value_and_grad(
        lambda xx: (lambda y: (y.sum(), y))(jmoe._moe_ep_local(jp, xx, jcfg, 0, 8, cap)[0]),
        has_aux=True))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, ta = tmoe._moe_ep_local(tp, tx, tcfg, 0, 8, cap)
    _close(ty, jy, F32)
    ty.sum().backward()
    _close(tx.grad, jgx, GRAD)
    _, idx, _ = tmoe._router(torch.from_numpy(x), tp, tcfg)
    slot_of_pair, tok, filled, _ = tmoe.dispatch_plan(idx, 8, cap)
    kept = (slot_of_pair < 8 * cap).view(64, 2)
    assert not bool(kept.all()) and int(filled.sum()) == int(kept.sum())
    for e in range(8):
        toks = [t for t in range(64) for j in range(2) if int(idx[t, j]) == e]
        got = sorted(t for t in range(64) for j in range(2)
                     if int(idx[t, j]) == e and bool(kept[t, j]))
        assert got == toks[:cap]
        assert tok.view(8, cap)[e, :len(got)].tolist() == got


def test_ep_local_matches_dense_when_no_dropping():
    """(tests/test_moe.py) With capacity >= T the dispatch computes the
    dense answer exactly."""
    tcfg, tp = _tlayer()
    x = torch.from_numpy(_x(24))
    y_dense, aux_d = tmoe._moe_dense(tp, x, tcfg)
    assert tmoe.moe_capacity(24, tcfg) >= 24 * tcfg.top_k / tcfg.n_experts
    y_ep, aux_e = tmoe._moe_ep_local(tp, x, tcfg, 0, tcfg.n_experts, capacity=24)
    np.testing.assert_allclose(y_dense.numpy(), y_ep.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(aux_d.item(), aux_e.item(), rtol=1e-5)


def test_expert_slices_sum_to_full():
    """(tests/test_moe.py) The parts of two expert slices sum to the
    all-experts output (the psum identity of the reference's sharded
    path)."""
    tcfg, tp = _tlayer(seed=2)
    x = torch.from_numpy(_x(16, seed=3))
    full, _ = tmoe._moe_ep_local(tp, x, tcfg, 0, 4, capacity=16)
    parts = []
    for lo in range(0, 4, 2):
        local = dict(tp, **{k: tp[k][lo:lo + 2] for k in ("w_gate", "w_up", "w_down")})
        parts.append(tmoe._moe_ep_local(local, x, tcfg, lo, 2, capacity=16)[0])
    np.testing.assert_allclose(sum(parts).numpy(), full.numpy(), rtol=1e-4, atol=1e-4)


def test_capacity_drops_tokens_gracefully():
    """(tests/test_moe.py) A tiny capacity: no crash, no NaN; dropped pairs
    add nothing."""
    tcfg, tp = _tlayer(cf=0.1, seed=4)
    y, aux = tmoe._moe_ep_local(tp, torch.from_numpy(_x(32, seed=5)), tcfg, 0, 4, capacity=2)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(aux))


def test_aux_loss_is_one_for_uniform_router():
    """(tests/test_moe.py) Perfectly balanced routing (a zero router) gives
    the Switch aux loss ~1, its minimum."""
    tcfg, tp = _tlayer(k=1, f=8, cf=4.0)
    tp["router"]["w"] = torch.zeros_like(tp["router"]["w"])
    _, aux = tmoe._moe_dense(tp, torch.from_numpy(_x(64)), tcfg)
    assert 0.9 <= aux.item() <= 1.1


def test_apply_moe_shapes():
    """(tests/test_moe.py) ``apply_moe`` on (2, 12, 16) keeps the shape,
    finite, under both impls, equal to each other (nothing dropped)."""
    tcfg, tp = _tlayer(seed=6)
    x = torch.from_numpy(_x(24, seed=7)).view(2, 12, 16)
    y, aux = tmoe.apply_moe(tp, x, tcfg)
    yd, _ = tmoe.apply_moe(tp, x, dataclasses.replace(tcfg, impl="dense"))
    assert y.shape == x.shape and bool(torch.isfinite(y).all()) and aux.shape == ()
    np.testing.assert_allclose(y.numpy(), yd.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t,e,topk", [(4, 2, 1), (9, 4, 2), (33, 2, 2), (64, 4, 1)])
def test_moe_dense_chunking_invariance(t, e, topk):
    """(tests/test_moe.py, its hypothesis cases as fixed ones) The chunk
    boundary of ``_moe_dense`` does not change the values, nor do the
    checkpointed chunks of grad mode."""
    tcfg, tp = _tlayer(e=e, k=topk, seed=t)
    x = torch.from_numpy(_x(t, seed=t + 1))
    y1, _ = tmoe._moe_dense(tp, x, tcfg, chunk=8)
    y2, _ = tmoe._moe_dense(tp, x, tcfg, chunk=1024)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        y3, _ = tmoe._moe_dense(tp, x, tcfg, chunk=8)
    assert torch.equal(y1.detach(), y3)


def test_gate_weights_normalized():
    """(tests/test_moe.py) The gates of each token sum to 1; the indices lie
    in [0, E)."""
    tcfg, tp = _tlayer(e=8, k=2)
    gates, idx, _ = tmoe._router(torch.from_numpy(_x(32)), tp, tcfg)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert int(idx.max()) < 8 and int(idx.min()) >= 0


def test_init_moe_draws_the_reference_layout():
    """The port's ``init_moe`` and ``init_model`` build the reference's tree:
    the same leaves, shapes and dtypes (the router f32 in a bf16 tree), the
    ``"moe"`` subtree under each block with the block on axis 0."""
    jc, tc = _cfgs()
    jb, _ = jax.eval_shape(lambda: jm.init_model(jax.random.PRNGKey(0), jc, None, jnp.bfloat16))
    tb, tl = tm.init_model(0, tc, None, dtype=torch.bfloat16, device="cpu")
    want = jax.tree_util.tree_leaves_with_path(jb)
    got = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t, bridge.to_numpy(tb)))
    assert [(jax.tree_util.keystr(p), t.shape, str(t.dtype)) for p, t in want] == [
        (jax.tree_util.keystr(p), t.shape, str(t.dtype)) for p, t in got]
    moe = tb["decoder"]["blocks"]["l0"]["moe"]
    assert moe["router"]["w"].dtype == torch.float32 and moe["w_gate"].shape == (2, 4, 256, 64)
    assert base_storage(tb) == "bf16"


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------


def _record_routes(monkeypatch):
    """Record every MoE layer's top-k ``idx`` on both sides, in layer order:
    the port's through its ``_router``, the reference's through a
    ``jax.debug.callback`` in its ``_router`` (its blocks run in a scan)."""
    got, want = [], []
    t_router, j_router = tmoe._router, jmoe._router

    def t_wrap(x, params, mcfg):
        out = t_router(x, params, mcfg)
        got.append(out[1].numpy().copy())
        return out

    def j_wrap(x, params, mcfg):
        out = j_router(x, params, mcfg)
        jax.debug.callback(lambda i: want.append(np.asarray(i).copy()), out[1], ordered=True)
        return out

    monkeypatch.setattr(tmoe, "_router", t_wrap)
    monkeypatch.setattr(jmoe, "_router", j_wrap)
    return got, want


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch,impl", [(QWEN, "auto"), (QWEN, "fused"), (GROK, "auto")])
def test_forward_logits_match_reference(worlds, monkeypatch, arch, impl, dtype):
    """The whole reduced model ("ep" for qwen3-moe, "dense" for grok-1)
    against the reference's. The routing first: in f32 every layer's
    top-k ``idx`` equals the reference's, the logits lie within 1e-4 of max
    |logit| and the aux within 1e-6. On a bf16 base and LoRA (the router
    f32 on both sides) the two sides round differently before each router
    (the port keeps an MoE family's residual stream in f32 and routes on
    its norm's f32 output; the reference rounds both to bf16), so a token
    near a tie between its k-th and (k+1)-th expert may take
    another expert, and its outputs then differ by O(1): the test reports
    those tokens, holds them to at most 1 in 16 tokens, and holds within
    5e-2 the logits of every token that neither flipped nor attends to a
    flip of an earlier layer."""
    w = _world(worlds, arch)
    jc, tc = w["jcfg"], w["cfg"]
    toks = _tokens(jc)
    bf16 = dtype == "bf16"
    got_routes, want_routes = _record_routes(monkeypatch)
    jb, jl = (_bf16(w["base"]), _bf16(w["lora"])) if bf16 else (w["base"], w["lora"])

    def ref(b, lo, sc, t):
        h, _, a = jm.forward(b, lo, sc, {"tokens": t}, jc, n_pack=2)
        return jnp.asarray(jm.logits(b, h, jc), jnp.float32), a

    want, jaux = jax.jit(ref)(jb, jl, w["jmeta"].scales(), jnp.asarray(toks))
    jax.effects_barrier()
    want = np.asarray(want)
    tb, tl = ((_port(w["base"], torch.bfloat16), _port(w["lora"], torch.bfloat16))
              if bf16 else (w["tbase"], w["tlora"]))
    assert tb["decoder"]["blocks"]["l0"]["moe"]["router"]["w"].dtype == torch.float32
    th, caches, aux = tm.forward(tb, tl, w["meta"].scales(), {"tokens": torch.from_numpy(toks)},
                                 tc, n_pack=2, kcfg=KernelConfig(impl=impl))
    assert caches is None and aux.dtype == torch.float32 and aux.shape == ()
    got = _np(tm.logits(tb, th, tc))
    assert len(got_routes) == len(want_routes) == tc.n_layers
    flipped = sorted((layer, t // S, t % S) for layer, (g, r) in enumerate(zip(got_routes,
                                                                             want_routes))
                     for t in range(g.shape[0]) if set(g[t]) != set(r[t]))
    if not bf16:
        for g, r in zip(got_routes, want_routes):
            np.testing.assert_array_equal(g, r)
        _close(got, want, LOGITS)
        np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
        return
    print(f"bf16 routing: {len(flipped)} (layer, row, position) of {NB * S} tokens x "
          f"{tc.n_layers} layers took another expert: {flipped}")
    assert len(flipped) <= NB * S // 16, flipped
    # a flipped token's own logits, and, when it flipped before the last
    # layer, every later position of its row (the next layers attend to it)
    keep = np.ones((NB, S), bool)
    for layer, row, pos in flipped:
        keep[row, pos:] = False if layer < tc.n_layers - 1 else keep[row, pos:]
        keep[row, pos] = False
    _close(got[keep], want[keep], LOGITS_BF16)


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_packed_step_matches_reference(worlds, impl):
    """Step 1 of the packed loss with the aux (weight 0.01): the total loss
    within 1e-5 of the reference's, the per-adapter CE within 1e-5, every
    f32 LoRA gradient (q, k, v, o; a and b) within 1e-4 of the largest
    value of the reference's."""
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
    kc = KernelConfig(impl=impl, ranks=meta.ranks)
    tot, per, grads = packed_value_and_grad(w["tlora"], w["tbase"], tb, tc, 2,
                                            meta.scales("cpu"), kcfg=kc)
    np.testing.assert_allclose(tot.item(), jtot, rtol=LOSS)
    _close(per, jper, LOSS)
    _, _, no_aux = packed_value_and_grad(w["tlora"], w["tbase"], tb, tc, 2, meta.scales("cpu"),
                                         aux_weight=0.0, kcfg=kc)
    got = jax.tree_util.tree_leaves(bridge.to_numpy(grads))
    assert len(got) == len(want) == 4 * 2
    # the aux's weight moves the gradients: they are held with it in
    assert any(not np.array_equal(a, b) for a, b in zip(
        got, jax.tree_util.tree_leaves(bridge.to_numpy(no_aux))))
    for g, ref in zip(got, want):
        assert np.abs(_np(ref)).max() > 0
        _close(g, ref, GRAD)


def test_prefill_then_decode_match_reference(worlds):
    """Prefill on 20 tokens, then 3 decode steps at a shared position,
    against the reference's (f32 logits 1e-4); an MoE layer adds no cache
    leaf, so ``pad_caches`` grows the k/v alone."""
    w = _world(worlds)
    jc, tc = w["jcfg"], w["cfg"]
    toks = _tokens(jc, seed=5, s=23)
    jlg, jcaches = jax.jit(lambda b, lo, sc, t: jm.prefill(b, lo, sc, {"tokens": t}, jc,
                                                           n_pack=2))(
        w["base"], w["lora"], w["jmeta"].scales(), jnp.asarray(toks[:, :20]))
    tlg, tcaches = tm.prefill(w["tbase"], w["tlora"], w["meta"].scales(),
                              {"tokens": torch.from_numpy(toks[:, :20])}, tc, n_pack=2)
    _close(tlg, jlg, LOGITS)
    assert {k for k in tcaches["blocks"]["l0"]} == {"attn"}
    from repro.serve.decode import pad_caches as j_pad

    jcaches, tcaches = j_pad(jcaches, 24), pad_caches(tcaches, 24)
    j_step = jax.jit(lambda b, lo, sc, t, c, p: jm.decode_step(b, lo, sc, t, c, p, jc, n_pack=2))
    for i in range(3):
        jlg, jcaches = j_step(w["base"], w["lora"], w["jmeta"].scales(),
                              jnp.asarray(toks[:, 20 + i:21 + i]), jcaches, jnp.asarray(20 + i))
        tlg, tcaches = tm.decode_step(w["tbase"], w["tlora"], w["meta"].scales(),
                                      torch.from_numpy(toks[:, 20 + i:21 + i]), tcaches,
                                      torch.tensor(20 + i), tc, n_pack=2)
        _close(tlg, jlg, LOGITS)


def test_bridge_keeps_the_router_f32():
    """``bridge.to_torch(tree, dtype=bf16)`` casts every floating leaf but
    the router's, which stays f32 (the reference's too), bit for bit; the
    round trip to numpy is bit-exact."""
    jcfg, tcfg, jp, _ = _layer()
    t = bridge.to_torch({"moe": jp}, "cpu", torch.bfloat16)["moe"]
    assert t["router"]["w"].dtype == torch.float32 and t["w_up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(t["router"]["w"].numpy(), jp["router"]["w"])
    back = bridge.to_numpy(t)
    np.testing.assert_array_equal(back["router"]["w"], jp["router"]["w"])
    assert str(back["w_up"].dtype) == "bfloat16"


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_cost_model_counts_match_reference(reduce):
    """qwen3-moe: the parameter count (30.53 B at full size: the experts
    29.0 B of it), the active count (3.35 B: 8 of 128 experts a layer), the
    LoRA count (q, k, v, o) and, with ``REFERENCE_MEMORY``, every price and
    iteration time are the reference's; the experts stay dense in a
    quantized count."""
    jc, tc = _cfgs(QWEN, reduce)
    assert tcm.model_param_count(tc) == jcm.model_param_count(jc)
    assert tcm.active_param_count(tc) == jcm.active_param_count(jc)
    for r in (8, 16, 128):
        assert tcm.lora_param_count(tc, r) == jcm.lora_param_count(jc, r)
    meta = pack_meta([LoraConfig(rank=16, alpha=16.0)])
    one = tc.replace(n_layers=1)
    assert sum(t.numel() for t in tree_leaves(tm.lora_zeros(one, meta, device="meta"))) == (
        tcm.lora_param_count(one, 16))
    d = tc.d_model
    attn = d * 128 * 32 * 2 + d * 128 * 4 * 2
    if not reduce:
        assert tcm.model_param_count(tc) == 30_531_911_680
        assert tcm.moe_param_count(tc) * 48 == 48 * (128 * 3 * d * 768 + d * 128)
        assert tcm.quantized_param_count(tc, "int8") == 48 * attn
    jmod = jcm.CostModel(jc, jcm.A100_40G)
    tmod = tcm.CostModel(tc, tcm.A100_40G, **tcm.REFERENCE_MEMORY)
    assert tmod.base_weight_bytes() == jmod.base_weight_bytes()
    js, ts = j_space(300, seq_len=512)[::37], default_search_space(300, seq_len=512)[::37]
    for k in (1, 3, len(ts)):
        assert tmod.job_mem_bytes(ts[:k], 1, 512) == jmod.job_mem_bytes(js[:k], 1, 512)
        assert tmod.iter_time(ts[:k], 1, 512) == jmod.iter_time(js[:k], 1, 512)


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_planner_matches_reference(reduce):
    """qwen3-moe under the reference's memory accounting, on an A100 preset
    scaled so packs split into several jobs: the port's plan ``==`` the
    reference's, job for job."""
    jc, tc = _cfgs(QWEN, reduce)
    hw = dict(mem_bytes=(2e9 if reduce else 120e9))
    jcmod = jcm.CostModel(jc, jcm.A100_40G.scaled(**hw))
    tcmod = tcm.CostModel(tc, tcm.A100_40G.scaled(**hw), **tcm.REFERENCE_MEMORY)
    idx = range(3, 300, 23)
    js, ts = j_space(300, seq_len=512), default_search_space(300, seq_len=512)
    js, ts = [js[i] for i in idx], [ts[i] for i in idx]
    tp, jp = plan(tcmod, ts, 4, 512, 50), j_plan(jcmod, js, 4, 512, 50)
    assert len(tp.jobs) > 1
    assert [(tuple(j.config_ids), j.degree, j.start, j.end) for j in tp.jobs] == [
        (tuple(j.config_ids), j.degree, j.start, j.end) for j in jp.jobs]
    assert tp.makespan == jp.makespan


# ---------------------------------------------------------------------------
# the port's own invariants
# ---------------------------------------------------------------------------


def test_packed_adapter_equals_the_adapter_alone(worlds):
    """Port against port, at ``reduced()`` size (nothing dropped) with
    ``aux_weight=0`` (the aux is one scalar over the pack, which couples
    its adapters): adapter 1's CE and LoRA gradients in the pack of 2 equal
    its own run alone within 1e-5."""
    w = _world(worlds)
    tc, meta = w["cfg"], w["meta"]
    batch = next(packed_batch_iterator(tc, [LoraConfig(**c) for c in PACK], seq=S, device="cpu"))
    _, per, grads = packed_value_and_grad(w["tlora"], w["tbase"], batch, tc, 2,
                                          meta.scales("cpu"), aux_weight=0.0,
                                          kcfg=KernelConfig(ranks=meta.ranks))
    alone = jax.tree.map(lambda t: t[:, 1:2], w["lora"])  # the pack axis of the stacked leaves
    meta1 = pack_meta([LoraConfig(**PACK[1])])
    one = {k: v[2:] for k, v in batch.items()}
    _, per1, grads1 = packed_value_and_grad(_port(alone), w["tbase"], one, tc, 1,
                                            meta1.scales("cpu"), aux_weight=0.0)
    _close(per1, per[1:], 1e-5)
    for g, g1 in zip(tree_leaves(grads), tree_leaves(grads1)):
        _close(g1, g[:, 1:2], 1e-5)


def test_recomputed_blocks_equal_the_eager_forward(worlds):
    """A checkpointed stack's loss and LoRA gradients (each block recomputed
    in the backward, the MoE dispatch again) equal the stack's without
    checkpointing, bit for bit; so do two runs of the same step."""
    w = _world(worlds)
    tc, meta = w["cfg"], w["meta"]
    toks = torch.from_numpy(_tokens(tc, seed=3))
    out = []
    for remat in (True, False, True):
        lora = {k: v for k, v in w["tlora"].items()}
        leaves = jax.tree.map(lambda t: t.detach().clone().requires_grad_(True), lora)
        with torch.enable_grad():
            h, _, aux = tm.forward(w["tbase"], leaves, meta.scales(), {"tokens": toks}, tc,
                                   n_pack=2, remat=remat)
            loss = (h.float() ** 2).mean() + 0.01 * aux
            loss.backward()
        out.append((loss.detach(), [t.grad for t in tree_leaves(leaves)]))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, out[0][1]))


def test_launcher_trains_and_saves_adapters(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b
    --reduced --device cpu``: finite losses, the attention adapters in the
    pool (the experts carry none)."""
    per = launch_train.main(["--arch", QWEN, "--reduced", "--device", "cpu", "--steps", "2",
                             "--seq", "16", "--log-every", "0", "--pool", str(tmp_path)])
    assert per.shape == (2,) and np.isfinite(per).all()
    assert f"arch={QWEN}-reduced" in capsys.readouterr().out
    pool = CheckpointPool(str(tmp_path))
    assert pool.list() == [f"{QWEN}-reduced_adapter_000", f"{QWEN}-reduced_adapter_001"]
    ad = pool.load_adapter(pool.list()[0])
    assert set(ad["decoder"]["blocks"]["l0"]) == {"attn"}
    assert set(ad["decoder"]["blocks"]["l0"]["attn"]) == {"q", "k", "v", "o"}
    assert np.isfinite(pool.load_meta(pool.list()[1])["final_loss"])
