"""gemma3-1b in the port against the JAX package, on the CPU.

The family brings per-layer sliding windows (every 6th layer global, with
its own rope theta), the gated GELU MLP and tied embeddings. Reduced
gemma3-1b keeps one whole local:global period (6 layers: 5 local with a
64-token window, 1 global; GQA 4 heads over 1 kv head); weights from the
reference's ``init_model`` (LoRA + 0.02 N(0, 1) from a seed) through
``repro_torch.bridge``. Sequences pass the window and exceed ``chunk_q``, so
the windowed band path runs. Tolerances, f32 at full f32 (no TF32):
attention rtol/atol 1e-5; whole-model logits 1e-4; a packed step's
per-adapter loss and every LoRA gradient 1e-4 of the largest value of the
compared array. The planner is held ``==`` to the reference on full
gemma3-1b (the reference's memory accounting).
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
from repro.models import model as jm
from repro.models import transformer as jtr
from repro.models.layers import attention as jattn
from repro.sched import cost_model as jcm
from repro.sched.planner import plan as j_plan
from repro.serve.decode import pad_caches as j_pad
from repro.train.data import packed_batch_iterator as j_batches
from repro.train.trainer import packed_loss_fn as j_packed_loss_fn
from repro_torch import bridge
from repro_torch.configs import LoraConfig, default_search_space, get_config, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.kernels.ops import KernelConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import model as tm
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import attention as tattn
from repro_torch.sched import cost_model as tcm
from repro_torch.sched.planner import plan
from repro_torch.train import losses
from repro_torch.train.checkpoint import CheckpointPool
from repro_torch.train.data import packed_batch_iterator
from repro_torch.train.optimizer import adamw_update, init_opt_state
from repro_torch.train.trainer import make_packed_step, packed_value_and_grad
from repro_torch.tree import tree_leaves

ARCH = "gemma3-1b"
F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
NB = 4
# past the reduced 64-token window, and over two query chunks of CHUNK_Q
S, CHUNK_Q = 80, 32
PACK = [dict(rank=8, alpha=8.0, learning_rate=1e-3, batch_size=2),
        dict(rank=16, alpha=4.0, learning_rate=5e-4, batch_size=2)]


def _cfgs(reduce=True, n_layers=None):
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    if reduce:
        jc, tc = j_reduced(jc), reduced(tc)
    if n_layers is not None:
        jc, tc = jc.replace(n_layers=n_layers), tc.replace(n_layers=n_layers)
    return jc, tc


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))


def _close(got, want, rtol):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _port(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def world():
    jcfg, cfg = _cfgs()
    jmeta = j_pack_meta([JLoraConfig(**c) for c in PACK])
    meta = pack_meta([LoraConfig(**c) for c in PACK])
    base, lora = jm.init_model(jax.random.PRNGKey(0), jcfg, jmeta)
    rng = np.random.RandomState(7)
    lora = jax.tree.map(lambda x: x + 0.02 * rng.standard_normal(x.shape).astype(np.float32), lora)
    return dict(jcfg=jcfg, cfg=cfg, jmeta=jmeta, meta=meta, base=base, lora=lora,
                tbase=_port(base), tlora=_port(lora))


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_config_matches_reference_field_for_field(reduce):
    """Every field the port's config has equals the reference's, the
    attention's too; reduced keeps 6 layers and a window of 64."""
    jc, tc = _cfgs(reduce=reduce)
    for f in dataclasses.fields(tc):
        if f.name == "attention":
            for af in dataclasses.fields(tc.attention):
                assert getattr(tc.attention, af.name) == getattr(jc.attention, af.name), af.name
        else:
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert (tc.mlp_kind, tc.norm_kind, tc.tie_embeddings) == ("gelu", "rmsnorm", True)
    if reduce:
        assert (tc.n_layers, tc.attention.sliding_window) == (6, 64)


@pytest.mark.parametrize("n_layers", [None, 8, 26])
def test_layer_specs_and_stacking_match_reference(world, n_layers):
    """Windows and rope thetas per layer, the period and the block/rest
    split (full gemma3: 4 stacked blocks of 6 and 2 ``rest`` layers) and
    the parameter tree's shapes (8 layers: a block and 2 ``rest``)."""
    jc, tc = _cfgs(reduce=n_layers != 26, n_layers=n_layers)
    js, ts = jtr.layer_specs(jc), ttr.layer_specs(tc)
    assert [(s.window, s.theta) for s in ts] == [(s.window, s.theta) for s in js]
    assert ttr.find_period(ts) == jtr.find_period(js) == 6
    if n_layers == 26:
        assert divmod(len(ts), 6) == (4, 2)
        assert sorted(s.theta for s in ts[5::6]) == [1e6] * 4
        return
    if n_layers is None:
        jbase, jlora = world["base"], world["lora"]
    else:
        jbase, jlora = jm.init_model(jax.random.PRNGKey(0), jc, world["jmeta"])
    tbase, tlora = tm.init_model(0, tc, world["meta"], device="cpu")

    def shapes(tree):
        return jax.tree.map(lambda t: tuple(t.shape), tree)

    assert shapes(bridge.to_numpy(tbase)) == shapes(jbase)
    assert shapes(bridge.to_numpy(tlora)) == shapes(jlora)


@pytest.mark.parametrize("window", [64, 50])
def test_flash_attention_window_band(window):
    """The band path (a window, Sq > chunk_q: each chunk reads only the K/V
    it reaches) against the reference's, and against one unchunked call."""
    rng = np.random.RandomState(1)
    b, sq, h, kv, d = 2, 160, 4, 1, 32
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sq, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sq, kv, d)).astype(np.float32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 window=window, chunk_q=64)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tattn.flash_attention(tq, tk, tv, window=window, chunk_q=64)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    whole = tattn.flash_attention(tq, tk, tv, window=window, chunk_q=512)
    np.testing.assert_allclose(_np(got), _np(whole), **F32)
    full = tattn.flash_attention(tq, tk, tv, chunk_q=64)
    assert not np.allclose(_np(full)[:, window:], _np(got)[:, window:], atol=1e-3)


def test_decode_attention_window_per_row_and_shared():
    """One-token attention with the window masked: per-row positions past
    the window (and one before it), and a shared position."""
    rng = np.random.RandomState(2)
    b, smax, h, kv, d, window = 4, 160, 4, 1, 32, 64
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, smax, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, smax, kv, d)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for pos in (np.array([70, 100, 159, 10]), np.array(130)):
        want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(pos), window=window)
        got = tattn.decode_attention(tq, tk, tv, torch.from_numpy(pos), window=window)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        unmasked = tattn.decode_attention(tq, tk, tv, torch.from_numpy(pos))
        assert not np.allclose(_np(unmasked), _np(got), atol=1e-3)


def _tokens(cfg, seed=4, s=S):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(NB, s)).astype(np.int32)


def _reference_forward(world, toks):
    """The reference's logits and caches at ``toks`` (S = 80, query chunks
    of 32), once per module: the forward and the prefill tests read them."""
    if "forward" not in world:
        jc = world["jcfg"]
        jh, jcaches, _ = jm.forward(world["base"], world["lora"], world["jmeta"].scales(),
                                    {"tokens": jnp.asarray(toks)}, jc, n_pack=2,
                                    chunk_q=CHUNK_Q, make_cache=True)
        world["forward"] = jm.logits(world["base"], jh, jc), jcaches
    return world["forward"]


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_forward_logits(world, impl):
    """The whole model at S = 80 over query chunks of 32: local layers on
    the band path, the global one over every key; logits through the tied
    embedding. Both impls against the reference's default one (the fused
    op keeps xA in f32: within the tolerance)."""
    jc, tc = world["jcfg"], world["cfg"]
    toks = _tokens(jc)
    want = _reference_forward(world, toks)[0]
    th, _, _ = tm.forward(world["tbase"], world["tlora"], world["meta"].scales(),
                       {"tokens": torch.from_numpy(toks)}, tc, n_pack=2, chunk_q=CHUNK_Q,
                       kcfg=KernelConfig(impl=impl))
    got = tm.logits(world["tbase"], th, tc)
    assert got.shape == (NB, S, tc.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)


def _check_step(world, batch, grads, impl, per):
    """One ``make_packed_step`` step from fresh AdamW state gives the
    per-adapter loss of ``packed_value_and_grad`` and AdamW's update on its
    gradients, bit for bit."""
    tc, meta, lora = world["cfg"], world["meta"], world["tlora"]
    step = make_packed_step(tc, 2, impl=impl, ranks=meta.ranks, chunk_q=CHUNK_Q)
    new, _, m = step(world["tbase"], lora, init_opt_state(lora), batch, meta.scales("cpu"),
                     meta.lr_vector("cpu"), None)
    assert torch.equal(m["per_adapter_loss"], per)
    want, _ = adamw_update(grads, init_opt_state(lora), lora, meta.lr_vector("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(want)))


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_packed_step_loss_and_grads_match_reference(world, impl):
    """One ``make_packed_step`` step at S = 80 over query chunks of 32 (the
    windowed band in the backward too): its per-adapter loss, and every
    LoRA gradient of the function it runs, ``packed_value_and_grad``; its
    update is AdamW's on those gradients, bit for bit."""
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
    _close(per, jper, 1e-4)
    _check_step(world, tb, grads, impl, per)
    got = jax.tree_util.tree_leaves(bridge.to_numpy(grads))
    assert len(got) == len(want) == 6 * 7 * 2  # 6 layers x 7 projections x (a, b)
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_prefill_then_decode_past_the_window(world):
    """prefill of 80 tokens, then three decode steps at per-row positions
    past the 64-token window (f32 caches: the local layers mask the
    oldest entries, the global layer reads them)."""
    jc, tc = world["jcfg"], world["cfg"]
    s = S
    toks = _tokens(jc)
    jlg, jcaches = _reference_forward(world, toks)
    jlg = jlg[:, -1:]  # the reference's prefill: the last position's logits
    tlg, tcaches = tm.prefill(world["tbase"], world["tlora"], world["meta"].scales(),
                              {"tokens": torch.from_numpy(toks)}, tc, n_pack=2, chunk_q=CHUNK_Q)
    np.testing.assert_allclose(_np(tlg), _np(jlg), **LOGITS)
    jcaches = j_pad(jcaches, S + 8)
    tcaches = bridge.to_torch(jax.tree.map(np.asarray, jcaches), "cpu")
    pos = np.array([s, s - 1, s, s - 5])
    tok = np.argmax(np.asarray(jlg)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(3):
        jlg, jcaches = jm.decode_step(world["base"], world["lora"], world["jmeta"].scales(),
                                      jnp.asarray(tok), jcaches, jnp.asarray(pos), jc, n_pack=2)
        tlg, tcaches = tm.decode_step(world["tbase"], world["tlora"], world["meta"].scales(),
                                      torch.from_numpy(tok), tcaches, torch.from_numpy(pos),
                                      tc, n_pack=2)
        np.testing.assert_allclose(_np(tlg), _np(jlg), **LOGITS)
        tok = np.argmax(np.asarray(jlg)[:, -1], -1).astype(np.int32)[:, None]
        pos = pos + 1


def test_tied_embeddings_are_read_in_place(world, monkeypatch):
    """No ``lm_head`` leaf; the LM head is a view of the embedding, and the
    chunked CE reads it in place in every chunk (no copy of the (d, V)
    matrix per chunk or per step). ``init_lora`` is ``init_model``'s LoRA
    bit for bit without the head's draws."""
    tc, meta = world["cfg"], world["meta"]
    base, lora = tm.init_model(0, tc, meta, device="cpu")
    assert "lm_head" not in base and "lm_head" not in world["tbase"]
    emb = base["embed"]["w"]
    assert tm.unembed_w(base, tc).data_ptr() == emb.data_ptr()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tm.init_lora(0, tc, meta, device="cpu")),
                                                 tree_leaves(lora)))
    seen = []
    real = losses._chunk_ce

    def spy(h, w, *a):
        seen.append(w.to(h.dtype).data_ptr() == emb.data_ptr())
        return real(h, w, *a)

    monkeypatch.setattr(losses, "_chunk_ce", spy)
    tb = next(packed_batch_iterator(tc, [LoraConfig(**c) for c in PACK], seq=S, device="cpu"))
    packed_value_and_grad(lora, base, tb, tc, 2, meta.scales("cpu"), vocab_chunk=32)
    assert len(seen) >= 3 and all(seen)


def test_planner_matches_reference():
    """Full gemma3-1b, the reference's memory accounting: the port's cost
    model and plan ``==`` the reference's (its LoRA count agrees: every
    target exists)."""
    jc, tc = _cfgs(reduce=False)
    assert tcm.model_param_count(tc) == jcm.model_param_count(jc)
    for r in (8, 128):
        assert tcm.lora_param_count(tc, r) == jcm.lora_param_count(jc, r)
    jcmod = jcm.CostModel(jc, jcm.A100_40G)
    tcmod = tcm.CostModel(tc, tcm.A100_40G, **tcm.REFERENCE_MEMORY)
    idx = range(3, 120, 13)
    js, ts = j_space(300, seq_len=1024), default_search_space(300, seq_len=1024)
    js, ts = [js[i] for i in idx], [ts[i] for i in idx]
    for seq in (512, 1024):
        assert tcmod.job_mem_bytes(ts, 1, seq) == jcmod.job_mem_bytes(js, 1, seq)
        assert tcmod.iter_time(ts, 1, seq) == jcmod.iter_time(js, 1, seq)
    tp, jp = plan(tcmod, ts, 4, 1024, 50), j_plan(jcmod, js, 4, 1024, 50)
    assert [(tuple(j.config_ids), j.degree, j.start, j.end) for j in tp.jobs] == [
        (tuple(j.config_ids), j.degree, j.start, j.end) for j in jp.jobs]
    assert tp.makespan == jp.makespan


def test_launcher_trains_and_saves_adapters(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch gemma3-1b --reduced
    --device cpu``: finite losses, the adapters in the pool."""
    per = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                             "--seq", "16", "--log-every", "0", "--pool", str(tmp_path)])
    assert per.shape == (2,) and np.isfinite(per).all()
    assert "arch=gemma3-1b-reduced" in capsys.readouterr().out
    pool = CheckpointPool(str(tmp_path))
    assert pool.list() == [f"{ARCH}-reduced_adapter_000", f"{ARCH}-reduced_adapter_001"]
    ad = pool.load_adapter(pool.list()[0])
    assert set(ad["decoder"]["blocks"]["l0"]["mlp"]) == {"gate", "up", "down"}
    assert np.isfinite(pool.load_meta(pool.list()[1])["final_loss"])
