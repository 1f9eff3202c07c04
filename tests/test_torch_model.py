"""The port's dense decoder against the JAX package's, on the CPU.

Weights come from the JAX ``init_model`` (LoRA tree + 0.02, so every delta
is non-zero) and cross through ``repro_torch.bridge``; inputs are made with
numpy. Tolerances, f32: single layers rtol/atol 1e-5, whole-model logits
1e-4. Decode against bf16 caches rounds k/v, attention probabilities and
the o projection's input to bf16 in both packages, at their own points of
accumulation: 2e-2 there.
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
from repro.models.layers import attention as jattn
from repro.models.layers import common as jcommon
from repro.models.transformer import make_rope_cache as j_rope_cache
from repro_torch import bridge
from repro_torch.configs import LoraConfig, get_config, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.models import model as tm
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import common as tcommon
from repro_torch.models.transformer import make_rope_cache
from repro_torch.tree import tree_index

F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
BF16_CACHE = dict(rtol=2e-2, atol=2e-2)
NB, S = 4, 10


def _cfgs(kv):
    jc, tc = j_reduced(j_get_config("qwen25-7b")), reduced(get_config("qwen25-7b"))
    if kv is not None:
        jc = jc.replace(attention=dataclasses.replace(jc.attention, n_kv_heads=kv))
        tc = tc.replace(attention=dataclasses.replace(tc.attention, n_kv_heads=kv))
    return jc, tc


@pytest.fixture(scope="module", params=[None, 2], ids=["kv4", "kv2"])
def world(request):
    """Reduced qwen25-7b (kv4: as ``reduced`` gives it, n_kv == n_heads;
    kv2: grouped queries) with a 2-adapter pack of ranks 8 and 16."""
    jcfg, cfg = _cfgs(request.param)
    assert (jcfg.d_model, jcfg.d_ff, jcfg.n_layers, jcfg.vocab_size) == (
        cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size)
    jmeta = j_pack_meta([JLoraConfig(rank=8, alpha=8.0), JLoraConfig(rank=16, alpha=4.0)])
    meta = pack_meta([LoraConfig(rank=8, alpha=8.0), LoraConfig(rank=16, alpha=4.0)])
    base, lora = jm.init_model(jax.random.PRNGKey(0), jcfg, jmeta)
    lora = jax.tree.map(lambda x: x + 0.02, lora)
    tbase = bridge.to_torch(jax.tree.map(np.asarray, base), "cpu")
    tlora = bridge.to_torch(jax.tree.map(np.asarray, lora), "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jmeta=jmeta, meta=meta, base=base, lora=lora,
                tbase=tbase, tlora=tlora)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else jnp.asarray(t, jnp.float32))


def _layer0(w, key):
    j = jax.tree.map(lambda t: t[0], w["base"]["decoder"]["blocks"]["l0"][key])
    jl = jax.tree.map(lambda t: t[0], w["lora"]["decoder"]["blocks"]["l0"][key])
    t = tree_index(w["tbase"]["decoder"]["blocks"]["l0"][key], 0)
    tl = tree_index(w["tlora"]["decoder"]["blocks"]["l0"][key], 0)
    return j, jl, t, tl


def _x(d, seed=0):
    x = np.random.RandomState(seed).standard_normal((NB, S, d)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_apply_gqa_prefill(world):
    jc, tc = world["jcfg"], world["cfg"]
    jp, jl, tp, tl = _layer0(world, "attn")
    jx, tx = _x(jc.d_model)
    want, jcache = jattn.apply_gqa(
        jp, jl, world["jmeta"].scales(), jx, acfg=jc.attention, n_pack=2,
        rope=j_rope_cache(jc, jnp.arange(S))[jc.attention.rope_theta], make_cache=True)
    got, tcache = tattn.apply_gqa(
        tp, tl, world["meta"].scales(), tx, acfg=tc.attention, n_pack=2,
        rope=make_rope_cache(tc, torch.arange(S))[tc.attention.rope_theta], make_cache=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(tcache["k"]), _np(jcache["k"]), **F32)
    np.testing.assert_allclose(_np(tcache["v"]), _np(jcache["v"]), **F32)


@pytest.mark.parametrize("cache_dtype", ["float32"])
def test_apply_gqa_decode_vector_pos(world, cache_dtype):
    """One-token decode at per-row positions against a filled cache (bf16
    caches: ``test_prefill_then_vector_pos_decode``)."""
    jc, tc = world["jcfg"], world["cfg"]
    jp, jl, tp, tl = _layer0(world, "attn")
    a = jc.attention
    rng = np.random.RandomState(1)
    smax = 16
    ck = rng.standard_normal((NB, smax, a.n_kv_heads, a.head_dim)).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    x = rng.standard_normal((NB, 1, jc.d_model)).astype(np.float32)
    pos = np.array([3, 9, 0, 15])
    jdt = jnp.float32 if cache_dtype == "float32" else jnp.bfloat16
    jcache = {"k": jnp.asarray(ck).astype(jdt), "v": jnp.asarray(cv).astype(jdt)}
    tcache = bridge.to_torch({"k": np.asarray(jcache["k"]), "v": np.asarray(jcache["v"])}, "cpu")
    want, jnew = jattn.apply_gqa(
        jp, jl, world["jmeta"].scales(), jnp.asarray(x), acfg=a, n_pack=2,
        rope=j_rope_cache(jc, jnp.asarray(pos)[:, None])[a.rope_theta],
        cache=jcache, pos=jnp.asarray(pos))
    got, tnew = tattn.apply_gqa(
        tp, tl, world["meta"].scales(), torch.from_numpy(x), acfg=tc.attention, n_pack=2,
        rope=make_rope_cache(tc, torch.from_numpy(pos)[:, None])[a.rope_theta],
        cache=tcache, pos=torch.from_numpy(pos))
    tol = F32 if cache_dtype == "float32" else BF16_CACHE
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(tnew["k"]), _np(jnew["k"]), **tol)
    np.testing.assert_allclose(_np(tnew["v"]), _np(jnew["v"]), **tol)


def test_apply_mlp(world):
    jc = world["jcfg"]
    jp, jl, tp, tl = _layer0(world, "mlp")
    jx, tx = _x(jc.d_model, seed=2)
    want = jcommon.apply_mlp(jp, jl, world["jmeta"].scales(), jx, "swiglu", n_pack=2)
    got = tcommon.apply_mlp(tp, tl, world["meta"].scales(), tx, n_pack=2)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_apply_norm():
    x = np.random.RandomState(3).standard_normal((3, 5, 64)).astype(np.float32) * 3
    p = {"scale": np.linspace(0.5, 1.5, 64).astype(np.float32)}
    want = jcommon.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), "rmsnorm")
    got = tcommon.apply_norm(bridge.to_torch(p, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def _tokens(cfg, seed=4, s=S):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(NB, s)).astype(np.int32)


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_forward_logits(world, impl):
    from repro.kernels.ops import KernelConfig as JKC
    from repro_torch.kernels.ops import KernelConfig

    jc, tc = world["jcfg"], world["cfg"]
    toks = _tokens(jc)
    jh, _, _ = jm.forward(world["base"], world["lora"], world["jmeta"].scales(),
                          {"tokens": jnp.asarray(toks)}, jc, n_pack=2,
                          kcfg=JKC(impl="fused_xla" if impl == "fused" else "xla"))
    want = jm.logits(world["base"], jh, jc)
    th, _, _ = tm.forward(world["tbase"], world["tlora"], world["meta"].scales(),
                       {"tokens": torch.from_numpy(toks)}, tc, n_pack=2,
                       kcfg=KernelConfig(impl=impl))
    got = tm.logits(world["tbase"], th, tc)
    assert got.shape == (NB, S, tc.padded_vocab)
    np.testing.assert_allclose(_np(th), _np(jh), **LOGITS)
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)


def test_prefill_then_vector_pos_decode(world):
    """prefill's last logits and caches, then two decode steps at per-row
    positions (rows overwrite the cache at different slots), fed the same
    tokens on both sides. Caches f32 for kv4 (exact comparison) and bf16,
    the engine's, for kv2."""
    jc, tc = world["jcfg"], world["cfg"]
    cache_dtype = "bfloat16" if jc.attention.n_kv_heads == 2 else "float32"
    toks = _tokens(jc, seed=5)
    jlg, jcaches = jm.prefill(world["base"], world["lora"], world["jmeta"].scales(),
                              {"tokens": jnp.asarray(toks)}, jc, n_pack=2)
    tlg, tcaches = tm.prefill(world["tbase"], world["tlora"], world["meta"].scales(),
                              {"tokens": torch.from_numpy(toks)}, tc, n_pack=2)
    np.testing.assert_allclose(_np(tlg), _np(jlg), **LOGITS)
    np.testing.assert_allclose(_np(tcaches["blocks"]["l0"]["attn"]["k"]),
                               _np(jcaches["blocks"]["l0"]["attn"]["k"]), **LOGITS)
    from repro.serve.decode import pad_caches as j_pad
    from repro_torch.serve.decode import pad_caches as t_pad

    jdt = jnp.float32 if cache_dtype == "float32" else jnp.bfloat16
    jcaches = jax.tree.map(lambda t: t.astype(jdt), j_pad(jcaches, 16))
    tcaches = bridge.to_torch(jax.tree.map(np.asarray, jcaches), "cpu")
    assert t_pad({"blocks": {"l0": {"attn": {"k": torch.zeros(2, NB, S, 1, 1)}}}}, 16)[
        "blocks"]["l0"]["attn"]["k"].shape == (2, NB, 16, 1, 1)
    pos = np.array([S, S - 1, S, S - 3])
    tok = np.argmax(np.asarray(jlg)[:, -1], -1).astype(np.int32)[:, None]
    tol = LOGITS if cache_dtype == "float32" else BF16_CACHE
    for _ in range(2):
        jlg, jcaches = jm.decode_step(world["base"], world["lora"], world["jmeta"].scales(),
                                      jnp.asarray(tok), jcaches, jnp.asarray(pos), jc, n_pack=2)
        tlg, tcaches = tm.decode_step(world["tbase"], world["tlora"], world["meta"].scales(),
                                      torch.from_numpy(tok), tcaches, torch.from_numpy(pos),
                                      tc, n_pack=2)
        np.testing.assert_allclose(_np(tlg), _np(jlg), **tol)
        np.testing.assert_allclose(_np(tcaches["blocks"]["l0"]["attn"]["v"]),
                                   _np(jcaches["blocks"]["l0"]["attn"]["v"]), **tol)
        tok = np.argmax(np.asarray(jlg)[:, -1], -1).astype(np.int32)[:, None]
        pos = pos + 1


def test_init_model_layout_matches_reference(world):
    """The port's own init gives the reference's tree structure and shapes."""
    jc, tc = world["jcfg"], world["cfg"]
    tbase, tlora = tm.init_model(0, tc, world["meta"], device="cpu")

    def shapes(tree):
        return jax.tree.map(lambda t: tuple(t.shape), tree)

    assert shapes(bridge.to_numpy(tbase)) == shapes(world["base"])
    assert shapes(bridge.to_numpy(tlora)) == shapes(world["lora"])
    assert shapes(bridge.to_numpy(tm.lora_zeros(tc, world["meta"], device="cpu"))) == shapes(world["lora"])
    # B starts at zero and A's rank padding is zero, as in the reference
    q = tlora["decoder"]["blocks"]["l0"]["attn"]["q"]
    assert torch.count_nonzero(q["b"]) == 0
    assert torch.count_nonzero(q["a"][:, 0, :, 8:]) == 0


@pytest.mark.parametrize("seed", [0, 5])
def test_init_lora_is_init_models_lora_bit_for_bit(world, seed):
    """``init_lora`` (the executor's templates) gives ``init_model``'s LoRA
    tree, bit for bit, in the reference's layout, without its base."""
    tc, meta = world["cfg"], world["meta"]
    want = tm.init_model(seed, tc, meta, device="cpu")[1]
    got = tm.init_lora(seed, tc, meta, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), bridge.to_numpy(got)) == jax.tree.map(
        lambda t: tuple(t.shape), world["lora"])
    assert jax.tree.structure(bridge.to_numpy(got)) == jax.tree.structure(bridge.to_numpy(want))
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(bridge.to_numpy(got)),
                                                      jax.tree.leaves(bridge.to_numpy(want))))
