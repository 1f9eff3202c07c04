"""starcoder2-7b in the port against the JAX package, on the CPU.

The family brings LayerNorm (f32, eps 1e-6, a bias), the classic two-matrix
GELU MLP ("gelu2": up -> tanh GELU -> down, no gate and no gate LoRA) and
biased GQA. Reduced starcoder2-7b (kv4: as ``reduced`` gives it, n_kv ==
n_heads) and its n_kv_heads=2 variant; weights from the reference's
``init_model`` (LoRA + 0.02 N(0, 1) from a seed, so every delta is non-zero
and no B is constant: a delta constant across features is invisible after
a LayerNorm, and its A's gradient would be rounding noise), carried across
by ``repro_torch.bridge``. Tolerances, f32 at full f32 (no TF32): single
layers rtol/atol 1e-5; whole-model logits 1e-4; a packed step's per-adapter
loss and every LoRA gradient 1e-4 of the largest value of the compared
array; decode against bf16 caches 2e-2.
"""
import dataclasses
import hashlib

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
from repro.models.layers import common as jcommon
from repro.sched import cost_model as jcm
from repro.serve.decode import pad_caches as j_pad
from repro.train.data import packed_batch_iterator as j_batches
from repro.train.trainer import packed_loss_fn as j_packed_loss_fn
from repro_torch import bridge
from repro_torch.configs import LoraConfig, get_config, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.kernels.ops import KernelConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import model as tm
from repro_torch.models.layers import common as tcommon
from repro_torch.sched import cost_model as tcm
from repro_torch.train.checkpoint import CheckpointPool
from repro_torch.train.data import packed_batch_iterator
from repro_torch.train.optimizer import adamw_update, init_opt_state
from repro_torch.train.trainer import make_packed_step, packed_value_and_grad
from repro_torch.tree import tree_leaves

ARCH = "starcoder2-7b"
F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)
BF16_CACHE = dict(rtol=2e-2, atol=2e-2)
NB, S = 4, 10
PACK = [dict(rank=8, alpha=8.0, learning_rate=1e-3, batch_size=2),
        dict(rank=16, alpha=4.0, learning_rate=5e-4, batch_size=2)]


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


def _port(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def _perturb(tree, seed=7):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: x + 0.02 * rng.standard_normal(x.shape).astype(np.float32), tree)


@pytest.fixture(scope="module", params=[None, 2], ids=["kv4", "kv2"])
def world(request):
    jcfg, cfg = _cfgs(request.param)
    jmeta = j_pack_meta([JLoraConfig(**c) for c in PACK])
    meta = pack_meta([LoraConfig(**c) for c in PACK])
    base, lora = jm.init_model(jax.random.PRNGKey(0), jcfg, jmeta)
    lora = _perturb(lora)
    return dict(jcfg=jcfg, cfg=cfg, jmeta=jmeta, meta=meta, base=base, lora=lora,
                tbase=_port(base), tlora=_port(lora))


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_config_matches_reference_field_for_field(reduce):
    """Every field the port's config has equals the reference's, the
    attention's too (published dimensions; ``reduced``'s rules)."""
    jc, tc = _cfgs(reduce=reduce)
    for f in dataclasses.fields(tc):
        if f.name == "attention":
            for af in dataclasses.fields(tc.attention):
                assert getattr(tc.attention, af.name) == getattr(jc.attention, af.name), af.name
        else:
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert (tc.mlp_kind, tc.norm_kind, tc.tie_embeddings) == ("gelu2", "layernorm", False)


def test_apply_norm_layernorm():
    rng = np.random.RandomState(3)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1.5).astype(np.float32)
    p = {"scale": np.linspace(0.5, 1.5, 64).astype(np.float32),
         "bias": np.linspace(-0.3, 0.3, 64).astype(np.float32)}
    want = jcommon.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), "layernorm")
    got = tcommon.apply_norm(bridge.to_torch(p, "cpu"), torch.from_numpy(x), "layernorm")
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    # eps is the reference's 1e-6, not F.layer_norm's default 1e-5: a row of
    # tiny variance tells them apart
    flat = np.full((1, 1, 64), 1e-3, np.float32)
    flat[..., ::2] *= -1
    want = jcommon.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(flat), "layernorm")
    got = tcommon.apply_norm(bridge.to_torch(p, "cpu"), torch.from_numpy(flat), "layernorm")
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    f = torch.nn.functional.layer_norm(torch.from_numpy(flat), (64,))
    assert not np.allclose(_np(f), _np(want) - p["bias"], rtol=0.1)
    assert tcommon.init_norm(8, "layernorm")["bias"].abs().sum() == 0


@pytest.mark.parametrize("kind", ["gelu2", "gelu", "swiglu"])
def test_apply_mlp_each_kind(kind):
    """All three MLP kinds (weights, biases and both LoRA factors random);
    "gelu2" has no gate, and the port's ``init_mlp`` builds none; GELU is
    the tanh approximation, as ``jax.nn.gelu``'s default."""
    jmeta = j_pack_meta([JLoraConfig(**c) for c in PACK])
    rng = np.random.RandomState(1)
    d, f, r = 64, 96, jmeta.r_bucket
    dims = {"gate": (d, f), "up": (d, f), "down": (f, d)}
    names = ("up", "down") if kind == "gelu2" else ("gate", "up", "down")

    def rnd(*shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    p = {nm: {"w": rnd(*dims[nm], std=dims[nm][0] ** -0.5), "b": rnd(dims[nm][1], std=0.1)}
         for nm in names}
    lo = {nm: {"a": rnd(2, dims[nm][0], r, std=dims[nm][0] ** -0.5),
               "b": rnd(2, r, dims[nm][1], std=0.1)} for nm in names}
    tp, tlo = tcommon.init_mlp(None, d, f, True, pack_meta([LoraConfig(**c) for c in PACK]),
                               ("gate", "up", "down"), kind=kind, device="cpu")
    assert tuple(tp) == tuple(tlo) == names
    x = np.random.RandomState(2).standard_normal((NB, S, 64)).astype(np.float32) * 2
    want = jcommon.apply_mlp(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, lo),
                             jmeta.scales(), jnp.asarray(x), kind, n_pack=2)
    got = tcommon.apply_mlp(_port(p), _port(lo), pack_meta([LoraConfig(**c) for c in PACK])
                            .scales("cpu"), torch.from_numpy(x), n_pack=2, kind=kind)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def _tokens(cfg, seed=4, s=S):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(NB, s)).astype(np.int32)


def test_init_model_layout_matches_reference(world):
    """The port's own init gives the reference's tree (LayerNorm biases, no
    gate), and ``init_lora`` is ``init_model``'s LoRA bit for bit."""
    tc, meta = world["cfg"], world["meta"]
    tbase, tlora = tm.init_model(0, tc, meta, device="cpu")

    def shapes(tree):
        return jax.tree.map(lambda t: tuple(t.shape), tree)

    assert shapes(bridge.to_numpy(tbase)) == shapes(world["base"])
    assert shapes(bridge.to_numpy(tlora)) == shapes(world["lora"])
    assert shapes(bridge.to_numpy(tm.lora_zeros(tc, meta, device="cpu"))) == shapes(world["lora"])
    assert "gate" not in tbase["decoder"]["blocks"]["l0"]["mlp"]
    assert "bias" in tbase["final_norm"] and "lm_head" in tbase
    got = tm.init_lora(3, tc, meta, device="cpu")
    want = tm.init_model(3, tc, meta, device="cpu")[1]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_forward_logits(world, impl):
    """Both impls against the reference's default one (the fused op keeps
    xA in f32: within the tolerance)."""
    jc, tc = world["jcfg"], world["cfg"]
    toks = _tokens(jc)
    if "logits" not in world:
        jh, _, _ = jm.forward(world["base"], world["lora"], world["jmeta"].scales(),
                              {"tokens": jnp.asarray(toks)}, jc, n_pack=2)
        world["logits"] = jm.logits(world["base"], jh, jc)
    want = world["logits"]
    th, _, _ = tm.forward(world["tbase"], world["tlora"], world["meta"].scales(),
                       {"tokens": torch.from_numpy(toks)}, tc, n_pack=2,
                       kcfg=KernelConfig(impl=impl))
    got = tm.logits(world["tbase"], th, tc)
    assert got.shape == (NB, S, tc.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)


def _reference_step(world):
    """The JAX step's per-adapter loss and LoRA gradients (default impl),
    once per world: both of the port's impls are held to them."""
    if "step" not in world:
        jc, jmeta = world["jcfg"], world["jmeta"]
        jb = next(j_batches(jc, [JLoraConfig(**c) for c in PACK], seq=16))
        (_, jper), jgrads = jax.jit(jax.value_and_grad(
            lambda lo: j_packed_loss_fn(lo, world["base"], jb, jc, 2, jmeta.scales(),
                                        kcfg=jmeta.kernel_config()), has_aux=True))(world["lora"])
        world["step"] = jper, jax.tree_util.tree_leaves(jgrads)
    return world["step"]


def _check_step(world, batch, grads, impl, per):
    """One ``make_packed_step`` step from fresh AdamW state gives the
    per-adapter loss of ``packed_value_and_grad`` and AdamW's update on its
    gradients, bit for bit."""
    tc, meta, lora = world["cfg"], world["meta"], world["tlora"]
    step = make_packed_step(tc, 2, impl=impl, ranks=meta.ranks)
    new, _, m = step(world["tbase"], lora, init_opt_state(lora), batch, meta.scales("cpu"),
                     meta.lr_vector("cpu"), None)
    assert torch.equal(m["per_adapter_loss"], per)
    want, _ = adamw_update(grads, init_opt_state(lora), lora, meta.lr_vector("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(want)))


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_packed_step_loss_and_grads_match_reference(world, impl):
    """One ``make_packed_step`` step: its per-adapter loss, and every LoRA
    gradient (no gate leaf on either side) of the function it runs,
    ``packed_value_and_grad``, against the JAX step with its default impl;
    its update is AdamW's on those gradients, bit for bit."""
    tc, meta = world["cfg"], world["meta"]
    jper, want = _reference_step(world)
    tb = next(packed_batch_iterator(tc, [LoraConfig(**c) for c in PACK], seq=16, device="cpu"))
    _, per, grads = packed_value_and_grad(
        world["tlora"], world["tbase"], tb, tc, 2, meta.scales("cpu"),
        kcfg=KernelConfig(impl=impl, ranks=meta.ranks))
    _close(per, jper, 1e-4)
    _check_step(world, tb, grads, impl, per)
    got = jax.tree_util.tree_leaves(bridge.to_numpy(grads))
    assert len(got) == len(want) == 6 * 2  # q, k, v, o, up, down: (a, b) each, stacked
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("world", [2], indirect=True, ids=["kv2"])
def test_prefill_then_vector_pos_decode(world):
    """prefill's last logits and caches, then two decode steps at per-row
    positions against bf16 caches, the engine's (on the grouped-query
    variant)."""
    jc, tc = world["jcfg"], world["cfg"]
    toks = _tokens(jc, seed=5)
    jlg, jcaches = jm.prefill(world["base"], world["lora"], world["jmeta"].scales(),
                              {"tokens": jnp.asarray(toks)}, jc, n_pack=2)
    tlg, tcaches = tm.prefill(world["tbase"], world["tlora"], world["meta"].scales(),
                              {"tokens": torch.from_numpy(toks)}, tc, n_pack=2)
    np.testing.assert_allclose(_np(tlg), _np(jlg), **LOGITS)
    jcaches = jax.tree.map(lambda t: t.astype(jnp.bfloat16), j_pad(jcaches, 16))
    tcaches = bridge.to_torch(jax.tree.map(np.asarray, jcaches), "cpu")
    pos = np.array([S, S - 1, S, S - 3])
    tok = np.argmax(np.asarray(jlg)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(2):
        jlg, jcaches = jm.decode_step(world["base"], world["lora"], world["jmeta"].scales(),
                                      jnp.asarray(tok), jcaches, jnp.asarray(pos), jc, n_pack=2)
        tlg, tcaches = tm.decode_step(world["tbase"], world["tlora"], world["meta"].scales(),
                                      torch.from_numpy(tok), tcaches, torch.from_numpy(pos),
                                      tc, n_pack=2)
        np.testing.assert_allclose(_np(tlg), _np(jlg), **BF16_CACHE)
        tok = np.argmax(np.asarray(jlg)[:, -1], -1).astype(np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_lora_param_count_leaves_out_the_phantom_gate(reduce):
    """The reference bills a ``gate`` adapter for starcoder2 (its
    ``lora_targets`` name one; its "gelu2" MLP has none). The port counts
    the projections that exist: exactly n_layers x r x (d + d_ff) less,
    which is what its executor allocates. The base's count is the
    reference's (2 MLP matrices)."""
    jc, tc = _cfgs(reduce=reduce)
    assert tcm.model_param_count(tc) == jcm.model_param_count(jc)
    for r in (8, 16, 128):
        diff = jcm.lora_param_count(jc, r) - tcm.lora_param_count(tc, r)
        assert diff == tc.n_layers * r * (tc.d_model + tc.d_ff)
    if reduce:
        meta = pack_meta([LoraConfig(rank=16, alpha=16.0)])
        held = sum(t.numel() for t in tree_leaves(tm.lora_zeros(tc, meta, device="cpu")))
        assert held == tcm.lora_param_count(tc, 16)


def test_launcher_trains_and_saves_adapters(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch starcoder2-7b --reduced
    --device cpu``: finite losses, each adapter in the pool without a gate."""
    per = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                             "--seq", "16", "--log-every", "0", "--pool", str(tmp_path)])
    assert per.shape == (2,) and np.isfinite(per).all()
    assert "arch=starcoder2-7b-reduced" in capsys.readouterr().out
    pool = CheckpointPool(str(tmp_path))
    names = pool.list()
    assert names == [f"{ARCH}-reduced_adapter_000", f"{ARCH}-reduced_adapter_001"]
    ad = pool.load_adapter(names[0])
    assert set(ad["decoder"]["blocks"]["l0"]["mlp"]) == {"up", "down"}
    assert np.isfinite(pool.load_meta(names[1])["final_loss"])


# sha256 of reduced qwen25-7b's init_model trees (ranks 8 and 16; each
# leaf's path, shape, dtype and bytes in the tree's order), taken before
# the new families were added: the earlier phases' numbers rest on them
QWEN_INIT_DIGESTS = {
    0: ("ef7997f49d9a11b73e461e4827209642f94356855fb53b436bcc2ddb8a7da4a7",
        "90f7e1695786ca5535f5c1b6b214f632738fa9d82e21aa671239cb29c6ce92df"),
    5: ("1363a451734044f623e6ee16d0f702810eb4f790a79561b21c9b5bc8b3e6a7a0",
        "8022f6199f16f38ccda5bba865987bd787519343626df88df5c0039184b12e33"),
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


@pytest.mark.parametrize("seed", sorted(QWEN_INIT_DIGESTS))
def test_qwen25_random_init_is_unchanged(seed):
    cfg = reduced(get_config("qwen25-7b"))
    meta = pack_meta([LoraConfig(rank=8, alpha=8.0), LoraConfig(rank=16, alpha=4.0)])
    base, lora = tm.init_model(seed, cfg, meta, device="cpu")
    assert (_digest(base), _digest(lora)) == QWEN_INIT_DIGESTS[seed]
    assert base["decoder"]["blocks"]["l0"]["norm1"].keys() == {"scale"}
