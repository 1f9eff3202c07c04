"""mamba2-370m in the port against the JAX package, on the CPU.

The family is attention-free: every layer is an SSD block (a chunked scan
that carries an (H, P, N) state across chunks, a depthwise causal conv and a
gated RMSNorm) with no FFN; its decode cache is fixed-size (the conv window
and the state, f32). LoRA targets "ssm_in" and "ssm_out" adapt ``zx`` and
``out``, so the packed and fused kernels run at the SSD's widths.

Reduced mamba2-370m (2 layers, d 256, d_inner 512, 16 heads of 32, d_state
16, chunks of 32); weights from the reference's ``init_model`` (LoRA + 0.02
N(0, 1) from a seed) through ``repro_torch.bridge``. Sequences of 80 tokens
span two and a half chunks. Tolerances, f32 at full f32 (no TF32): the scan,
its final state and the conv rtol/atol 1e-5; one SSD layer and its decode
steps 1e-5; whole-model logits 1e-4 of max |logit| in f32, 5e-2 in bf16; a
step's per-adapter loss 1e-2 in bf16, every f32 LoRA gradient 1e-3 of the
largest value of the compared array; decode against the full sequence in
the port 5e-3 (the reference's own bound, ``tests/test_ssm.py``).
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
from repro.models import model as jm
from repro.models.layers import ssm as jssm
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
from repro_torch.launch import train as launch_train
from repro_torch.models import model as tm
from repro_torch.models import transformer as ttr
from repro_torch.models.layers import ssm as tssm
from repro_torch.sched import cost_model as tcm
from repro_torch.sched.planner import plan
from repro_torch.serve import ServeEngine, ServeRequest
from repro_torch.serve.decode import pad_caches
from repro_torch.train.checkpoint import CheckpointPool
from repro_torch.train.data import packed_batch_iterator
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.trainer import make_packed_step, packed_value_and_grad
from repro_torch.tree import tree_leaves

ARCH = "mamba2-370m"
F32 = dict(rtol=1e-5, atol=1e-5)
LOGITS, LOGITS_BF16 = 1e-4, 5e-2
LOSS_BF16, GRAD = 1e-2, 1e-3
CONTINUE = 5e-3
NB, S = 4, 80
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


def _port(tree, dtype=None):
    return bridge.to_torch(_host(tree), "cpu", dtype)


def _bf16(tree):
    return jax.tree.map(lambda t: jnp.asarray(t, jnp.bfloat16), tree)


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


def _tokens(cfg, seed=4, s=S):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, size=(NB, s)).astype(np.int32)


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_config_matches_reference_field_for_field(reduce):
    """Every field the port's config has equals the reference's, the SSD's
    too (published: d_state 128, heads of 64, chunks of 256; ``reduced``:
    16, 32, 32); the layers are SSD mixers with no FFN; the base is the
    reference's 367.6 M parameters."""
    jc, tc = _cfgs(reduce=reduce)
    for f in dataclasses.fields(tc):
        if f.name == "attention":
            for af in dataclasses.fields(tc.attention):
                assert getattr(tc.attention, af.name) == getattr(jc.attention, af.name), af.name
        else:
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    for f in dataclasses.fields(tc.ssm):
        assert getattr(tc.ssm, f.name) == getattr(jc.ssm, f.name), f.name
    assert tc.layer_kinds() == jc.layer_kinds() == ("ssm",) * tc.n_layers
    assert tc.ffn_kinds() == jc.ffn_kinds() == ("none",) * tc.n_layers
    assert hash(tc) == hash(tc.replace())
    specs = ttr.layer_specs(tc)
    assert {(s.mixer, s.ffn, s.window) for s in specs} == {("ssm", "none", 0)}
    d = tc.d_model
    if reduce:
        assert (tc.ssm.d_state, tc.ssm.head_dim, tc.ssm.chunk_size, tc.n_layers) == (16, 32, 32, 2)
    else:
        assert (tc.ssm.d_inner(d), tc.ssm.n_heads(d)) == (2048, 32)
        assert tcm.model_param_count(tc) == jcm.model_param_count(jc) == 367_632_384


def _scan_inputs(s, seed=0, nb=2, h=3, p=4, n=5):
    """The reference test's shapes (``tests/test_ssm.py``), from a numpy seed."""
    rng = np.random.RandomState(seed)
    xs = rng.standard_normal((nb, s, h, p)).astype(np.float32)
    b = (0.5 * rng.standard_normal((nb, s, n))).astype(np.float32)
    c = (0.5 * rng.standard_normal((nb, s, n))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((nb, s, h)))).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 8.0, h)).astype(np.float32)
    state0 = (0.5 * rng.standard_normal((nb, h, p, n))).astype(np.float32)
    return (xs, b, c, dt, a_log), state0


@pytest.mark.parametrize("s,chunk", [(16, 4), (32, 8), (17, 8), (64, 64), (8, 16)])
def test_ssd_scan_matches_reference(s, chunk):
    """The chunked scan's output and final state against the reference's
    ``_ssd_scan`` from zeros and from a given ``state0``; the step
    recurrence (``ssd_reference``) against the reference's; and the state
    of a first half resumed over the second (``state0``) equals the whole
    scan."""
    args, state0 = _scan_inputs(s)
    targs = [torch.from_numpy(a) for a in args]
    for st in (None, state0):
        jy, js = jssm._ssd_scan(*map(jnp.asarray, args), chunk,
                                state0=None if st is None else jnp.asarray(st))
        ty, ts = tssm._ssd_scan(*targs, chunk, state0=None if st is None else torch.from_numpy(st))
        assert ty.shape == (2, s, 3, 4) and ts.shape == (2, 3, 4, 5) and ts.dtype == torch.float32
        np.testing.assert_allclose(_np(ty), _np(jy), **F32)
        np.testing.assert_allclose(_np(ts), _np(js), **F32)
    np.testing.assert_allclose(_np(tssm.ssd_reference(*targs)),
                               _np(jssm.ssd_reference(*map(jnp.asarray, args))), **F32)
    np.testing.assert_allclose(_np(tssm._ssd_scan(*targs, chunk)[0]),
                               _np(tssm.ssd_reference(*targs)), rtol=1e-4, atol=1e-4)
    half = chunk * max(1, s // (2 * chunk))
    if half < s:
        y1, s1 = tssm._ssd_scan(*[t[:, :half] for t in targs[:4]], targs[4], chunk)
        y2, s2 = tssm._ssd_scan(*[t[:, half:] for t in targs[:4]], targs[4], chunk, state0=s1)
        yf, sf = tssm._ssd_scan(*targs, chunk)
        np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(yf), **F32)
        np.testing.assert_allclose(_np(s2), _np(sf), **F32)


def test_causal_conv_matches_reference():
    """The depthwise causal conv (zero left padding, K = 4) against the
    reference's."""
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 10, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def _layer(world):
    """The first layer's SSD params and LoRA (the reference's), as (JAX,
    port) pairs, and the layer's input x (NB, S, d) from a seed."""
    jp = jax.tree.map(lambda t: t[0], world["base"]["decoder"]["blocks"]["l0"]["ssm"])
    jl = jax.tree.map(lambda t: t[0], world["lora"]["decoder"]["blocks"]["l0"]["ssm"])
    x = (0.5 * np.random.RandomState(3).standard_normal((NB, S, world["cfg"].d_model))).astype(
        np.float32)
    return (jp, jl), (_port(jp), _port(jl)), x


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_apply_ssm_and_decode_match_reference(world, impl):
    """One SSD layer over a pack of 2 (S = 80: two and a half chunks): the
    output and the decode cache (the conv window, the f32 state) of
    ``apply_ssm(return_state=True)``; then three ``apply_ssm_decode`` steps
    on the reference's cache, each output and the cache, which the port
    updates in place (the same tensors come back)."""
    jscfg, scfg = world["jcfg"].ssm, world["cfg"].ssm
    js, ts = world["jmeta"].scales(), world["meta"].scales("cpu")
    kc = KernelConfig(impl=impl)
    (jp, jl), (tp, tl), x = _layer(world)
    want, jc = jssm.apply_ssm(jp, jl, js, jnp.asarray(x), scfg=jscfg, n_pack=2, return_state=True)
    got, tc = tssm.apply_ssm(tp, tl, ts, torch.from_numpy(x), scfg=scfg, n_pack=2,
                             return_state=True, kcfg=kc)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert tc["state"].dtype == torch.float32
    for k in ("conv", "state"):
        assert tc[k].shape == jc[k].shape
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **F32)
    tc = _port(jc)
    held = {k: t.data_ptr() for k, t in tc.items()}
    step = (0.5 * np.random.RandomState(5).standard_normal((NB, 1, x.shape[-1]))).astype(np.float32)
    for i in range(3):
        want, jc = jssm.apply_ssm_decode(jp, jl, js, jnp.asarray(step + i), jc, scfg=jscfg,
                                         n_pack=2)
        got, out_c = tssm.apply_ssm_decode(tp, tl, ts, torch.from_numpy(step + i), tc, scfg=scfg,
                                           n_pack=2, kcfg=kc)
        assert out_c is tc and {k: t.data_ptr() for k, t in tc.items()} == held
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        for k in ("conv", "state"):
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **F32)


def test_decode_continues_the_full_sequence(world):
    """Port against port, the reference's check (``tests/test_ssm.py``):
    ``apply_ssm`` over 12 tokens equals its state after 8 (a prompt shorter
    than a chunk) plus 4 decode steps, within 5e-3, and so does its state
    after a 2-token prompt (shorter than the conv window) plus one step;
    so does the model's
    last-position logits through ``prefill`` and ``decode_step`` against
    the full forward (f32 caches in a bf16 tree: the cache's own dtype)."""
    scfg, ts = world["cfg"].ssm, world["meta"].scales("cpu")
    _, (tp, tl), x = _layer(world)
    xt = 0.2 * torch.from_numpy(x[:, :12])
    full, _ = tssm.apply_ssm(tp, tl, ts, xt, scfg=scfg, n_pack=2)
    _, cache = tssm.apply_ssm(tp, tl, ts, xt[:, :8], scfg=scfg, n_pack=2, return_state=True)
    outs = [tssm.apply_ssm_decode(tp, tl, ts, xt[:, t : t + 1], cache, scfg=scfg, n_pack=2)[0]
            for t in range(8, 12)]
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full[:, 8:]), rtol=CONTINUE,
                               atol=CONTINUE)
    # a prompt of 2 tokens, shorter than the conv window: zero rows ahead
    _, cache = tssm.apply_ssm(tp, tl, ts, xt[:, :2], scfg=scfg, n_pack=2, return_state=True)
    assert cache["conv"].shape[1] == scfg.d_conv - 1 and not cache["conv"][:, 0].any()
    out, _ = tssm.apply_ssm_decode(tp, tl, ts, xt[:, 2:3], cache, scfg=scfg, n_pack=2)
    np.testing.assert_allclose(_np(out), _np(full[:, 2:3]), rtol=CONTINUE, atol=CONTINUE)
    tc = world["cfg"]
    toks = torch.from_numpy(_tokens(tc, seed=9, s=40))
    sc = world["meta"].scales()
    h, _, _ = tm.forward(world["tbase"], world["tlora"], sc, {"tokens": toks}, tc, n_pack=2)
    want = tm.logits(world["tbase"], h, tc)
    _, caches = tm.prefill(world["tbase"], world["tlora"], sc, {"tokens": toks[:, :36]}, tc,
                           n_pack=2)
    caches = pad_caches(caches, 40)
    got = []
    for t in range(36, 40):
        lg, caches = tm.decode_step(world["tbase"], world["tlora"], sc, toks[:, t : t + 1], caches,
                                    torch.tensor(t), tc, n_pack=2)
        got.append(lg)
    _close(torch.cat(got, 1), want[:, 36:], CONTINUE)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_forward_logits_match_reference(world, impl, dtype):
    """The whole model at S = 80 (scans of two and a half chunks), under
    both impls, against the reference's default one: f32 within 1e-4 of
    max |logit|; a bf16 base and LoRA on both sides within 5e-2 (the port
    keeps the residual stream and the SSD's inner steps in f32, the
    reference rounds them to bf16)."""
    jc, tc = world["jcfg"], world["cfg"]
    toks = _tokens(jc)
    bf16 = dtype == "bf16"
    if ("forward", dtype) not in world:
        jb, jl = (_bf16(world["base"]), _bf16(world["lora"])) if bf16 else (world["base"],
                                                                            world["lora"])
        jh, _, _ = jm.forward(jb, jl, world["jmeta"].scales(), {"tokens": jnp.asarray(toks)}, jc,
                              n_pack=2)
        world["forward", dtype] = jm.logits(jb, jh, jc)
    tb, tl = ((_port(world["base"], torch.bfloat16), _port(world["lora"], torch.bfloat16))
              if bf16 else (world["tbase"], world["tlora"]))
    th, _, _ = tm.forward(tb, tl, world["meta"].scales(), {"tokens": torch.from_numpy(toks)}, tc,
                       n_pack=2, kcfg=KernelConfig(impl=impl))
    got = tm.logits(tb, th, tc)
    assert got.shape == (NB, S, tc.padded_vocab) and got.dtype == tb["embed"]["w"].dtype
    # the residual stream is f32 whatever the base's dtype (layers/ssm.py)
    assert tm._embed(tb, torch.from_numpy(toks), tc).dtype == torch.float32
    _close(got, world["forward", dtype], LOGITS_BF16 if bf16 else LOGITS)


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_packed_step_matches_reference(world, impl):
    """``make_packed_step``'s step 1 on the reference's batch stream: in f32
    every LoRA gradient (zx and out, a and b) of the function it runs,
    ``packed_value_and_grad``, within 1e-3 of the reference's, and its loss
    is that function's; on a bf16 base its per-adapter loss within 1e-2 of
    the reference's on the same bf16 base."""
    jc, tc, jmeta, meta = world["jcfg"], world["cfg"], world["jmeta"], world["meta"]
    if "step" not in world:
        jb = next(j_batches(jc, [JLoraConfig(**c) for c in PACK], seq=S))
        (_, jper), jgrads = jax.jit(jax.value_and_grad(
            lambda lo: j_packed_loss_fn(lo, world["base"], jb, jc, 2, jmeta.scales(),
                                        kcfg=jmeta.kernel_config()),
            has_aux=True))(world["lora"])
        _, jper16 = j_packed_loss_fn(world["lora"], _bf16(world["base"]), jb, jc, 2,
                                     jmeta.scales(), kcfg=jmeta.kernel_config())
        world["step"] = jper, jper16, jax.tree_util.tree_leaves(jgrads)
    jper, jper16, want = world["step"]
    tb = next(packed_batch_iterator(tc, [LoraConfig(**c) for c in PACK], seq=S, device="cpu"))
    kc = KernelConfig(impl=impl, ranks=meta.ranks)
    _, per, grads = packed_value_and_grad(world["tlora"], world["tbase"], tb, tc, 2,
                                          meta.scales("cpu"), kcfg=kc)
    _close(per, jper, 1e-4)
    got = jax.tree_util.tree_leaves(bridge.to_numpy(grads))
    assert len(got) == len(want) == 2 * 2  # (zx, out) x (a, b), the 2 layers stacked
    for g, w in zip(got, want):
        assert np.abs(_np(w)).max() > 0
        _close(g, w, GRAD)
    lora = world["tlora"]
    for base, ref in ((world["tbase"], per), (_port(world["base"], torch.bfloat16), jper16)):
        step = make_packed_step(tc, 2, impl=impl, ranks=meta.ranks)
        new, _, m = step(base, lora, init_opt_state(lora), tb, meta.scales("cpu"),
                         meta.lr_vector("cpu"), None)
        assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(new))
        if ref is per:
            assert torch.equal(m["per_adapter_loss"], per)
        else:
            _close(m["per_adapter_loss"], ref, LOSS_BF16)


def test_prefill_then_decode_steps_match_reference(world):
    """``prefill`` of 80 tokens (the last position's logits, the conv
    windows and states), then three ``decode_step``s on the reference's
    caches (``pad_caches`` passes the fixed-size ``"ssm"`` subtree
    through): logits and caches. Several tokens a row against a cache are a
    prefill chunk: a vector of per-row positions refuses them, and
    ``prefill_chunk`` at a scalar position takes them (chunks of 32, the
    SSD chunk, give the one-shot prefill's logits and caches)."""
    jc, tc = world["jcfg"], world["cfg"]
    toks = _tokens(jc, seed=6)
    jlg, jcaches = jm.prefill(world["base"], world["lora"], world["jmeta"].scales(),
                              {"tokens": jnp.asarray(toks)}, jc, n_pack=2)
    tlg, tcaches = tm.prefill(world["tbase"], world["tlora"], world["meta"].scales(),
                              {"tokens": torch.from_numpy(toks)}, tc, n_pack=2)
    _close(tlg, jlg, LOGITS)
    for a, b in zip(tree_leaves(tcaches), jax.tree_util.tree_leaves(_host(jcaches))):
        _close(a, b, LOGITS)
    prefilled = (tlg, tcaches)
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
    for a, b in zip(tree_leaves(tcaches), jax.tree_util.tree_leaves(_host(jcaches))):
        _close(a, b, LOGITS)
    with pytest.raises(ValueError, match="one token per row"):
        tm.decode_step(world["tbase"], world["tlora"], world["meta"].scales(),
                       torch.from_numpy(toks[:, :2]), tcaches, torch.from_numpy(pos), tc,
                       n_pack=2)
    caches = tm.init_caches(tc, NB, S, torch.float32, "cpu")
    for p0 in range(0, S, 32):
        tlg, caches = tm.prefill_chunk(world["tbase"], world["tlora"], world["meta"].scales(),
                                       torch.from_numpy(toks[:, p0:p0 + 32]), caches,
                                       torch.tensor(p0), tc, n_pack=2)
    _close(tlg, prefilled[0], LOGITS)
    for a, b in zip(tree_leaves(caches), tree_leaves(prefilled[1]), strict=True):
        _close(a, b, LOGITS)


def test_packed_adapter_equals_the_adapter_alone(world):
    """Port against port: the rows of adapter 1 in the pack of 2 give the
    logits that adapter alone gives (its slice of the pack tree, its own
    scale), within 1e-5 of max |logit|."""
    tc, meta = world["cfg"], world["meta"]
    toks = torch.from_numpy(_tokens(tc, seed=2, s=40))
    kw = dict(kcfg=KernelConfig(impl="auto"))
    h, _, _ = tm.forward(world["tbase"], world["tlora"], meta.scales(), {"tokens": toks}, tc,
                      n_pack=2, **kw)
    alone = jax.tree.map(lambda t: t[:, 1:2], world["lora"])  # the pack axis of the stacked leaves
    meta1 = pack_meta([LoraConfig(**PACK[1])])
    h1, _, _ = tm.forward(world["tbase"], _port(alone), meta1.scales(), {"tokens": toks[2:]}, tc,
                       n_pack=1, **kw)
    _close(tm.logits(world["tbase"], h1, tc), tm.logits(world["tbase"], h, tc)[2:], 1e-5)


def test_ssm_cache_leaves_stay_f32_in_a_bf16_tree(world):
    """``init_caches`` in its default bf16 gives f32 conv windows and
    states (the reference's), and a bf16 ``ServeEngine`` keeps them f32
    through admission (``write_row_caches``) and decode: the rows hold
    their prefill state, not zeros."""
    tc = world["cfg"]
    caches = tm.init_caches(tc, 3, 16, device="cpu")
    ssm = caches["blocks"]["l0"]["ssm"]
    assert ssm["conv"].dtype == ssm["state"].dtype == torch.float32
    assert ssm["conv"].shape == (2, 3, 3, 512 + 2 * 16) and ssm["state"].shape == (2, 3, 16, 32, 16)
    want = jm.init_caches(world["jcfg"], 3, 16)
    assert [(t.shape, str(t.dtype)) for t in jax.tree_util.tree_leaves(want)] == [
        (tuple(t.shape), str(t.dtype).split(".")[-1]) for t in tree_leaves(caches)]
    base = _port(world["base"], torch.bfloat16)
    eng = ServeEngine(tc, base, rows=2, smax=32, r_bucket=16, device="cpu")
    lora = jax.tree.map(lambda t: t[:, 0], world["lora"])
    eng.publish("ad", lora, {"rank": 16, "alpha": 16.0})
    rng = np.random.RandomState(3)
    stats = eng.serve([ServeRequest(i, "ad", rng.randint(0, tc.vocab_size, 10).astype(np.int32),
                                    max_new_tokens=4) for i in range(2)])
    assert all(r.error is None and len(r.tokens) == 4 for r in stats.results)
    for t in tree_leaves(eng._caches):
        assert t.dtype == torch.float32 and bool(t.abs().amax() > 0)


def test_pad_caches_passes_the_ssm_subtree_and_refuses_unknown_leaves(world):
    """``pad_caches`` passes the fixed-size ``"ssm"`` subtree through (the
    same tensors), as the reference does, and still raises on a tensor
    leaf it does not know rather than pass it unpadded."""
    toks = _tokens(world["cfg"], s=12)
    _, caches = tm.prefill(world["tbase"], world["tlora"], world["meta"].scales(),
                           {"tokens": torch.from_numpy(toks)}, world["cfg"], n_pack=2)
    got = pad_caches(caches, 30)
    assert all(a is b for a, b in zip(tree_leaves(got), tree_leaves(caches)))
    want = _host(j_pad(jax.tree.map(jnp.asarray, bridge.to_numpy(caches)), 30))
    assert jax.tree.map(lambda t: t.shape, bridge.to_numpy(got)) == jax.tree.map(
        lambda t: t.shape, want)
    bad = {"blocks": {"l0": {"ssm": caches["blocks"]["l0"]["ssm"],
                             "mix": {"window": torch.zeros(2, NB, 3, 8)}}}}
    with pytest.raises(ValueError, match="'window'"):
        pad_caches(bad, 30)


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_serve_engine_tokens_match_reference(world, impl):
    """``ServeEngine.serve`` emits the reference engine's greedy tokens
    (same adapters, prompts and arrivals; 5 requests over 2 rows, so rows
    retire and admit mid-run, each admission writing a fresh conv window
    and state into its row)."""
    jc, tc = world["jcfg"], world["cfg"]
    rank, alpha = 8, 16.0
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, jc.vocab_size, size=8).astype(np.int32) for _ in range(5)]
    kw = dict(rows=2, smax=32, r_bucket=rank)
    if "serve" not in world:
        meta = j_pack_meta([JLoraConfig(rank=rank, alpha=alpha)] * 3)
        _, lora = jm.init_model(jax.random.PRNGKey(1), jc, meta)
        lora = jax.tree.map(lambda x: x + 0.02, lora)
        world["adapters"] = {f"ad{i}": j_extract(lora, i) for i in range(3)}
        jeng = JServeEngine(jc, world["base"], serve_executor=JServeExecutor(), **kw)
        for aid, tree in world["adapters"].items():
            jeng.publish(aid, tree, {"rank": rank, "alpha": alpha})
        world["serve"] = jeng.serve([JServeRequest(i, f"ad{i % 3}", p, max_new_tokens=5,
                                                   arrival=float(i))
                                     for i, p in enumerate(prompts)])
    want = world["serve"]
    eng = ServeEngine(tc, world["tbase"], device="cpu", impl=impl, **kw)
    for aid, tree in world["adapters"].items():
        eng.publish(aid, tree, {"rank": rank, "alpha": alpha})
    got = eng.serve([ServeRequest(i, f"ad{i % 3}", p, max_new_tokens=5, arrival=float(i))
                     for i, p in enumerate(prompts)])
    assert [r.request_id for r in got.results] == [r.request_id for r in want.results]
    for a, b in zip(got.results, want.results):
        assert a.error is None and b.error is None
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert got.steps == want.steps and got.tokens_emitted == want.tokens_emitted


@pytest.mark.parametrize("base_dtype", [None, "int8", "nf4"], ids=["bf16", "int8", "nf4"])
def test_cost_model_counts_match_reference(base_dtype):
    """Full mamba2-370m: the parameter count (zx, bc, dt, out per layer and
    the tied vocabulary) and the LoRA count (ssm_in -> zx, ssm_out -> out)
    are the reference's; the quantized count is zx and out; with
    ``REFERENCE_MEMORY`` every price is the reference's. The port's own
    per-job term for an SSM decoder is the scan's working set."""
    jc, tc = _cfgs(reduce=False)
    assert tcm.model_param_count(tc) == jcm.model_param_count(jc)
    assert tcm.active_param_count(tc) == jcm.active_param_count(jc)
    for r in (8, 16, 32, 128):
        assert tcm.lora_param_count(tc, r) == jcm.lora_param_count(jc, r) == 48 * r * (
            (1024 + 4096) + (2048 + 1024))
    assert tcm.quantized_param_count(tc, "int8") == tcm.quantized_param_count(tc, "nf4") == 48 * (
        1024 * 4096 + 2048 * 1024)
    meta = pack_meta([LoraConfig(rank=16, alpha=16.0)])
    one = tc.replace(n_layers=1)
    assert sum(t.numel() for t in tree_leaves(tm.lora_zeros(one, meta, device="meta"))) == (
        tcm.lora_param_count(one, 16))
    jmod = jcm.CostModel(jc, jcm.A100_40G, base_dtype=base_dtype)
    tmod = tcm.CostModel(tc, tcm.A100_40G, base_dtype=base_dtype, **tcm.REFERENCE_MEMORY)
    assert tmod.base_weight_bytes() == jmod.base_weight_bytes()
    assert tmod.job_fixed_bytes(8, 1024) == 0.0
    # the port's own accounting: the scan's working set, not the attention
    # decoders' per-job constant (6 f32 (rows, 32, 256, 256) tensors a chunk)
    port = tcm.CostModel(tc, tcm.H100, base_dtype=base_dtype)
    assert port.job_fixed_bytes(3, 512) == 6 * 3 * 32 * 256 * 256 * 4 * 2
    assert tcm.CostModel(get_config("qwen25-7b"), tcm.H100).job_fixed_bytes(3, 512) == 1.0e9
    js, ts = j_space(300, seq_len=1024)[::37], default_search_space(300, seq_len=1024)[::37]
    for k in (1, 3, len(ts)):
        assert tmod.job_mem_bytes(ts[:k], 1, 1024) == jmod.job_mem_bytes(js[:k], 1, 1024)
        assert tmod.iter_time(ts[:k], 1, 1024) == jmod.iter_time(js[:k], 1, 1024)


def test_planner_matches_reference():
    """Full mamba2-370m under the reference's memory accounting on a 4 GB
    A100 preset (so packs split into several jobs): the port's plan ``==``
    the reference's, job for job."""
    jc, tc = _cfgs(reduce=False)
    hw = dict(mem_bytes=4e9)
    jcmod = jcm.CostModel(jc, jcm.A100_40G.scaled(**hw))
    tcmod = tcm.CostModel(tc, tcm.A100_40G.scaled(**hw), **tcm.REFERENCE_MEMORY)
    idx = range(3, 300, 23)
    js, ts = j_space(300, seq_len=1024), default_search_space(300, seq_len=1024)
    js, ts = [js[i] for i in idx], [ts[i] for i in idx]
    tp, jp = plan(tcmod, ts, 4, 1024, 50), j_plan(jcmod, js, 4, 1024, 50)
    assert len(tp.jobs) > 1
    assert [(tuple(j.config_ids), j.degree, j.start, j.end) for j in tp.jobs] == [
        (tuple(j.config_ids), j.degree, j.start, j.end) for j in jp.jobs]
    assert tp.makespan == jp.makespan


def test_launcher_trains_and_saves_adapters(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch mamba2-370m --reduced
    --device cpu``: finite losses, the adapters (zx and out under
    ``"ssm"``) in the pool."""
    per = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                             "--seq", "40", "--log-every", "0", "--pool", str(tmp_path)])
    assert per.shape == (2,) and np.isfinite(per).all()
    assert "arch=mamba2-370m-reduced" in capsys.readouterr().out
    pool = CheckpointPool(str(tmp_path))
    assert pool.list() == [f"{ARCH}-reduced_adapter_000", f"{ARCH}-reduced_adapter_001"]
    ad = pool.load_adapter(pool.list()[0])
    assert set(ad["decoder"]["blocks"]["l0"]) == {"ssm"}
    assert set(ad["decoder"]["blocks"]["l0"]["ssm"]) == {"zx", "out"}
    assert np.isfinite(pool.load_meta(pool.list()[1])["final_loss"])
