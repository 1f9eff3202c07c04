"""The port's training slice against the JAX package's, on the CPU.

Same numpy inputs and bridged weights on both sides, f32. Tolerances:
losses and single ops 1e-5 (only the order of f32 sums differs); a whole
step 1e-4 on per-adapter losses and on every LoRA gradient, relative to the
largest value of the compared array (two frameworks' f32 matmuls and
softmaxes through 2 layers); four-step loss trajectories rtol 5e-3, as the
reference's own packing test (Adam's m/sqrt(v) amplifies ~1e-7 gradient
noise on near-zero gradients). Invariants inside the port: packed equals
single adapter (rtol 5e-3, as the reference), and a quantized base equals its
dequantized dense form bit for bit.
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
from repro.kernels.quant import quantize_base_params as j_quantize_base_params
from repro.models.model import init_model as j_init_model
from repro.train import losses as jlosses
from repro.train.data import eval_batch as j_eval_batch
from repro.train.data import packed_batch_iterator as j_batches
from repro.train.optimizer import adamw_update as j_adamw
from repro.train.optimizer import init_opt_state as j_init_opt
from repro.train.trainer import make_packed_step as j_make_packed_step
from repro.train.trainer import packed_loss_fn as j_packed_loss_fn
from repro_torch import bridge
from repro_torch.configs import LoraConfig, get_config, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.core.packed_lora import extract_adapter, inject_adapter
from repro_torch.kernels.ops import KernelConfig
from repro_torch.kernels.quant import dequantize_base_params, quantize_base_params
from repro_torch.launch import train as launch_train
from repro_torch.models.model import init_model
from repro_torch.train import losses
from repro_torch.train.data import eval_batch, packed_batch_iterator
from repro_torch.train.optimizer import adamw_update, init_opt_state
from repro_torch.train.trainer import make_packed_step, make_train_step, packed_value_and_grad
from repro_torch.tree import tree_leaves, tree_map

SEQ = 24
# the heterogeneous pack of tests/conftest.py's meta2
PACK = [dict(rank=8, alpha=8.0, learning_rate=1e-3, batch_size=2),
        dict(rank=16, alpha=4.0, learning_rate=5e-4, batch_size=2)]


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def _cfgs(kv):
    jc, tc = j_reduced(j_get_config("qwen25-7b")), reduced(get_config("qwen25-7b"))
    if kv:
        jc = jc.replace(attention=dataclasses.replace(jc.attention, n_kv_heads=kv))
        tc = tc.replace(attention=dataclasses.replace(tc.attention, n_kv_heads=kv))
    return jc, tc


@pytest.fixture(scope="module")
def model():
    """The JAX reference model (f32) of the pack, with B += 0.02 so every
    delta and dA is non-zero, and its trees bridged to the port."""
    jcfg, _ = _cfgs(None)
    meta = j_pack_meta([JLoraConfig(**c) for c in PACK])
    base, lora = j_init_model(jax.random.PRNGKey(0), jcfg, meta)
    lora = jax.tree.map(lambda x: x + 0.02, lora)
    return base, lora, meta


def _port(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk", [(16, 64), (64, 16), (65, 16), (17, 8)])
def test_chunked_ce_and_grad_match_reference(s, chunk):
    rng = np.random.RandomState(s)
    nb, d, vpad, vocab = 4, 16, 64, 50
    hidden = rng.standard_normal((nb, s, d)).astype(np.float32)
    unembed = (rng.standard_normal((d, vpad)) * 0.1).astype(np.float32)
    labels = rng.randint(0, vocab, (nb, s)).astype(np.int32)
    labels[:, -2:] = jlosses.IGNORE

    def jfn(h):
        return jlosses.chunked_cross_entropy(h, unembed, labels, 2, chunk=chunk, vocab=vocab)

    (jper, jtot), jvjp = jax.vjp(jfn, jnp.asarray(hidden))
    (jgrad,) = jvjp((jnp.zeros(2), jnp.ones(())))
    h = torch.from_numpy(hidden).requires_grad_(True)
    per, tot = losses.chunked_cross_entropy(h, torch.from_numpy(unembed), torch.from_numpy(labels),
                                            2, chunk=chunk, vocab=vocab)
    tot.backward()
    _close(per, jper, 1e-5)
    _close(tot, jtot, 1e-5)
    _close(h.grad, jgrad, 1e-5)


def test_top1_accuracy_matches_reference():
    rng = np.random.RandomState(0)
    lg = rng.standard_normal((4, 6, 10)).astype(np.float32)
    labels = rng.randint(0, 10, (4, 6)).astype(np.int32)
    labels[0, :3] = jlosses.IGNORE
    got = losses.top1_accuracy(torch.from_numpy(lg), torch.from_numpy(labels), 2)
    _close(got, jlosses.top1_accuracy(jnp.asarray(lg), jnp.asarray(labels), 2), 1e-6)


@pytest.mark.parametrize("per_adapter_steps", [False, True])
def test_adamw_update_matches_reference(per_adapter_steps):
    """Per-adapter learning rates, the pack axis 1 under "blocks", a step
    vector with budgets (adapter 1 frozen after its step 2), weight decay."""
    rng = np.random.RandomState(1)
    params = {"blocks": {"a": rng.standard_normal((3, 2, 5, 4)).astype(np.float32)},
              "rest": {"b": rng.standard_normal((2, 4, 6)).astype(np.float32)}}
    lr = np.array([1e-2, 3e-3], np.float32)
    budgets = np.array([5, 2], np.int32) if per_adapter_steps else None
    n = 2 if per_adapter_steps else 0
    jp, jo = params, j_init_opt(params, n)
    tp, to = bridge.to_torch(params, "cpu"), init_opt_state(bridge.to_torch(params, "cpu"), n)
    for it in range(3):
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        jp, jo = j_adamw(grads, jo, jp, jnp.asarray(lr), weight_decay=0.01,
                         step_budget=None if budgets is None else jnp.asarray(budgets))
        tp, to = adamw_update(bridge.to_torch(grads, "cpu"), to, tp, torch.from_numpy(lr),
                              weight_decay=0.01,
                              step_budget=None if budgets is None else torch.from_numpy(budgets))
        for g, w in zip(tree_leaves(tp) + tree_leaves(to["m"]) + tree_leaves(to["v"]),
                        jax.tree_util.tree_leaves((jp, jo["m"], jo["v"]))):
            _close(g, w, 1e-5)
        np.testing.assert_array_equal(to["step"].numpy(), np.asarray(jo["step"]))


@pytest.mark.parametrize("start_steps", [None, (2, 0)])
def test_packed_batch_iterator_and_eval_batch_equal_reference(start_steps):
    jcfg, tcfg = _cfgs(None)
    configs = [dict(PACK[0], batch_size=1), PACK[1]]
    jit = j_batches(jcfg, [JLoraConfig(**c) for c in configs], seq=SEQ, start_steps=start_steps)
    tit = packed_batch_iterator(tcfg, [LoraConfig(**c) for c in configs], seq=SEQ,
                                start_steps=start_steps, device="cpu")
    for _ in range(2):
        jb, tb = next(jit), next(tit)
        for k in ("tokens", "labels"):
            assert tb[k].device.type == "cpu"
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    jb, tb = j_eval_batch(jcfg, 2, seq=SEQ), eval_batch(tcfg, 2, seq=SEQ, device="cpu")
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "fused"])
@pytest.mark.parametrize("kv", [None, 2])
def test_packed_step_loss_and_grads_match_reference(model, kv, impl):
    """One step's per-adapter loss and every LoRA gradient, on reduced
    qwen25-7b and its n_kv_heads=2 (grouped-query) variant, against the
    JAX step with its default impl; the port runs its kernel route (the
    plain versions on the CPU)."""
    base, lora, meta = model
    jcfg, tcfg = _cfgs(kv)
    if kv:  # the GQA variant has narrower k/v projections: its own weights
        base, lora = j_init_model(jax.random.PRNGKey(0), jcfg, meta)
        lora = jax.tree.map(lambda x: x + 0.02, lora)
    jb = next(j_batches(jcfg, [JLoraConfig(**c) for c in PACK], seq=SEQ))
    (_, jper), jgrads = jax.jit(jax.value_and_grad(
        lambda lo: j_packed_loss_fn(lo, base, jb, jcfg, 2, meta.scales(), kcfg=meta.kernel_config()),
        has_aux=True))(lora)
    tb = next(packed_batch_iterator(tcfg, [LoraConfig(**c) for c in PACK], seq=SEQ, device="cpu"))
    tmeta = pack_meta([LoraConfig(**c) for c in PACK])
    _, per, grads = packed_value_and_grad(
        _port(lora), _port(base), tb, tcfg, 2, tmeta.scales("cpu"),
        kcfg=KernelConfig(impl=impl, ranks=tmeta.ranks))
    _close(per, jper, 1e-4)
    for got, want in zip(tree_leaves(grads), jax.tree_util.tree_leaves(jgrads)):
        _close(got, want, 1e-4)


def test_four_step_trajectory_matches_reference(model):
    base, lora, meta = model
    jcfg, tcfg = _cfgs(None)
    jstep = j_make_packed_step(jcfg, 2, ranks=meta.ranks)
    jit = j_batches(jcfg, [JLoraConfig(**c) for c in PACK], seq=SEQ)
    tmeta = pack_meta([LoraConfig(**c) for c in PACK])
    tstep = make_packed_step(tcfg, 2, ranks=tmeta.ranks)
    tit = packed_batch_iterator(tcfg, [LoraConfig(**c) for c in PACK], seq=SEQ, device="cpu")
    tbase, tlora = _port(base), _port(lora)
    jlora, jopt, topt = lora, j_init_opt(lora), init_opt_state(tlora)
    jh, th = [], []
    for _ in range(4):
        jlora, jopt, jm = jstep(base, jlora, jopt, next(jit), meta.scales(), meta.lr_vector(), None)
        tlora, topt, tm = tstep(tbase, tlora, topt, next(tit), tmeta.scales("cpu"),
                                tmeta.lr_vector("cpu"), None)
        jh.append(np.asarray(jm["per_adapter_loss"]))
        th.append(tm["per_adapter_loss"].numpy())
    np.testing.assert_allclose(np.stack(th), np.stack(jh), rtol=5e-3, atol=1e-3)


def _train(cfg, configs, base, lora, steps=4):
    step = make_train_step(cfg, pack_meta(configs))
    it = packed_batch_iterator(cfg, configs, seq=SEQ, device="cpu")
    opt, hist = init_opt_state(lora), []
    for _ in range(steps):
        lora, opt, m = step(base, lora, opt, next(it))
        hist.append(m["per_adapter_loss"].numpy())
    return np.stack(hist)


def test_packed_equals_single_adapter():
    """The paper's packing identity inside the port: each adapter of a pack
    trains as it does alone, from the same weights (its slot of the pack,
    moved into a pack of one) on the same data stream."""
    _, tcfg = _cfgs(None)
    configs = [LoraConfig(**c) for c in PACK]
    meta = pack_meta(configs)
    base, lora = init_model(0, tcfg, meta, device="cpu")
    lora = tree_map(lambda t: t + 0.02, lora)  # non-zero B (the ragged pack never reads padding)
    h_packed = _train(tcfg, configs, base, lora)
    for i, c in enumerate(configs):
        _, tmpl = init_model(0, tcfg, pack_meta([c]), device="cpu")
        single = bridge.to_torch(
            inject_adapter(tmpl, extract_adapter(lora, i, meta.ranks), 0), "cpu")
        h = _train(tcfg, [c], base, single)
        np.testing.assert_allclose(h_packed[:, i], h[:, 0], rtol=5e-3, atol=1e-3)
        np.testing.assert_allclose(h_packed[0, i], h[0, 0], rtol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_quantized_step_equals_dequantized_base_step(mode):
    """As the reference's ``test_quant.py:179``: a fused step on a quantized
    base gives the same losses and adapter updates, bit for bit, as the same
    step on the dequantized dense base."""
    _, tcfg = _cfgs(None)
    configs = [LoraConfig(rank=4, alpha=8.0, learning_rate=1e-3, batch_size=1)] * 2
    meta = pack_meta(configs)
    base, lora = init_model(0, tcfg, meta, device="cpu")
    qbase = quantize_base_params(base, mode)
    batch = next(packed_batch_iterator(tcfg, configs, seq=8, device="cpu"))
    outs = []
    for bp, bd in ((qbase, mode), (dequantize_base_params(qbase), None)):
        step = make_train_step(tcfg, meta, impl="fused", base_dtype=bd)
        lora2, _, m = step(bp, tree_map(torch.clone, lora), init_opt_state(lora), batch)
        outs.append((m["per_adapter_loss"], tree_leaves(lora2)))
    assert torch.equal(outs[0][0], outs[1][0])
    for q, d in zip(outs[0][1], outs[1][1]):
        assert torch.equal(q, d)


# ---------------------------------------------------------------------------
# the launcher and the bridge
# ---------------------------------------------------------------------------


def test_launcher_runs_on_cpu_and_needs_a_device_otherwise(monkeypatch, capsys):
    per = launch_train.main(["--reduced", "--device", "cpu", "--steps", "2", "--seq", "16"])
    assert per.shape == (2,) and np.isfinite(per).all()
    assert "done: 2 steps" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1"])
    with pytest.raises(SystemExit):
        launch_train.main(["--reduced", "--device", "cpu", "--hosts", "2"])


def test_launcher_fused_impl_equals_auto_on_the_f32_base(capsys):
    """The launcher's f32 base through the fused op (its plain version on
    the CPU) gives auto's per-adapter losses within 1e-5 relative: one f32
    function in two orders of sums. A step callback sees every step."""
    args = ["--reduced", "--device", "cpu", "--steps", "2", "--seq", "16", "--log-every", "0"]
    seen = []
    fused = launch_train.main(args + ["--impl", "fused"],
                              step_callback=lambda i, m: seen.append(i))
    auto = launch_train.main(args + ["--impl", "auto"])
    assert seen == [0, 1]
    assert np.isfinite(fused).all() and fused.shape == auto.shape == (2,)
    np.testing.assert_allclose(fused, auto, rtol=1e-5, atol=0)
    assert capsys.readouterr().out.count("done: 2 steps") == 2


@pytest.mark.parametrize("quant", ["none", "nf4"])
def test_launcher_prices_the_tree_it_trains(monkeypatch, quant):
    """The launcher's ``CostModel`` carries its tree's storage ("f32" for
    ``init_model``'s default, the scheme of a quantized base), while the
    kernel policy it hands ``train_pack`` stays the quantization scheme
    (None for a dense base)."""
    from repro_torch.cluster import SliceExecutor

    priced, policy = [], []
    real = launch_train.CostModel

    def recording(*args, **kw):
        priced.append(real(*args, **kw))
        return priced[-1]

    class Recording(SliceExecutor):
        def train_pack(self, *args, **kw):
            policy.append(kw["base_dtype"])
            return super().train_pack(*args, **kw)

    monkeypatch.setattr(launch_train, "CostModel", recording)
    launch_train.main(["--reduced", "--device", "cpu", "--steps", "1", "--seq", "16",
                       "--log-every", "0", "--quant", quant], executor=Recording(capture=False))
    (cm,) = priced
    assert cm.base_dtype == ("f32" if quant == "none" else quant)
    assert policy == [None if quant == "none" else quant]
    assert cm.base_bytes_per_param() == (4.0 if quant == "none" else 0.5 + 4.0 / 64.0)


def test_bridge_round_trips_opt_state_and_quantized_base(model):
    base, lora, meta = model
    opt = jax.tree.map(np.asarray, j_init_opt(lora, meta.n))
    opt["m"] = jax.tree.map(lambda x: x + 0.5, opt["m"])
    qbase = jax.tree.map(np.asarray, j_quantize_base_params(base, "nf4"))
    qbase["decoder"]["blocks"]["l0"]["mlp"]["up"]["w"] = jax.tree.map(
        np.asarray, j_quantize_base_params({"up": {"w": base["decoder"]["blocks"]["l0"]["mlp"]
                                                   ["up"]["w"]}}, "int8"))["up"]["w"]
    for tree in (opt, qbase):
        back = bridge.to_numpy(bridge.to_torch(tree, "cpu", torch.float32))
        la, lb = jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(back)
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
