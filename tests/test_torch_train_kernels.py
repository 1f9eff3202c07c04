"""Gradients of the port's kernel ops and its quantized base, on the CPU.

The same numpy inputs go through the JAX function (the Pallas kernels in
interpret mode, as the JAX package's own tests run them) and through the
port's autograd Functions, whose backward on a CPU tensor runs the kernels'
plain versions. Tolerance f32 1e-5, relative to the largest value of each
compared array (only the order of f32 sums differs). Invariants inside the
port are exact: save and recompute give bit-identical gradients, padding
columns of a ragged pack get exactly zero gradient, and a quantized base
gives bit-identical outputs and gradients to its dequantized dense form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro.kernels.fused import fused_lora as j_fused_lora
from repro_torch import bridge
from repro_torch.kernels import ops, quant, ref

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def _arrays(seed, shapes, stds):
    rng = np.random.RandomState(seed)
    return [(rng.standard_normal(s) * sd).astype(np.float32) for s, sd in zip(shapes, stds)]


def _torch_grads(fn, *arrays):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    y = fn(*ts)
    return y.detach(), torch.autograd.grad(y, ts, grad_outputs=torch.ones_like(y))


def _jax_grads(fn, *arrays):
    y, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return y, vjp(jnp.ones_like(y))


# ---------------------------------------------------------------------------
# the two-pass delta and the fused primitive against the Pallas kernels
# ---------------------------------------------------------------------------


def _delta_inputs(seed, xdim):
    n, d, r, k = 2, 48, 16, 40
    xs = (n, 10, d) if xdim == 3 else (n, 2, 5, d)
    return _arrays(seed, [xs, (n, d, r), (n, r, k)], [1.0, d ** -0.5, 1.0])


@pytest.mark.parametrize("xdim", [3, 4])
@pytest.mark.parametrize("ranks", [None, (8, 16)])
def test_packed_lora_delta_grads_match_pallas(xdim, ranks):
    """Both branches of the backward: 3-D x runs the four grouped cases,
    N-D x runs cases 2 and 4 and einsums for dA, dB."""
    x, a, b = _delta_inputs(xdim + 10, xdim)
    alpha = np.array([2.0, 0.5], np.float32)
    y_j, g_j = _jax_grads(
        lambda x, a, b: jops.packed_lora_delta(x, a, b, jnp.asarray(alpha), impl="pallas",
                                               ranks=ranks), x, a, b)
    y_t, g_t = _torch_grads(
        lambda x, a, b: ops.packed_lora_delta(x, a, b, torch.from_numpy(alpha), impl="auto",
                                              ranks=ranks), x, a, b)
    _close(y_t, y_j)
    for got, want in zip(g_t, g_j):
        _close(got, want)


@pytest.mark.parametrize("wkind", ["dense", "int8", "nf4"])
@pytest.mark.parametrize("ranks", [None, (8, 16)])
def test_fused_grads_match_pallas(wkind, ranks):
    x, w, a, b = _arrays(3, [(2, 12, 64), (64, 40), (2, 64, 16), (2, 16, 40)],
                         [1.0, 0.125, 0.125, 1.0])
    alpha = np.array([2.0, 0.5], np.float32)
    wj = jnp.asarray(w) if wkind == "dense" else jquant.quantize_weight(w, wkind)
    wt = torch.from_numpy(w) if wkind == "dense" else bridge.to_torch(wj, "cpu")
    y_j, g_j = _jax_grads(
        lambda x, a, b: (jops.fused_lora_linear(x, wj, a, b, jnp.asarray(alpha),
                                                impl="fused_pallas", ranks=ranks)
                         if ranks else
                         j_fused_lora(x, wj, a, b, jnp.asarray(alpha), impl="fused_pallas")),
        x, a, b)
    y_t, g_t = _torch_grads(
        lambda x, a, b: ops.fused_lora_linear(x, wt, a, b, torch.from_numpy(alpha),
                                              impl="fused", ranks=ranks), x, a, b)
    _close(y_t, y_j)
    for got, want in zip(g_t, g_j):
        _close(got, want)


@pytest.mark.parametrize("op", ["delta", "fused"])
@pytest.mark.parametrize("xdim", [3, 4])
def test_remat_save_equals_recompute_bitwise(op, xdim):
    x, a, b = _delta_inputs(7, xdim)
    w = _arrays(8, [(48, 40)], [48 ** -0.5])[0]
    alpha = torch.tensor([2.0, 0.5])
    grads = {}
    for impl in (("auto", "plain") if op == "delta" else ("fused", "fused_plain")):
        for remat in ("save", "recompute"):
            if op == "delta":
                fn = lambda x, a, b: ops.packed_lora_delta(  # noqa: E731
                    x, a, b, alpha, impl=impl, remat=remat, ranks=(8, 16))
            else:
                fn = lambda x, a, b: ops.fused_lora_linear(  # noqa: E731
                    x, torch.from_numpy(w), a, b, alpha, impl=impl, remat=remat, ranks=(8, 16))
            grads[impl, remat] = _torch_grads(fn, x, a, b)[1]
        for s, r in zip(grads[impl, "save"], grads[impl, "recompute"]):
            assert torch.equal(s, r)


@pytest.mark.parametrize("op", ["delta", "fused"])
def test_ragged_padding_gradients_are_exactly_zero(op):
    """Ranks (8, 16) in a bucket of 16: adapter 0's padding columns of A and
    rows of B are sliced off before any kernel, so their gradient is 0."""
    x, a, b = _delta_inputs(9, 3)
    w = torch.from_numpy(_arrays(10, [(48, 40)], [48 ** -0.5])[0])
    alpha = torch.tensor([2.0, 0.5])
    if op == "delta":
        fn = lambda x, a, b: ops.packed_lora_delta(x, a, b, alpha, ranks=(8, 16))  # noqa: E731
    else:
        fn = lambda x, a, b: ops.fused_lora_linear(  # noqa: E731
            x, w, a, b, alpha, impl="fused", ranks=(8, 16))
    _, (_, da, db) = _torch_grads(fn, x, a, b)
    assert (da[0, :, 8:] == 0).all() and (db[0, 8:, :] == 0).all()
    assert (da[0, :, :8] != 0).any() and (db[1] != 0).any()


@pytest.mark.parametrize("xdim", [3, 4])
def test_explicit_backward_equals_autograd_of_plain_forward(xdim):
    """The Functions' own backward (plain versions on the CPU) against
    autograd through the plain forward, for the delta and the fused op."""
    x, a, b = _delta_inputs(11, xdim)
    w = torch.from_numpy(_arrays(12, [(48, 40)], [48 ** -0.5])[0])
    alpha = torch.tensor([2.0, 0.5])

    def flat(x):
        return x.reshape(x.shape[0], -1, x.shape[-1])

    pairs = [
        (lambda x, a, b: ops.packed_lora_delta(x, a, b, alpha, impl="plain"),
         lambda x, a, b: ref.packed_lora_delta_ref(x, a, b, alpha)),
        (lambda x, a, b: ops.fused_lora_linear(x, w, a, b, alpha, impl="fused_plain"),
         lambda x, a, b: ref.fused_matmul_ref(flat(x), w, a, b, alpha).reshape(
             *x.shape[:-1], w.shape[1])),
    ]
    for fn, plain in pairs:
        y1, g1 = _torch_grads(fn, x, a, b)
        y2, g2 = _torch_grads(plain, x, a, b)
        _close(y1, y2.numpy())
        for got, want in zip(g1, g2):
            _close(got, want.numpy())


def test_backward_cases_plain_version_matches_autograd():
    """``packed_lora_delta_bwd_ref`` (the four cases spelled out) is the
    gradient of the plain delta."""
    x, a, b = _delta_inputs(13, 3)
    alpha = torch.tensor([2.0, 0.5])
    ct = torch.from_numpy(_arrays(14, [(2, 10, 40)], [1.0])[0])
    ts = [torch.from_numpy(v.copy()).requires_grad_(True) for v in (x, a, b)]
    want = torch.autograd.grad(ref.packed_lora_delta_ref(*ts, alpha), ts, grad_outputs=ct)
    got = ref.packed_lora_delta_bwd_ref(*[t.detach() for t in ts], alpha, ct)
    for g, w in zip(got, want):
        _close(g, w.numpy())


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


def _quant_weights():
    rng = np.random.RandomState(0)
    w = (rng.standard_normal((2, 128, 24)) * 0.1).astype(np.float32)
    w[0, :, 0] = 0.0  # an all-zero column: scale 1, codes 0
    w[0, :, 1] = np.arange(128, dtype=np.float32) - 63.5  # int8 ties: scale 1, codes x.5
    w[0, 0, 1] = 127.0
    w[1, :64, 2] = 0.0  # an all-zero nf4 block
    cb = jquant.NF4_CODEBOOK
    w[1, :, 3] = np.tile(np.concatenate([cb, (cb[:-1] + cb[1:]) / 2]), 5)[:128]  # codebook, midpoints
    return w


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_quantize_and_dequantize_bit_exact_vs_reference(mode):
    w = _quant_weights()
    want = jquant.quantize_weight(w, mode)
    got = quant.quantize_weight(torch.from_numpy(w), mode)
    for key in ("codes", "scales"):
        assert got[key].dtype == bridge.to_torch(want[key], "cpu").dtype
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_array_equal(quant.dequantize(got).numpy(),
                                  np.asarray(jquant.dequantize(want)))
    assert quant.logical_shape(got) == jquant.logical_shape(want)
    assert quant.quantized_nbytes(got) == jquant.quantized_nbytes(want)


def test_dequantize_keeps_one_codebook_per_device(monkeypatch):
    """``dequantize`` gives the values it gave when it copied the nf4
    codebook on every call (code * scale from ``NF4_CODEBOOK`` itself), and
    its codebook is made once per device: the same tensor on the next call,
    so on the card no call after the first copies from the host."""
    monkeypatch.setattr(quant, "_CODEBOOKS", {})
    q = quant.quantize_weight(torch.from_numpy(_quant_weights()), "nf4")
    codes, scales = q["codes"], q["scales"]
    idx = torch.stack([codes & 0xF, codes >> 4], dim=-2).reshape(2, 128, 24)
    vals = quant.NF4_CODEBOOK[idx.long()].reshape(2, scales.shape[-2], -1, 24)
    want = (vals * scales[..., :, None, :]).reshape(2, 128, 24)
    first = quant.dequantize(q)
    cb = quant.nf4_codebook("cpu")
    assert torch.equal(first, want) and torch.equal(quant.dequantize(q), want)
    assert torch.equal(quant.dequantize(q, torch.bfloat16), want.to(torch.bfloat16))
    assert quant.nf4_codebook(torch.device("cpu")) is cb and list(quant._CODEBOOKS) == [torch.device("cpu")]
    meta = quant.nf4_codebook("meta")
    assert meta is quant.nf4_codebook(torch.device("meta")) and meta.device.type == "meta"
    assert len(quant._CODEBOOKS) == 2


def test_quantize_base_params_matches_reference():
    tree = {"embed": {"w": np.ones((8, 4), np.float32)},
            "blocks": {"q": {"w": _quant_weights(), "b": np.zeros((2, 24), np.float32)},
                       "norm": {"scale": np.ones((2, 24), np.float32)}}}
    want = jquant.quantize_base_params(tree, "nf4")
    got = quant.quantize_base_params(bridge.to_torch(tree, "cpu"), "nf4")
    assert quant.is_quantized(got["blocks"]["q"]["w"]) and not quant.is_quantized(got["embed"])
    for g, w in zip(jax.tree_util.tree_leaves(bridge.to_numpy(got)), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    back = quant.dequantize_base_params(got)
    np.testing.assert_array_equal(back["blocks"]["q"]["w"].numpy(),
                                  jquant.dequantize_base_params(want)["blocks"]["q"]["w"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl", ["fused", "fused_plain"])
@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_quantized_equals_dequantized_fwd_bwd_bitwise(mode, impl, dtype):
    """As the reference's ``test_quant.py:139-176``: the quantized base and
    its dequantized dense form give bit-identical y, dx, dA and dB."""
    x, w, a, b = _arrays(15, [(2, 9, 64), (64, 40), (2, 64, 8), (2, 8, 40)], [1.0, 0.125, 0.125, 1.0])
    q = quant.quantize_weight(torch.from_numpy(w), mode)
    wd = quant.dequantize(q, dtype)
    alpha = torch.tensor([2.0, 0.5])
    outs = []
    for wv in (q, wd):
        ts = [torch.from_numpy(v).to(dtype).requires_grad_(True) for v in (x, a, b)]
        y = ops.fused_lora_linear(ts[0], wv, ts[1], ts[2], alpha, impl=impl)
        outs.append((y,) + torch.autograd.grad((y.float() ** 2).sum(), ts))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# ragged packs: the permutation made once, and no permutation for sorted ranks
# ---------------------------------------------------------------------------

RAGGED_RANKS = [(32, 8, 16, 8), (8, 16, 16, 32)]  # unsorted; sorted (chip_smoke.py's pack)


def _gather_scatter_call(fn, x, a, b, alpha, ranks):
    """The ragged segmentation as ``ops._ragged_call`` first wrote it: a
    gather by a fresh index tensor on every call, whether the ranks are
    sorted or not, and a scatter back. The reference the cached, slicing
    version must equal bit for bit."""
    order, inv, segments = ops.rank_segments(ranks)
    o = torch.tensor(order, device=x.device)
    xs, a_s, b_s, al_s = x[o], a[o], b[o], alpha[o]
    outs = [
        fn(xs[lo:hi].contiguous(), a_s[lo:hi, :, :r].contiguous(),
           b_s[lo:hi, :r, :].contiguous(), al_s[lo:hi].contiguous())
        for lo, hi, r in segments
    ]
    return torch.cat(outs, dim=0)[torch.tensor(inv, device=x.device)]


def _ragged_inputs(seed, ranks):
    """x (N, 2, 5, 48), A and B in a bucket of 32 with zero padding past each
    adapter's rank, W (48, 40), alpha (N,)."""
    n, d, k, rb = len(ranks), 48, 40, 32
    x, a, b, w = _arrays(seed, [(n, 2, 5, d), (n, d, rb), (n, rb, k), (d, k)],
                         [1.0, d ** -0.5, 1.0, d ** -0.5])
    mask = (np.arange(rb)[None, :] < np.array(ranks)[:, None]).astype(np.float32)
    return x, a * mask[:, None, :], b * mask[:, :, None], w, np.linspace(0.5, 2.0, n).astype(np.float32)


def _ragged_op(op, ranks, w, alpha, impl=None):
    al, wt = torch.from_numpy(alpha), torch.from_numpy(w)
    if op == "delta":
        return lambda x, a, b: ops.packed_lora_delta(x, a, b, al, impl=impl or "auto", ranks=ranks)
    return lambda x, a, b: ops.fused_lora_linear(x, wt, a, b, al, impl=impl or "fused", ranks=ranks)


@pytest.mark.parametrize("ranks", RAGGED_RANKS)
@pytest.mark.parametrize("op", ["delta", "fused"])
def test_ragged_call_equals_gather_scatter_bitwise(op, ranks, monkeypatch):
    """The cached permutation (unsorted ranks) and the plain slices (sorted
    ranks) give outputs and gradients ``torch.equal`` to the gather/scatter
    formulation, and the padding still gets exactly zero gradient."""
    x, a, b, w, alpha = _ragged_inputs(21, ranks)
    fn = _ragged_op(op, ranks, w, alpha)
    y, grads = _torch_grads(fn, x, a, b)
    with monkeypatch.context() as mp:
        mp.setattr(ops, "_ragged_call", _gather_scatter_call)
        y_old, grads_old = _torch_grads(fn, x, a, b)
    assert torch.equal(y, y_old)
    for got, want in zip(grads, grads_old):
        assert torch.equal(got, want)
    da, db = grads[1], grads[2]
    for i, r in enumerate(ranks):
        assert (da[i, :, r:] == 0).all() and (db[i, r:, :] == 0).all()


@pytest.mark.parametrize("ranks", RAGGED_RANKS)
@pytest.mark.parametrize("op", ["delta", "fused"])
def test_ragged_ranks_match_pallas(op, ranks):
    """Sorted and unsorted rank tuples against the JAX package's ragged ops
    (Pallas in interpret mode) on the same numpy inputs: outputs and the
    gradients of x, A and B within 1e-5 of the largest value."""
    x, a, b, w, alpha = _ragged_inputs(22, ranks)
    ja = jnp.asarray(alpha)
    if op == "delta":
        jfn = lambda x, a, b: jops.packed_lora_delta(  # noqa: E731
            x, a, b, ja, impl="pallas", ranks=ranks)
    else:
        jfn = lambda x, a, b: jops.fused_lora_linear(  # noqa: E731
            x, jnp.asarray(w), a, b, ja, impl="fused_pallas", ranks=ranks)
    y_j, g_j = _jax_grads(jfn, x, a, b)
    y_t, g_t = _torch_grads(_ragged_op(op, ranks, w, alpha), x, a, b)
    _close(y_t, y_j)
    for got, want in zip(g_t, g_j):
        _close(got, want)


def test_ragged_index_is_made_once_per_ranks_and_device():
    """The permutation's index tensors are built on the first call for a
    (ranks, device) and are the same tensors on the next; sorted ranks are
    known to need none."""
    o1, i1 = ops.ragged_index((32, 8, 16, 8), "cpu")
    o2, i2 = ops.ragged_index([32, 8, 16, 8], torch.device("cpu"))
    assert o1 is o2 and i1 is i2
    order, inv, _ = ops.rank_segments((32, 8, 16, 8))
    assert o1.tolist() == list(order) and i1.tolist() == list(inv)
    assert ops._ragged_plan((8, 16, 16, 32))[3] and not ops._ragged_plan((32, 8, 16, 8))[3]


def test_make_train_step_makes_no_host_tensor_per_step(monkeypatch):
    """``make_train_step`` builds its scales, learning rates and step budgets
    (and the ragged pack's index tensors) on the first step and reuses them:
    steps 2 and 3 construct no ``torch.tensor`` at all, which on the card
    would each be a blocking host-to-device copy."""
    from repro_torch.configs import LoraConfig, get_config, reduced
    from repro_torch.core.adapter import pack_meta
    from repro_torch.models.model import init_model
    from repro_torch.train.data import packed_batch_iterator
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import make_train_step

    cfg = reduced(get_config("qwen25-7b"))
    configs = [LoraConfig(rank=r, alpha=2.0 * r, learning_rate=1e-3, batch_size=1)
               for r in (32, 8, 16, 8)]
    meta = pack_meta(configs)
    base, lora = init_model(0, cfg, meta, device="cpu")
    it = packed_batch_iterator(cfg, configs, seq=16, device="cpu")
    batches = [next(it) for _ in range(3)]
    step = make_train_step(cfg, meta, step_budgets=(3, 3, 2, 3))
    opt = init_opt_state(lora)
    made = []
    real = torch.tensor

    def counting(*args, **kwargs):
        made.append(kwargs.get("device"))
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "tensor", counting)
    per_step = []
    for batch in batches:
        n0 = len(made)
        lora, opt, m = step(base, lora, opt, batch)
        per_step.append(len(made) - n0)
    assert per_step[0] > 0 and per_step[1:] == [0, 0], per_step
    assert torch.isfinite(m["per_adapter_loss"]).all()
