"""whisper-tiny, the encoder-decoder, in the port against the JAX package,
on the CPU.

A non-causal encoder (GQA with rope, a gated-GELU MLP, LayerNorm) runs over
precomputed frame embeddings (the front end's stub) and ``enc_norm``; every
decoder layer adds a pre-norm cross-attention sublayer over its output,
whose K and V are plain biased products of it and whose q carries an
adapter. The cross "v" adapter that the reference builds is read by no
loss (its K/V never pass an adapter): its gradient is exactly 0.

Reduced whisper-tiny (the reference's rule: 2 encoder layers over 32
frames, 2 decoder layers, d 256, 4 heads of 32, d_ff 384, vocab 512).
Weights are the port's ``init_model`` draws (LoRA + 0.02 N(0, 1) from a
seed on each adapter's own rank) carried to the reference through
``repro_torch.bridge``, which runs its plain path at the bucket rank; the frames
are the reference's own stub (``repro.train.data``). Attention runs in
query chunks of 12, so the encoder's 32 frames make ragged non-causal
chunks (12, 12, 8). Each reference function is compiled once and shared.
Tolerances, f32: the encoder's output and the logits 1e-4 of max |value|
(bf16: 5e-2); step 1's loss 1e-5 and every f32 LoRA gradient 1e-4 of the
largest value of the compared array; prefill and decode against the
reference's full forward 1e-4.
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
from repro.models.layers.attention import flash_attention as j_flash
from repro.sched import cost_model as jcm
from repro.train.data import packed_batch_iterator as j_batches
from repro.train.optimizer import adamw_update as j_adamw
from repro.train.optimizer import init_opt_state as j_init_opt
from repro.train.trainer import packed_loss_fn as j_packed_loss_fn
from repro_torch import bridge
from repro_torch.configs import LoraConfig, get_config, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.core.packed_lora import extract_adapter, inject_adapter
from repro_torch.kernels.ops import KernelConfig
from repro_torch.kernels.quant import quantize_base_params
from repro_torch.launch import train as launch_train
from repro_torch.models import model as tm
from repro_torch.models import transformer as ttr
from repro_torch.models.layers.attention import flash_attention
from repro_torch.sched import cost_model as tcm
from repro_torch.serve import ServeEngine, ServeRequest
from repro_torch.serve.decode import generate, pad_caches
from repro_torch.train.checkpoint import CheckpointPool
from repro_torch.train.data import packed_batch_iterator
from repro_torch.train.optimizer import adamw_update, init_opt_state
from repro_torch.train.trainer import packed_value_and_grad, unread_lora
from repro_torch.tree import tree_leaves, tree_map

ARCH = "whisper-tiny"
LOGITS, LOGITS_BF16 = 1e-4, 5e-2
LOSS, GRAD = 1e-5, 1e-4
NB, S, CHUNK = 4, 24, 12
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
    return jax.tree.map(lambda t: jnp.asarray(t, jnp.bfloat16), tree)


def _noisy(lora, meta, seed=7):
    """The LoRA tree + 0.02 N(0, 1) on each adapter's own rank (its
    bucket padding stays 0), so B and the gradients of A are non-zero and
    the reference's bucket-rank plain path computes the port's ragged
    ranks' function."""
    rng, mask = np.random.RandomState(seed), meta.rank_mask("cpu")

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        m = mask[:, None, :] if key == "a" else mask[:, :, None]
        return t + torch.from_numpy(0.02 * rng.standard_normal(t.shape).astype(np.float32)) * m

    return walk(lora)


@pytest.fixture(scope="module")
def world():
    """The reduced model on both sides, its weights the port's draws, and
    the reference's first batch (its tokens, labels and frames)."""
    jc, tc = j_reduced(j_get_config(ARCH)), reduced(get_config(ARCH))
    meta = pack_meta([LoraConfig(**c) for c in PACK])
    base, lora = tm.init_model(0, tc, meta, device="cpu")
    lora = _noisy(lora, meta)
    jb = next(j_batches(jc, [JLoraConfig(**c) for c in PACK], seq=S))
    return dict(jcfg=jc, cfg=tc, jmeta=j_pack_meta([JLoraConfig(**c) for c in PACK]), meta=meta,
                base=bridge.to_numpy(base), lora=bridge.to_numpy(lora), tbase=base, tlora=lora,
                jbatch=jb, batch={k: torch.from_numpy(np.array(v)) for k, v in jb.items()})


def _ref_forward(world, bf16):
    """The reference's (encoder output, logits) on the world's weights and
    batch; one compile per dtype, shared."""
    key = ("forward", bf16)
    if key not in world:
        jc = world["jcfg"]

        encode, enc = jm._encode, []

        def ref(b, lo, sc, batch):
            h, _, _ = jm.forward(b, lo, sc, batch, jc, n_pack=2, chunk_q=CHUNK)
            return jnp.asarray(enc[0], jnp.float32), jnp.asarray(jm.logits(b, h, jc), jnp.float32)

        jb, jl = ((_bf16(world["base"]), _bf16(world["lora"])) if bf16
                  else (world["base"], world["lora"]))
        batch = {k: world["jbatch"][k] for k in ("tokens", "frames")}
        # the encoder's output, as ``forward`` computes it inside the one trace
        jm._encode = lambda *a, **kw: enc.append(encode(*a, **kw)) or enc[-1]
        try:
            world[key] = tuple(np.asarray(t) for t in jax.jit(ref)(
                jb, jl, world["jmeta"].scales(), batch))
        finally:
            jm._encode = encode
    return world[key]


# ---------------------------------------------------------------------------
# the config, the trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_config_matches_reference_field_for_field(reduce):
    """Every field of the port's whisper-tiny equals the reference's (the
    encoder's layers and frames, ``max_seq_len``, the attention block's
    fields), and so do the decoder's layer specs, each with its
    cross-attention sublayer; ``reduced`` keeps 2 encoder layers over 32
    frames."""
    from repro.models import transformer as jtr

    jc, tc = j_get_config(ARCH), get_config(ARCH)
    if reduce:
        jc, tc = j_reduced(jc), reduced(tc)
    for f in dataclasses.fields(tc):
        if f.name in ("attention", "ssm", "moe"):
            for sub in dataclasses.fields(getattr(tc, f.name)):
                assert getattr(getattr(tc, f.name), sub.name) == getattr(
                    getattr(jc, f.name), sub.name), (f.name, sub.name)
        else:
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.is_encdec and tc.family == "audio"
    assert [(s.mixer, s.ffn, s.window, s.theta, s.cross) for s in ttr.layer_specs(tc)] == [
        (s.mixer, s.ffn, s.window, s.theta, s.cross) for s in jtr.layer_specs(jc)]
    assert [(s.mixer, s.ffn, s.window, s.theta, s.cross) for s in tm.encoder_specs(tc)] == [
        (s.mixer, s.ffn, s.window, s.theta, s.cross) for s in jm.encoder_specs(jc)]
    if reduce:
        assert (tc.encoder_layers, tc.encoder_seq_len, tc.max_seq_len) == (2, 32, 512)
    else:
        assert (tc.encoder_layers, tc.encoder_seq_len, tc.max_seq_len) == (4, 1500, 448)
        assert "arXiv:2212.04356" in tc.citation


def test_init_model_trees_match_reference_layout():
    """The port's ``init_model`` base tree is the reference's, leaf for
    leaf (keys, shapes, dtypes: ``encoder``, ``enc_norm``, each decoder
    layer's ``cross`` and ``norm_cross``), at reduced size in bf16;
    ``lora_zeros`` and ``init_lora`` give its LoRA tree (the encoder's
    q/v/gate/up/down, the decoder's and its cross q/v). At full size
    ``lora_zeros`` holds the cross q/v at 384 -> 384 in each of the 4
    decoder layers."""
    jc, tc = j_reduced(j_get_config(ARCH)), reduced(get_config(ARCH))
    jmeta = j_pack_meta([JLoraConfig(**c) for c in PACK])
    meta = pack_meta([LoraConfig(**c) for c in PACK])
    jb, jl = jax.eval_shape(lambda: jm.init_model(jax.random.PRNGKey(0), jc, jmeta, jnp.bfloat16))
    tb, tl = tm.init_model(0, tc, meta, dtype=torch.bfloat16, device="cpu")
    got = bridge.to_numpy(tb)
    assert [(k, s, str(t.dtype)) for (k, s), t in zip(_keys_shapes(jb), jax.tree_util.tree_leaves(
        jb))] == [(k, s, str(t.dtype)) for (k, s), t in zip(_keys_shapes(got),
                                                             jax.tree_util.tree_leaves(got))]
    assert set(tb) == {"embed", "final_norm", "decoder", "encoder", "enc_norm", "lm_head"}
    assert set(tb["decoder"]["blocks"]["l0"]) == {"norm1", "attn", "cross", "norm_cross", "mlp",
                                                  "norm2"}
    want = _keys_shapes(jl)
    for tree in (tl, tm.init_lora(0, tc, meta, device="cpu"),
                 tm.lora_zeros(tc, meta, device="cpu")):
        assert _keys_shapes(bridge.to_numpy(tree)) == want
    zeros = tm.lora_zeros(get_config(ARCH), meta, device="meta")
    dec = zeros["decoder"]["blocks"]["l0"]
    assert set(dec) == {"attn", "cross", "mlp"} and set(dec["cross"]) == {"q", "v"}
    assert dec["cross"]["q"]["a"].shape == (4, 2, 384, 16)
    assert dec["cross"]["v"]["b"].shape == (4, 2, 16, 384)
    assert set(zeros["encoder"]["blocks"]["l0"]) == {"attn", "mlp"}


def test_init_lora_equals_init_model_lora_and_quant_init_equals_quantizer():
    """``init_lora`` gives ``init_model``'s LoRA tree bit for bit (the
    encoder's adapters are drawn before the LM head); ``init_model(...,
    quant="int8")`` is ``quantize_base_params`` of the dense tree bit for
    bit: the encoder's projections quantized, the cross-attention dense."""
    tc = reduced(get_config(ARCH))
    meta = pack_meta([LoraConfig(**c) for c in PACK])
    dense, lora = tm.init_model(3, tc, meta, device="cpu")
    again = tm.init_lora(3, tc, meta, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(lora)))
    q, _ = tm.init_model(3, tc, meta, device="cpu", quant="int8")
    want = quantize_base_params(dense, "int8")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(q), tree_leaves(want)))
    assert set(q["encoder"]["blocks"]["l0"]["attn"]["q"]["w"]) == {"codes", "scales"}
    assert isinstance(q["decoder"]["blocks"]["l0"]["cross"]["k"]["w"], torch.Tensor)


def test_bridge_carries_the_new_subtrees_bit_for_bit(world):
    """``encoder.blocks``, ``enc_norm`` and the decoder's ``cross`` /
    ``norm_cross`` cross to numpy (bf16 as ml_dtypes) and back bit for
    bit."""
    tb = bridge.to_torch(world["base"], "cpu", torch.bfloat16)
    back = bridge.to_torch(bridge.to_numpy(tb), "cpu")
    for sub in ("encoder", "enc_norm", "decoder"):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tb[sub]),
                                                     tree_leaves(back[sub])))
    assert back["decoder"]["blocks"]["l0"]["norm_cross"]["bias"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the reduced model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq", [100, 1500, 33])
def test_flash_attention_non_causal_ragged_chunks(sq):
    """(The non-causal half of ``tests/test_attention.py::
    test_flash_q_padding_non_divisible``.) Query lengths that are no
    multiple of ``chunk_q`` (32), whisper's 1,500 frames among them: the
    non-causal attention equals a naive softmax over every key within 1e-4,
    and the reference's ``flash_attention`` (below 1,500)."""
    rng = np.random.RandomState(42)
    q, k, v = (rng.standard_normal((1, sq, 2, 8)).astype(np.float32) for _ in range(3))
    got = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), causal=False, chunk_q=32)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(8)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    if sq < 1500:  # the reference's scan over 47 chunks costs a second
        ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False, chunk_q=32)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_forward_matches_reference(world, dtype, impl):
    """The encoder alone (its stack over the reference's frames and
    ``enc_norm``) and the whole model's logits against the reference's,
    within 1e-4 of max |value| in f32 and 5e-2 on a bf16 base and LoRA."""
    tc = world["cfg"]
    bf16 = dtype == "bf16"
    want_enc, want = _ref_forward(world, bf16)
    tb, tl = ((bridge.to_torch(world["base"], "cpu", torch.bfloat16),
               bridge.to_torch(world["lora"], "cpu", torch.bfloat16)) if bf16
              else (world["tbase"], world["tlora"]))
    kc = KernelConfig(impl=impl)
    scales = world["meta"].scales("cpu")
    enc = tm._encode(tb, tl, scales, world["batch"]["frames"], tc, n_pack=2, chunk_q=CHUNK,
                     kcfg=kc)
    assert enc.shape == (NB, 32, tc.d_model) and enc.dtype == tb["embed"]["w"].dtype
    h, caches, _ = tm.forward(tb, tl, scales, world["batch"], tc, n_pack=2, chunk_q=CHUNK,
                              kcfg=kc)
    assert caches is None and h.shape == (NB, S, tc.d_model)
    tol = LOGITS_BF16 if bf16 else LOGITS
    _close(enc, want_enc, tol)
    _close(tm.logits(tb, h, tc), want, tol)


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_packed_step_matches_reference(world, impl):
    """Step 1 of the packed loss on the reference's batch (the port's data
    stream gives its tokens and labels; the frames are the reference's
    stub): each adapter's CE within 1e-5 of the reference's, every f32
    LoRA gradient (encoder and decoder q/v/gate/up/down, the cross q)
    within 1e-4 of the largest value of the reference's; the cross "v"
    gradient exactly 0 on both sides, and the AdamW update of it the
    reference's: none."""
    jc, tc, jmeta, meta = world["jcfg"], world["cfg"], world["jmeta"], world["meta"]
    if "step" not in world:
        (jtot, jper), jgrads = jax.jit(jax.value_and_grad(
            lambda lo: j_packed_loss_fn(lo, world["base"], world["jbatch"], jc, 2,
                                        jmeta.scales()),
            has_aux=True))(world["lora"])
        world["step"] = float(jtot), jper, jgrads
    jtot, jper, jgrads = world["step"]
    tb = next(packed_batch_iterator(tc, [LoraConfig(**c) for c in PACK], seq=S, device="cpu"))
    assert torch.equal(tb["tokens"], world["batch"]["tokens"])
    assert torch.equal(tb["labels"], world["batch"]["labels"])
    tb["frames"] = world["batch"]["frames"]
    tot, per, grads = packed_value_and_grad(world["tlora"], world["tbase"], tb, tc, 2,
                                            meta.scales("cpu"),
                                            kcfg=KernelConfig(impl=impl, ranks=meta.ranks))
    np.testing.assert_allclose(tot.item(), jtot, rtol=LOSS)
    _close(per, jper, LOSS)
    got, want = bridge.to_numpy(grads), jax.tree.map(np.asarray, jgrads)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(want)]
    assert [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(got)] == paths
    dead = [p for p in paths if "'cross'" in p and "'v'" in p]
    # a and b of the encoder layer's 5 projections and the decoder layer's 7
    assert len(dead) == 2 and len(paths) == (5 + 7) * 2
    for p, g, ref in zip(paths, jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        if p in dead:
            assert not np.any(g) and not np.any(ref), p
        else:
            assert np.abs(ref).max() > 0, p
            _close(g, ref, GRAD)
    # the AdamW step on the dead leaves (their own path in the tree: the
    # learning rate's broadcast reads "blocks")
    def dead_of(tree):
        return {"decoder": {"blocks": {"l0": {"cross": {"v": tree["decoder"]["blocks"]["l0"][
            "cross"]["v"]}}}}}

    new, _ = adamw_update(dead_of(grads), init_opt_state(dead_of(world["tlora"]), n_pack=2),
                          dead_of(world["tlora"]), meta.lr_vector("cpu"))
    jnew, _ = j_adamw(dead_of(jgrads), j_init_opt(dead_of(world["lora"]), n_pack=2),
                      dead_of(world["lora"]), jmeta.lr_vector())
    for a, b, w0 in zip(tree_leaves(bridge.to_numpy(new)), jax.tree_util.tree_leaves(jnew),
                        tree_leaves(dead_of(world["lora"]))):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(a, w0)


def test_unread_lora_names_only_the_cross_k_v_adapters():
    """The trainer's zero-gradient rule names the cross group's k/v leaves
    and no other: a leaf elsewhere without a gradient still raises."""
    assert unread_lora(("decoder", "blocks", "cross", "v", "a"))
    assert unread_lora(("decoder", "rest", "l0", "cross", "k", "b"))
    assert not unread_lora(("decoder", "blocks", "cross", "q", "a"))
    assert not unread_lora(("decoder", "blocks", "attn", "v", "a"))
    assert not unread_lora(("encoder", "blocks", "attn", "v", "b"))


def test_prefill_then_decode_match_the_reference_forward(world):
    """(The port of ``tests/test_serve.py::
    test_prefill_then_decode_matches_full_forward`` for whisper.) Prefill
    20 tokens with the frames, then decode the next 3 reading the cached
    cross K/V (no frames), in f32: the last prefill logits and each decode
    step's equal the reference's full forward within 1e-4 of max |logit|.
    ``pad_caches`` grows the self-attention k/v and leaves ``"cross_kv"``
    as it is; ``generate`` takes the frames as ``batch_extra``."""
    tc, meta = world["cfg"], world["meta"]
    want = _ref_forward(world, False)[1]
    toks, frames = world["batch"]["tokens"], world["batch"]["frames"]
    s0 = S - 4
    lg, caches = tm.prefill(world["tbase"], world["tlora"], meta.scales(),
                            {"tokens": toks[:, :s0], "frames": frames}, tc, n_pack=2,
                            chunk_q=CHUNK)
    _close(lg[:, 0], want[:, s0 - 1], LOGITS)
    cross = caches["blocks"]["l0"]["cross_kv"]
    assert cross["k"].shape == (2, NB, 32, 4, 32)
    caches = pad_caches(caches, S)
    assert caches["blocks"]["l0"]["attn"]["k"].shape[2] == S
    assert caches["blocks"]["l0"]["cross_kv"] is cross
    for i in range(3):
        lg, caches = tm.decode_step(world["tbase"], world["tlora"], meta.scales(),
                                    toks[:, s0 + i:s0 + i + 1], caches, torch.tensor(s0 + i), tc,
                                    n_pack=2)
        _close(lg[:, 0], want[:, s0 + i], LOGITS)
    out = generate(world["tbase"], world["tlora"], tc, meta, toks[:, :s0], 4, device="cpu",
                   batch_extra={"frames": frames})
    assert out.shape == (NB, 4) and int(out[0, 0]) == int(np.argmax(want[0, s0 - 1, :512]))


def test_pad_caches_leaves_cross_kv_and_init_caches_holds_it(world):
    """``init_caches`` gives each decoder layer a ``"cross_kv"`` of (NB,
    S_enc, KV, D) beside its k/v; ``pad_caches`` grows the k/v to the
    target and passes the ``"cross_kv"`` subtree through unchanged, even
    when the target is below the 32 frames."""
    tc = world["cfg"]
    c = tm.init_caches(tc, 3, 16, device="cpu")
    assert set(c["blocks"]["l0"]) == {"attn", "cross_kv"}
    assert c["blocks"]["l0"]["cross_kv"]["k"].shape == (2, 3, 32, 4, 32)
    padded = pad_caches(c, 20)
    assert padded["blocks"]["l0"]["attn"]["v"].shape == (2, 3, 20, 4, 32)
    assert padded["blocks"]["l0"]["cross_kv"] is c["blocks"]["l0"]["cross_kv"]


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_cost_model_counts_match_reference(reduce):
    """The parameter counts are the reference's (61,065,984 at full size:
    the encoder and the cross q/k/v/o counted, the norms and biases not).
    The LoRA count is the size of the reference's own ``init_model`` LoRA
    tree (1,032,192 at r = 16); the reference bills 933,888, leaving out
    exactly the decoder's cross q/v adapters (98,304, the dead "v" ones
    among them). With ``REFERENCE_MEMORY`` the base's price is the
    reference's."""
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    if reduce:
        jc, tc = j_reduced(jc), reduced(tc)
    assert tcm.model_param_count(tc) == jcm.model_param_count(jc)
    assert tcm.active_param_count(tc) == jcm.active_param_count(jc)
    _, jl = jax.eval_shape(lambda: jm.init_model(
        jax.random.PRNGKey(0), jc, j_pack_meta([JLoraConfig(rank=16, alpha=16.0)])))
    held = sum(int(np.prod(t.shape)) for t in jax.tree_util.tree_leaves(jl))
    assert tcm.lora_param_count(tc, 16) == held
    one = pack_meta([LoraConfig(rank=16, alpha=16.0)])
    assert sum(t.numel() for t in tree_leaves(tm.lora_zeros(tc, one, device="meta"))) == held
    d, a = tc.d_model, tc.attention
    cross = tc.n_layers * 16 * 2 * (d + a.n_heads * a.head_dim)
    assert held - jcm.lora_param_count(jc, 16) == cross
    if not reduce:
        assert tcm.model_param_count(tc) == 61_065_984
        assert (held, jcm.lora_param_count(jc, 16), cross) == (1_032_192, 933_888, 98_304)
    jmod = jcm.CostModel(jc, jcm.A100_40G)
    tmod = tcm.CostModel(tc, tcm.A100_40G, **tcm.REFERENCE_MEMORY)
    assert tmod.base_weight_bytes() == jmod.base_weight_bytes()


def test_per_job_term_is_the_encoder_attention_working_set():
    """The port's per-job memory term for an encoder-decoder: the
    attention's working set over the encoder's frames in one layer's
    backward (``enc_attn_copies`` f32 (rows, heads, query chunk, S_enc)
    tensors), in place of the attention decoders' 1 GB; a query chunk is
    at most 512 frames; ``REFERENCE_MEMORY`` drops it."""
    tc = get_config(ARCH)
    cm = tcm.CostModel(tc, tcm.H100)
    assert cm.job_fixed_bytes(3, 448) == 4.0 * 3 * 6 * 512 * 1500 * 4
    small = reduced(tc)
    assert tcm.CostModel(small, tcm.H100).job_fixed_bytes(2, 64) == 4.0 * 2 * 4 * 32 * 32 * 4
    ref = tcm.CostModel(tc, tcm.A100_40G, **tcm.REFERENCE_MEMORY)
    assert ref.job_fixed_bytes(3, 448) == 0.0
    assert tcm.CostModel(get_config("qwen25-7b"), tcm.H100).job_fixed_bytes(3, 448) == 1.0e9


# ---------------------------------------------------------------------------
# the port's own invariants
# ---------------------------------------------------------------------------


def test_packed_adapter_equals_the_adapter_alone(world):
    """Port against port: adapter 1's CE and LoRA gradients in the pack of
    2 equal its own run alone within 1e-5, the encoder's included."""
    tc, meta = world["cfg"], world["meta"]
    batch = dict(world["batch"])
    _, per, grads = packed_value_and_grad(world["tlora"], world["tbase"], batch, tc, 2,
                                          meta.scales("cpu"), kcfg=KernelConfig(ranks=meta.ranks))
    alone = tree_map(lambda t: t[:, 1:2], world["tlora"])  # the pack axis of the stacked leaves
    meta1 = pack_meta([LoraConfig(**PACK[1])])
    one = {k: v[2:] for k, v in batch.items()}
    _, per1, grads1 = packed_value_and_grad(alone, world["tbase"], one, tc, 1, meta1.scales("cpu"))
    _close(per1, per[1:], 1e-5)
    for g, g1 in zip(tree_leaves(grads), tree_leaves(grads1)):
        _close(g1, g[:, 1:2], 1e-5)


def test_extract_inject_roundtrip_on_the_encoder(world):
    """extract -> inject -> extract of each adapter of the pack is bit-exact
    on the encoder's subtree and the decoder's cross group, unpadded to its
    rank."""
    tc, meta = world["cfg"], world["meta"]
    tmpl = tree_map(lambda t: t.numpy(), tm.lora_zeros(tc, meta, device="cpu"))
    for i in range(meta.n):
        ad = extract_adapter(world["tlora"], i, meta.ranks)
        assert set(ad["encoder"]["blocks"]["l0"]) == {"attn", "mlp"}
        assert ad["encoder"]["blocks"]["l0"]["attn"]["q"]["a"].shape[-1] == meta.ranks[i]
        packed = inject_adapter(tmpl, ad, i)
        assert _keys_shapes(packed) == _keys_shapes(tmpl)
        again = extract_adapter(packed, i, meta.ranks)
        for sub in ("encoder", "decoder"):
            assert all(np.array_equal(a, b) for a, b in zip(tree_leaves(again[sub]),
                                                            tree_leaves(ad[sub])))


def test_continuous_batching_equals_sequential_with_frames(world):
    """``ServeEngine.serve`` (2 rows, 5 requests, each with its own frames
    as ``extra``) emits ``serve_sequential``'s greedy tokens: each
    admission writes its row's cross K/V."""
    tc = world["cfg"]
    rng = np.random.RandomState(1)
    reqs = [ServeRequest(i, f"ad{i % 2}", rng.randint(0, tc.vocab_size, size=6 + i)
                         .astype(np.int32), max_new_tokens=4, arrival=float(i),
                         extra={"frames": 0.1 * rng.standard_normal((1, 32, tc.d_model))
                                .astype(np.float32)})
            for i in range(5)]
    eng = ServeEngine(tc, world["tbase"], rows=2, smax=16, r_bucket=16, device="cpu")
    for i in range(2):
        eng.publish(f"ad{i}", extract_adapter(world["tlora"], i, world["meta"].ranks),
                    {"rank": PACK[i]["rank"], "alpha": PACK[i]["alpha"]})
    got, seq = eng.serve(reqs), eng.serve_sequential(reqs)
    assert [r.error for r in got.results] == [None] * 5
    for a, b in zip(got.results, seq.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert [r.n_prompt for r in got.results] == [6 + i for i in range(5)]


def test_launcher_trains_and_saves_adapters(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch whisper-tiny --reduced
    --device cpu``: finite losses; each adapter in the pool holds the
    encoder's adapters and the decoder's cross q/v."""
    per = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                             "--seq", "16", "--log-every", "0", "--pool", str(tmp_path)])
    assert per.shape == (2,) and np.isfinite(per).all()
    assert f"arch={ARCH}-reduced" in capsys.readouterr().out
    pool = CheckpointPool(str(tmp_path))
    ad = pool.load_adapter(pool.list()[0])
    assert set(ad) == {"decoder", "encoder"}
    assert set(ad["decoder"]["blocks"]["l0"]["cross"]) == {"q", "v"}
