"""internvl2-1b, the patch-prefix VLM, in the port against the JAX package,
on the CPU.

The LM is a biased GQA decoder (Qwen2-0.5B: 14 q heads, 2 k/v heads, rope
theta 1e6); before the text a batch carries precomputed patch embeddings
(the vision encoder's stub), each put through a biased ``patch_proj``. The
patches take the first P positions of the sequence: a training row of S
positions holds S - P tokens, and position P + t is labelled with token
t + 1; a served request's positions start after its P patches.

Reduced internvl2-1b (the reference's rule: 2 layers, d 256, 4 q heads
and 2 k/v heads of 32, d_ff 384, vocab 512, 8 patches). Weights are the
port's ``init_model`` draws (LoRA + 0.02 N(0, 1) from a seed on each
adapter's own rank) carried to the reference through ``repro_torch.bridge``,
which runs its plain path at the bucket rank; the patches are the
reference's own stub (``repro.train.data``). Each reference function is
compiled once and shared. Tolerances, f32: the prefix's embeddings and the
logits 1e-4 of max |value| (bf16: 5e-2); step 1's loss 1e-5 and every f32
LoRA gradient 1e-4 of the largest value of the compared array; prefill and
decode against the reference's full forward 1e-4.
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
from repro.sched import cost_model as jcm
from repro.sched.planner import plan as j_plan
from repro.train.data import eval_batch as j_eval_batch
from repro.train.data import packed_batch_iterator as j_batches
from repro.train.trainer import packed_loss_fn as j_packed_loss_fn
from repro_torch import bridge
from repro_torch.configs import LoraConfig, default_search_space, get_config, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.core.packed_lora import extract_adapter
from repro_torch.kernels.ops import KernelConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import model as tm
from repro_torch.sched import cost_model as tcm
from repro_torch.sched.planner import plan
from repro_torch.serve import ServeEngine, ServeRequest
from repro_torch.serve.decode import pad_caches
from repro_torch.train.checkpoint import CheckpointPool
from repro_torch.train.data import eval_batch, packed_batch_iterator
from repro_torch.train.trainer import packed_value_and_grad
from repro_torch.tree import tree_leaves, tree_map

ARCH = "internvl2-1b"
LOGITS, LOGITS_BF16 = 1e-4, 5e-2
LOSS, GRAD = 1e-5, 1e-4
NB, S, P = 4, 24, 8  # rows, positions a row, patches
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
    the reference's first batch (its tokens, labels and patches)."""
    jc, tc = j_reduced(j_get_config(ARCH)), reduced(get_config(ARCH))
    meta = pack_meta([LoraConfig(**c) for c in PACK])
    base, lora = tm.init_model(0, tc, meta, device="cpu")
    lora = _noisy(lora, meta)
    jb = next(j_batches(jc, [JLoraConfig(**c) for c in PACK], seq=S))
    return dict(jcfg=jc, cfg=tc, jmeta=j_pack_meta([JLoraConfig(**c) for c in PACK]), meta=meta,
                base=bridge.to_numpy(base), lora=bridge.to_numpy(lora), tbase=base, tlora=lora,
                jbatch=jb, batch={k: torch.from_numpy(np.array(v)) for k, v in jb.items()})


def _ref_forward(world, bf16):
    """The reference's (embedded stream, logits) on the world's weights
    and batch; one compile per dtype, shared."""
    key = ("forward", bf16)
    if key not in world:
        jc = world["jcfg"]

        def ref(b, lo, sc, batch):
            x = jm._embed(b, batch["tokens"], jc, batch)
            h, _, _ = jm.forward(b, lo, sc, batch, jc, n_pack=2)
            return jnp.asarray(x, jnp.float32), jnp.asarray(jm.logits(b, h, jc), jnp.float32)

        jb, jl = ((_bf16(world["base"]), _bf16(world["lora"])) if bf16
                  else (world["base"], world["lora"]))
        batch = {k: world["jbatch"][k] for k in ("tokens", "patches")}
        world[key] = tuple(np.asarray(t) for t in jax.jit(ref)(jb, jl, world["jmeta"].scales(),
                                                              batch))
    return world[key]


# ---------------------------------------------------------------------------
# the config, the trees, the data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_config_matches_reference_field_for_field(reduce):
    """Every field of the port's internvl2-1b equals the reference's (the
    patch count, the biased GQA at theta 1e6); ``reduced`` keeps 8
    patches."""
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
    assert tc.family == "vlm" and not tc.is_encdec
    assert tc.n_patch_tokens == (8 if reduce else 256)
    if not reduce:
        assert "arXiv:2404.16821" in tc.citation and tc.attention.rope_theta == 1e6


def test_init_model_trees_match_reference_layout():
    """The port's ``init_model`` base tree is the reference's, leaf for
    leaf (keys, shapes, dtypes: ``patch_proj`` with its bias), at reduced
    size in bf16; ``init_lora`` and ``lora_zeros`` give its LoRA tree;
    ``init_lora`` is ``init_model``'s bit for bit (``patch_proj`` is drawn
    after every A)."""
    jc, tc = j_reduced(j_get_config(ARCH)), reduced(get_config(ARCH))
    jmeta = j_pack_meta([JLoraConfig(**c) for c in PACK])
    meta = pack_meta([LoraConfig(**c) for c in PACK])
    jb, jl = jax.eval_shape(lambda: jm.init_model(jax.random.PRNGKey(0), jc, jmeta, jnp.bfloat16))
    tb, tl = tm.init_model(0, tc, meta, dtype=torch.bfloat16, device="cpu")
    got = bridge.to_numpy(tb)
    assert [(k, s, str(t.dtype)) for (k, s), t in zip(_keys_shapes(jb), jax.tree_util.tree_leaves(
        jb))] == [(k, s, str(t.dtype)) for (k, s), t in zip(_keys_shapes(got),
                                                             jax.tree_util.tree_leaves(got))]
    assert set(tb["patch_proj"]) == {"w", "b"} and tb["patch_proj"]["w"].shape == (256, 256)
    again = tm.init_lora(0, tc, meta, dtype=torch.bfloat16, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(tl)))
    want = _keys_shapes(jl)
    for tree in (tl, tm.lora_zeros(tc, meta, device="cpu")):
        assert _keys_shapes(bridge.to_numpy(tree)) == want


@pytest.mark.parametrize("seq", [S, 16])
def test_data_stream_shifts_the_labels_past_the_patches(seq):
    """The port's stream and eval batch equal the reference's tokens and
    labels exactly: S - P tokens a row, position P + t labelled with token
    t + 1, the prefix and the last position IGNORE. The patch stub is
    (NB, P, d) f32, 0.1 x N(0, 1) from the port's own generator, the same
    at every step."""
    jc, tc = j_reduced(j_get_config(ARCH)), reduced(get_config(ARCH))
    configs = [LoraConfig(**c) for c in PACK]
    jit = j_batches(jc, [JLoraConfig(**c) for c in PACK], seq=seq)
    it = packed_batch_iterator(tc, configs, seq=seq, device="cpu")
    first = None
    for _ in range(2):
        jb, tb = next(jit), next(it)
        assert tb["tokens"].shape == (NB, seq - P) and tb["labels"].shape == (NB, seq)
        np.testing.assert_array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))
        np.testing.assert_array_equal(tb["labels"].numpy(), np.asarray(jb["labels"]))
        np.testing.assert_array_equal(tb["labels"][:, P:seq - 1].numpy(), tb["tokens"][:, 1:])
        assert (tb["labels"][:, :P] == -100).all() and (tb["labels"][:, -1] == -100).all()
        assert tb["patches"].shape == jb["patches"].shape and tb["patches"].dtype == torch.float32
        first = tb["patches"] if first is None else first
        assert torch.equal(tb["patches"], first)
    assert 0.08 < float(first.std()) < 0.12
    je, te = j_eval_batch(jc, 2, seq=seq), eval_batch(tc, 2, seq=seq, device="cpu")
    np.testing.assert_array_equal(te["tokens"].numpy(), np.asarray(je["tokens"]))
    np.testing.assert_array_equal(te["labels"].numpy(), np.asarray(je["labels"]))
    assert te["patches"].shape == je["patches"].shape


# ---------------------------------------------------------------------------
# the reduced model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_forward_matches_reference(world, dtype, impl):
    """The embedded stream (the projected patches, then the tokens'
    embeddings) and the whole model's logits against the reference's,
    within 1e-4 of max |value| in f32 and 5e-2 on a bf16 base and LoRA."""
    tc = world["cfg"]
    bf16 = dtype == "bf16"
    want_x, want = _ref_forward(world, bf16)
    tb, tl = ((bridge.to_torch(world["base"], "cpu", torch.bfloat16),
               bridge.to_torch(world["lora"], "cpu", torch.bfloat16)) if bf16
              else (world["tbase"], world["tlora"]))
    x = tm._embed(tb, world["batch"]["tokens"], tc, world["batch"])
    assert x.shape == (NB, S, tc.d_model)
    h, caches, _ = tm.forward(tb, tl, world["meta"].scales("cpu"), world["batch"], tc, n_pack=2,
                              kcfg=KernelConfig(impl=impl))
    assert caches is None and h.shape == (NB, S, tc.d_model)
    tol = LOGITS_BF16 if bf16 else LOGITS
    _close(x, want_x, tol)
    _close(tm.logits(tb, h, tc), want, tol)


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_packed_step_matches_reference(world, impl):
    """Step 1 of the packed loss on the reference's batch (the port's data
    stream gives its tokens and labels; the patches are the reference's
    stub): the total and each adapter's CE within 1e-5 of the
    reference's, every f32 LoRA gradient (q/k/v/o/gate/up/down, a and b)
    within 1e-4 of the largest value of the reference's."""
    jc, tc, jmeta, meta = world["jcfg"], world["cfg"], world["jmeta"], world["meta"]
    if "step" not in world:
        (jtot, jper), jgrads = jax.jit(jax.value_and_grad(
            lambda lo: j_packed_loss_fn(lo, world["base"], world["jbatch"], jc, 2,
                                        jmeta.scales()),
            has_aux=True))(world["lora"])
        world["step"] = float(jtot), jper, jax.tree_util.tree_leaves(jgrads)
    jtot, jper, want = world["step"]
    tb = next(packed_batch_iterator(tc, [LoraConfig(**c) for c in PACK], seq=S, device="cpu"))
    assert torch.equal(tb["tokens"], world["batch"]["tokens"])
    assert torch.equal(tb["labels"], world["batch"]["labels"])
    tb["patches"] = world["batch"]["patches"]
    tot, per, grads = packed_value_and_grad(world["tlora"], world["tbase"], tb, tc, 2,
                                            meta.scales("cpu"),
                                            kcfg=KernelConfig(impl=impl, ranks=meta.ranks))
    np.testing.assert_allclose(tot.item(), jtot, rtol=LOSS)
    _close(per, jper, LOSS)
    got = jax.tree_util.tree_leaves(bridge.to_numpy(grads))
    assert len(got) == len(want) == 7 * 2
    for g, ref in zip(got, want):
        assert np.abs(_np(ref)).max() > 0
        _close(g, ref, GRAD)


def test_prefill_then_decode_match_the_reference_forward(world):
    """(The port of ``tests/test_serve.py::
    test_prefill_then_decode_matches_full_forward`` for internvl2.) Prefill
    the 8 patches and 12 tokens, then decode the next 3 at positions 20,
    21, 22 (after the patches), in f32: the last prefill logits and each
    decode step's equal the reference's full forward within 1e-4 of max
    |logit|; the prefill's caches hold the patch positions."""
    tc, meta = world["cfg"], world["meta"]
    want = _ref_forward(world, False)[1]
    toks, patches = world["batch"]["tokens"], world["batch"]["patches"]
    s0 = S - P - 4
    lg, caches = tm.prefill(world["tbase"], world["tlora"], meta.scales(),
                            {"tokens": toks[:, :s0], "patches": patches}, tc, n_pack=2)
    _close(lg[:, 0], want[:, P + s0 - 1], LOGITS)
    assert caches["blocks"]["l0"]["attn"]["k"].shape[2] == P + s0
    caches = pad_caches(caches, S)
    for i in range(3):
        lg, caches = tm.decode_step(world["tbase"], world["tlora"], meta.scales(),
                                    toks[:, s0 + i:s0 + i + 1], caches, torch.tensor(P + s0 + i),
                                    tc, n_pack=2)
        _close(lg[:, 0], want[:, P + s0 + i], LOGITS)


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_cost_model_counts_match_reference(reduce):
    """The parameter counts are the reference's (629,592,320 at full size:
    ``patch_proj``, the norms and the biases not counted), and the LoRA
    count is both the reference's and the size of its own ``init_model``
    LoRA tree (8,798,208 at r = 16); with ``REFERENCE_MEMORY`` the prices
    are the reference's."""
    jc, tc = j_get_config(ARCH), get_config(ARCH)
    if reduce:
        jc, tc = j_reduced(jc), reduced(tc)
    assert tcm.model_param_count(tc) == jcm.model_param_count(jc)
    assert tcm.active_param_count(tc) == jcm.active_param_count(jc)
    _, jl = jax.eval_shape(lambda: jm.init_model(
        jax.random.PRNGKey(0), jc, j_pack_meta([JLoraConfig(rank=16, alpha=16.0)])))
    held = sum(int(np.prod(t.shape)) for t in jax.tree_util.tree_leaves(jl))
    assert tcm.lora_param_count(tc, 16) == jcm.lora_param_count(jc, 16) == held
    if not reduce:
        assert tcm.model_param_count(tc) == 629_592_320 and held == 8_798_208
    jmod = jcm.CostModel(jc, jcm.A100_40G)
    tmod = tcm.CostModel(tc, tcm.A100_40G, **tcm.REFERENCE_MEMORY)
    assert tmod.base_weight_bytes() == jmod.base_weight_bytes()
    js, ts = j_space(300, seq_len=512)[::37], default_search_space(300, seq_len=512)[::37]
    for k in (1, 3, len(ts)):
        assert tmod.job_mem_bytes(ts[:k], 1, 512) == jmod.job_mem_bytes(js[:k], 1, 512)
        assert tmod.iter_time(ts[:k], 1, 512) == jmod.iter_time(js[:k], 1, 512)


def test_planner_matches_reference_on_the_reduced_model():
    """Reduced internvl2-1b under the reference's memory accounting on a
    4 GB A100 preset (so packs split into several jobs): the port's plan
    ``==`` the reference's, job for job."""
    jc, tc = j_reduced(j_get_config(ARCH)), reduced(get_config(ARCH))
    hw = dict(mem_bytes=4e9)
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


def test_packed_adapter_equals_the_adapter_alone(world):
    """Port against port: adapter 1's CE and LoRA gradients in the pack of
    2 equal its own run alone within 1e-5, the patch prefix included."""
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


def test_continuous_batching_equals_sequential_with_patches(world):
    """``ServeEngine.serve`` (2 rows, 5 requests, each with its own patches
    as ``extra``) emits ``serve_sequential``'s greedy tokens; each
    request's positions start after its 8 patches, so ``smax`` counts them
    and a request whose patches, prompt and new tokens exceed it is
    rejected."""
    tc = world["cfg"]
    rng = np.random.RandomState(1)

    def req(i, n):
        return ServeRequest(i, f"ad{i % 2}", rng.randint(0, tc.vocab_size, size=n)
                            .astype(np.int32), max_new_tokens=4, arrival=float(i),
                            extra={"patches": 0.1 * rng.standard_normal((1, P, tc.d_model))
                                   .astype(np.float32)})

    reqs = [req(i, 5 + i) for i in range(5)]
    eng = ServeEngine(tc, world["tbase"], rows=2, smax=24, r_bucket=16, device="cpu")
    for i in range(2):
        eng.publish(f"ad{i}", extract_adapter(world["tlora"], i, world["meta"].ranks),
                    {"rank": PACK[i]["rank"], "alpha": PACK[i]["alpha"]})
    got, seq = eng.serve(reqs), eng.serve_sequential(reqs)
    assert [r.error for r in got.results] == [None] * 5
    for a, b in zip(got.results, seq.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    too_long = eng.serve([req(9, 24 - P - 4 + 1)]).results[0]
    assert too_long.error is not None and "exceeds smax=24" in too_long.error


def test_launcher_trains_and_saves_adapters(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch internvl2-1b --reduced
    --device cpu``: finite losses, and each adapter saved to the pool."""
    per = launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                             "--seq", "16", "--log-every", "0", "--pool", str(tmp_path)])
    assert per.shape == (2,) and np.isfinite(per).all()
    assert f"arch={ARCH}-reduced" in capsys.readouterr().out
    pool = CheckpointPool(str(tmp_path))
    assert pool.list() == [f"{ARCH}-reduced_adapter_000", f"{ARCH}-reduced_adapter_001"]
    assert set(pool.load_adapter(pool.list()[0])["decoder"]["blocks"]["l0"]) == {"attn", "mlp"}
