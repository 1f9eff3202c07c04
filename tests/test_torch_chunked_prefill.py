"""Chunked, decode-interleaved prefill in the port against the JAX package,
on the CPU.

A cached call with S > 1 at a scalar position is one chunk of a prefill:
GQA (with a sliding window), MLA and SSD layers write the chunk into their
caches and attend (or resume) from what is there; ``prefill_chunked``
loops ``prefill_chunk`` over a prompt, and ``ServeEngine(prefill_chunk=)``
streams prompts between decode steps.

The five configs at ``reduced()`` size (qwen25-7b with 2 k/v heads,
gemma3-1b with its window of 64, minicpm3-4b's MLA, mamba2-370m's SSD, and
jamba's hybrid with its MoE layers), weights from the JAX ``init_model``
(f32, LoRA + 0.02 N(0, 1) from a seed) carried across by
``repro_torch.bridge``. Each reference function is compiled once a shape
and shared (module-scoped worlds and executors).

Tolerances, f32 on both sides: logits and every cache leaf within 1e-4 of
the largest value of the compared array. Reduced MoE drops nothing
(capacity factor E / top_k), so jamba is held to the reference's chunks as
the other families are.

Inside the port, chunked prefill at capacity S is ``torch.equal`` to the
one-shot prefill: every chunk's products are the one-shot ones on a subset
of rows. That holds where the CPU's BLAS computes a row of x @ W the same
whatever the number of rows: on one thread (several may split K between
them) and at 3 rows or more (MKL takes a GEMV path at 1 or 2), so the
module runs the port on one thread, and those tests on chunks of at least
3 rows. A chunk of one token
takes the decode step's formulas, which are not bitwise the prefill's, as
in the reference.
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
from repro.core.packed_lora import extract_adapter as j_extract
from repro.models.model import init_model as j_init_model
from repro.serve.decode import prefill_chunked as j_prefill_chunked
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import ServeExecutor as JServeExecutor
from repro.serve.engine import ServeRequest as JServeRequest
from repro_torch import bridge
from repro_torch.configs import LoraConfig, get_config, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.core.packed_lora import extract_adapter
from repro_torch.models import model as tm
from repro_torch.obs import Tracer
from repro_torch.serve import (
    ServeEngine,
    ServeExecutor,
    ServeRequest,
    align_prefill_chunk,
    poisson_requests,
    prefill_chunked,
)
from repro_torch.tree import tree_leaves, tree_map

TOL = 1e-4
RANK, ALPHA = 8, 16.0
# (prompt length, chunks below, at and above it), chosen so that the
# reference compiles few chunk shapes: gemma3's prompt crosses its window of
# 64; mamba2's chunk of 32 is the SSD chunk itself, its 40 rounds up to 64
# (chunks of 64 and 32); jamba's 20 rounds up to 32
CASES = {
    "qwen25-7b": (24, (8, 24, 40)),
    "gemma3-1b": (96, (32, 96, 128)),
    "minicpm3-4b": (24, (8, 24, 40)),
    "mamba2-370m": (96, (32, 40, 96, 128)),
    "jamba-v0.1-52b": (96, (20, 96, 128)),
}


def _configs(arch):
    jc, tc = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    if arch == "qwen25-7b":
        jc = jc.replace(attention=dataclasses.replace(jc.attention, n_kv_heads=2))
        tc = tc.replace(attention=dataclasses.replace(tc.attention, n_kv_heads=2))
    return jc, tc


@pytest.fixture(scope="module")
def worlds():
    return {"jex": JServeExecutor()}


def _world(worlds, arch):
    """A width-1 world: the reference's weights (f32) and its one adapter,
    bridged; the prompt."""
    if arch not in worlds:
        jc, tc = _configs(arch)
        jmeta = j_pack_meta([JLoraConfig(rank=RANK, alpha=ALPHA)])
        base, lora = j_init_model(jax.random.PRNGKey(0), jc, jmeta)
        rng = np.random.RandomState(3)
        lora = jax.tree.map(
            lambda t: t + 0.02 * rng.standard_normal(t.shape).astype(np.float32), lora)
        s = CASES[arch][0]
        toks = np.random.RandomState(5).randint(0, tc.vocab_size, size=(1, s)).astype(np.int32)
        worlds[arch] = dict(
            jcfg=jc, cfg=tc, base=base, lora=lora, tokens=toks,
            tbase=bridge.to_torch(jax.tree.map(np.asarray, base), "cpu"),
            tlora=bridge.to_torch(jax.tree.map(np.asarray, lora), "cpu"),
            scales=pack_meta([LoraConfig(rank=RANK, alpha=ALPHA)]).scales("cpu"),
        )
    return worlds[arch]


def _np(t):
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t, np.float32)


def _close(got, want, what):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=TOL,
                               atol=TOL * max(np.abs(want).max(), 1e-30), err_msg=what)


def _port_chunked(w, chunk):
    with torch.no_grad():
        return prefill_chunked(w["tbase"], w["tlora"], w["scales"],
                               torch.from_numpy(w["tokens"]).long(), w["cfg"], chunk)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread for the port in this module: the bitwise tests need it
    (see the module's docstring), and beside the reference's XLA threads
    several made the port's small ops slower, not faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("arch", list(CASES))
def test_prefill_chunked_matches_reference(worlds, arch):
    """The port's ``prefill_chunked`` against the reference's on the same
    chunks: last-position logits and every cache leaf (f32 caches of
    capacity S on both sides), for chunks below, at and above the prompt."""
    w = _world(worlds, arch)
    s, chunks = CASES[arch]
    jscales = jnp.full((1,), ALPHA / RANK, jnp.float32)
    for chunk in chunks:
        jlg, jcaches = j_prefill_chunked(w["base"], w["lora"], jscales, jnp.asarray(w["tokens"]),
                                         w["jcfg"], chunk, executor=worlds["jex"])
        lg, caches = _port_chunked(w, chunk)
        assert lg.shape == (1, 1, w["cfg"].padded_vocab)
        _close(lg, jlg, f"{arch} chunk {chunk}: logits")
        want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jcaches))
        got = tree_leaves(caches)
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
            _close(a, b, f"{arch} chunk {chunk}: cache leaf {i}")


@pytest.mark.parametrize("arch, chunks", [("qwen25-7b", (3, 8, 24, 40)),
                                          ("mamba2-370m", (32, 64, 96))])
def test_prefill_chunked_equals_one_shot(worlds, arch, chunks):
    """Port against port: at capacity S the chunks give the one-shot
    prefill's logits and caches bit for bit (qwen at chunks 3, 8, S and
    more than S; mamba2 at chunks on its SSD grid). The reference claims
    this; its own test of it fails on its tree."""
    w = _world(worlds, arch)
    with torch.no_grad():
        want_lg, want_c = tm.prefill(w["tbase"], w["tlora"], w["scales"],
                                     {"tokens": torch.from_numpy(w["tokens"]).long()}, w["cfg"])
    for chunk in chunks:
        lg, caches = _port_chunked(w, chunk)
        assert torch.equal(lg, want_lg), chunk
        for a, b in zip(tree_leaves(caches), tree_leaves(want_c), strict=True):
            assert torch.equal(a, b.float()), chunk


def test_prefill_chunk_refuses_an_encoder_decoder_and_a_vector_pos(worlds):
    """An encoder-decoder's prefill is one shot; a prefill chunk's position
    is a scalar (a vector of per-row positions takes one token a row)."""
    cfg = reduced(get_config("whisper-tiny"))
    base, _ = tm.init_model(0, cfg, None, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="encoder-decoder"):
        tm.prefill_chunk(base, None, None, toks, tm.init_caches(cfg, 1, 8, device="cpu"), 0, cfg)
    w = _world(worlds, "qwen25-7b")
    caches = tm.init_caches(w["cfg"], 1, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="scalar pos"):
        tm.prefill_chunk(w["tbase"], w["tlora"], w["scales"], toks, caches, torch.tensor([0]),
                         w["cfg"])


def test_align_prefill_chunk():
    """Rounded up to the SSD chunk on a stack with SSM layers, unchanged on
    attention alone; None or 0 turns chunking off."""
    qwen, mamba, jamba = (reduced(get_config(a)) for a in ("qwen25-7b", "mamba2-370m",
                                                          "jamba-v0.1-52b"))
    q = mamba.ssm.chunk_size
    assert align_prefill_chunk(qwen, 5) == 5
    assert align_prefill_chunk(mamba, 1) == q and align_prefill_chunk(mamba, q) == q
    assert align_prefill_chunk(mamba, q + 1) == 2 * q
    assert align_prefill_chunk(jamba, q + 1) == 2 * q
    for cfg in (qwen, mamba):
        assert align_prefill_chunk(cfg, None) is None
        assert align_prefill_chunk(cfg, 0) is None


def test_executor_keeps_one_chunk_closure():
    ex = ServeExecutor()
    cfg = reduced(get_config("qwen25-7b"))
    fn = ex.prefill_chunk_fn(cfg, 1)
    assert ex.prefill_chunk_fn(cfg, 1) is fn
    assert ex.prefill_chunk_fn(cfg, 2) is not fn
    assert ex.cache_size == 2


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serve_world(worlds):
    """qwen's world and three adapters: its one adapter, perturbed by 0.02
    N(0, 1) from three seeds."""
    w = _world(worlds, "qwen25-7b")
    adapters = {}
    for i in range(3):
        rng = np.random.RandomState(10 + i)
        adapters[f"ad{i}"] = j_extract(jax.tree.map(
            lambda t: t + 0.02 * rng.standard_normal(t.shape).astype(np.float32), w["lora"]), 0)
    return dict(w, adapters=adapters)


def _engine(w, cfg=None, **kw):
    kw.setdefault("rows", 2)
    kw.setdefault("smax", 32)
    eng = ServeEngine(cfg or w["cfg"], w["tbase"], r_bucket=RANK, device="cpu", **kw)
    for aid, tree in w["adapters"].items():
        eng.publish(aid, tree, {"rank": RANK, "alpha": ALPHA})
    return eng


def _trace(cfg, n=5):
    """Prompts of 12 and 14 tokens (chunks of 4 leave a tail of 2 on the
    second), staggered arrivals."""
    rng = np.random.RandomState(13)
    prompts = [rng.randint(0, cfg.vocab_size, size=(12, 14)[i % 2]).astype(np.int32)
               for i in range(n)]
    return poisson_requests([f"ad{i % 3}" for i in range(n)], prompts, 2.0, max_new_tokens=5,
                            seed=4)


def test_chunked_engine_tokens(worlds, serve_world):
    """The chunked engine (chunks of 4 and 64) emits the one-shot engine's
    tokens, ``serve_sequential``'s and the reference's chunked engine's;
    after the drain no row is active and no adapter pinned."""
    w = serve_world
    reqs = _trace(w["cfg"])
    one_shot = _engine(w).serve(reqs)
    seq = _engine(w).serve_sequential(reqs)
    for chunk in (4, 64):
        eng = _engine(w, prefill_chunk=chunk)
        got = eng.serve(reqs)
        jeng = JServeEngine(w["jcfg"], w["base"], rows=2, smax=32, r_bucket=RANK,
                            prefill_chunk=chunk, serve_executor=worlds["jex"])
        for aid, tree in w["adapters"].items():
            jeng.publish(aid, tree, {"rank": RANK, "alpha": ALPHA})
        ref = jeng.serve([JServeRequest(r.request_id, r.adapter_id, r.prompt,
                                        max_new_tokens=r.max_new_tokens, arrival=r.arrival)
                          for r in reqs])
        assert len(got.results) == len(ref.results) == 5
        for a, b, c, d in zip(got.results, one_shot.results, seq.results, ref.results):
            assert a.error is None and a.request_id == b.request_id == c.request_id == d.request_id
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.tokens, c.tokens)
            np.testing.assert_array_equal(a.tokens, d.tokens)
        assert got.ttft.count == 5 and got.tokens_emitted == 25
        assert all(r is None for r in eng._rows) and eng.slot_cache._pins == {}


def test_chunked_prefill_spans(serve_world):
    """One ``serve.prefill_chunk`` span a chunk on the row's track: a
    10-token prompt in chunks of 4 at positions 0, 4, 8; no one-shot
    ``serve.prefill`` span."""
    w = serve_world
    tracer = Tracer()
    eng = _engine(w, rows=1, prefill_chunk=4, tracer=tracer)
    prompt = np.random.RandomState(17).randint(0, w["cfg"].vocab_size, size=10).astype(np.int32)
    stats = eng.serve([ServeRequest(0, "ad0", prompt, max_new_tokens=3)])
    assert len(stats.results[0].tokens) == 3
    chunks = [s for s in tracer.spans() if s.name == "serve.prefill_chunk"]
    assert all(s.cat == "serve" and s.track == "row0" for s in chunks)
    assert [s.args["pos"] for s in chunks] == [0, 4, 8]
    assert [s.args["chunk"] for s in chunks] == [4, 4, 2]
    assert all(s.args["n_prompt"] == 10 for s in chunks)
    assert not any(s.name == "serve.prefill" for s in tracer.spans())


def test_chunked_engine_max_steps_and_deadline(serve_world):
    """Filling rows are held to ``max_steps`` and to deadlines: they retire
    as partial results (no token yet) with their pins released. A
    chunk-only iteration still advances the virtual step, so a request
    arriving at step 1 is admitted while the first prompt fills, and ITL
    and occupancy count decoding rows only."""
    w = serve_world
    prompt = np.arange(13, dtype=np.int32)
    eng = _engine(w, rows=2, prefill_chunk=2)
    stats = eng.serve([ServeRequest(0, "ad0", prompt, max_new_tokens=8),
                       ServeRequest(1, "ad1", prompt[:4], max_new_tokens=8, arrival=1.0)],
                      max_steps=2)
    # steps 0-1 fill only; request 1 fills at steps 1-2 and decodes twice
    assert [len(r.tokens) for r in stats.results] == [0, 3]
    assert [r.admitted_step for r in stats.results] == [0, 1]
    assert stats.steps == 2 and stats.occupancy_sum == 2 and stats.itl.count == 2
    assert stats.ttft.count == 1
    assert eng.slot_cache._pins == {} and all(r is None for r in eng._rows)

    eng = _engine(w, rows=1, prefill_chunk=2)
    advance = eng._prefill_advance

    def late(row, step, st):  # the request's deadline passes during its first chunk
        eng._enq_abs[eng._rows[row].request.request_id] -= 10.0
        return advance(row, step, st)

    eng._prefill_advance = late
    stats = eng.serve([ServeRequest(0, "ad0", prompt, max_new_tokens=4, deadline_ms=5e3)])
    assert stats.results[0].error == "deadline" and len(stats.results[0].tokens) == 0
    assert eng.slot_cache._pins == {} and eng._rows == [None]


def test_vlm_request_stays_one_shot():
    """On a VLM the engine prefills in one shot whatever ``prefill_chunk``:
    a ``serve.prefill`` span, no chunk span, the one-shot engine's tokens."""
    cfg = reduced(get_config("internvl2-1b"))
    base, lora = tm.init_model(1, cfg, pack_meta([LoraConfig(rank=RANK, alpha=ALPHA)]),
                               device="cpu")
    w = dict(tbase=base, adapters={"ad0": extract_adapter(tree_map(lambda t: t + 0.02, lora), 0)})
    patches = 0.1 * torch.randn((1, cfg.n_patch_tokens, cfg.d_model),
                                generator=torch.Generator().manual_seed(2))
    req = ServeRequest(0, "ad0", np.arange(6, dtype=np.int32), max_new_tokens=3,
                       extra={"patches": patches})
    tracer = Tracer()
    got = _engine(w, cfg=cfg, prefill_chunk=2, tracer=tracer).serve([req])
    want = _engine(w, cfg=cfg).serve([req])
    names = {s.name for s in tracer.spans()}
    assert "serve.prefill" in names and "serve.prefill_chunk" not in names
    np.testing.assert_array_equal(got.results[0].tokens, want.results[0].tokens)
