"""The serve engine's decode steps as CUDA graphs, and the drain loop that
feeds them.

On the CPU (JAX imported inside the reference's fixture only, so this file
also runs where JAX is not installed): the port's engine, whose drain now
stages its row vectors through one host buffer and reads its tokens back
through another, emits the reference engine's greedy tokens on a trace with
staggered arrivals, retirements and chunked admissions (reduced qwen25-7b
at 2 k/v heads in f32, one set of weights for both); engines share
``default_executor()``; ``capture=True`` raises on the CPU and
``capture=None`` runs eagerly there; a drain leaves the closure cache as
the first drain built it.

On the card (``gpu`` marker; without JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_serve_capture.py

every family's decode path at reduced size in bf16 (GQA, gemma3's window,
MLA's absorbed decode, SSD's in-place state, the MoE "ep" dispatch, the
hybrid, whisper's cross-attention, internvl2's patch offset, command-r on
int8 and nf4 bases): a captured drain emits the eager drain's tokens, greedy
and sampled under one seed, one captured step's logits equal the eager
step's bit for bit (the same kernels in the same order), each replay adds
the launches its capture recorded, and dropping the engine gives its
graphs' memory back.
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import LoraConfig, get_config, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.core.packed_lora import extract_adapter
from repro_torch.kernels import launches
from repro_torch.models.model import init_model, lora_zeros
from repro_torch.serve import (
    ServeEngine,
    ServeExecutor,
    ServeRequest,
    default_executor,
    generate,
    poisson_requests,
)
from repro_torch.tree import tree_map

RANK, ALPHA = 8, 16.0
CHUNK = 4


def _qwen_kv2(cfg):
    return cfg.replace(attention=dataclasses.replace(cfg.attention, n_kv_heads=2))


CFG = _qwen_kv2(reduced(get_config("qwen25-7b")))


def _trace(cfg, n=5):
    """Prompts of 12 tokens, three chunks of 4 each (one length: the
    reference compiles one chunk shape), Poisson arrivals: rows retire and
    refill mid-drain."""
    rng = np.random.RandomState(13)
    prompts = [rng.randint(0, cfg.vocab_size, size=12).astype(np.int32) for i in range(n)]
    return poisson_requests([f"ad{i % 3}" for i in range(n)], prompts, 2.0, max_new_tokens=5,
                            seed=4)


@pytest.fixture(scope="module")
def world():
    """The port's f32 weights (``init_model``, handed to the reference as
    numpy: the reference's own init takes seconds more), three adapters
    (the LoRA pack + 0.02 N(0, 1) from a seed), and the reference engine's
    chunked drain of ``_trace``."""
    import jax.numpy as jnp

    from repro.configs.base import get_config as j_get_config
    from repro.configs.base import reduced as j_reduced
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro.serve.engine import ServeExecutor as JServeExecutor
    from repro.serve.engine import ServeRequest as JServeRequest

    base, lora = init_model(0, CFG, pack_meta([LoraConfig(rank=RANK, alpha=ALPHA)] * 3),
                            device="cpu")
    gen = torch.Generator().manual_seed(3)
    lora = bridge.to_numpy(tree_map(lambda t: t + 0.02 * torch.randn(t.shape, generator=gen),
                                    lora))
    adapters = {f"ad{i}": extract_adapter(lora, i) for i in range(3)}
    jeng = JServeEngine(_qwen_kv2(j_reduced(j_get_config("qwen25-7b"))),
                        tree_map(jnp.asarray, bridge.to_numpy(base)), rows=2, smax=32,
                        r_bucket=RANK, prefill_chunk=CHUNK, serve_executor=JServeExecutor())
    for aid, tree in adapters.items():
        jeng.publish(aid, tree, {"rank": RANK, "alpha": ALPHA})
    ref = jeng.serve([JServeRequest(r.request_id, r.adapter_id, r.prompt,
                                    max_new_tokens=r.max_new_tokens, arrival=r.arrival)
                      for r in _trace(CFG)])
    return dict(tbase=base, adapters=adapters, ref=ref)


def _engine(w, **kw):
    kw.setdefault("rows", 2)
    kw.setdefault("smax", 32)
    eng = ServeEngine(CFG, w["tbase"], r_bucket=RANK, device="cpu", **kw)
    for aid, tree in w["adapters"].items():
        eng.publish(aid, tree, {"rank": RANK, "alpha": ALPHA})
    return eng


def test_drain_matches_reference(world):
    """Staggered arrivals, retirements and chunked admissions through the
    staged row vectors: the reference engine's greedy tokens, steps and
    token count; every row free and every adapter unpinned after."""
    eng = _engine(world, prefill_chunk=CHUNK, serve_executor=ServeExecutor())
    got = eng.serve(_trace(CFG))
    want = world["ref"]
    assert [r.request_id for r in got.results] == [r.request_id for r in want.results]
    for a, b in zip(got.results, want.results):
        assert a.error is None and b.error is None
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert got.steps == want.steps and got.tokens_emitted == want.tokens_emitted == 25
    assert got.step_host.count == got.steps
    assert all(r is None for r in eng._rows) and eng.slot_cache._pins == {}


def test_row_vectors_are_views_of_one_host_buffer(world):
    """The drain's host arrays write straight into the staging buffer, and
    the device buffer's views read what one copy brings over."""
    eng = _engine(world, rows=3, serve_executor=ServeExecutor())
    eng._tok[1, 0] = 7
    eng._pos[2] = 11
    eng._scales[0] = 0.5
    eng._temp[1] = 0.8
    eng._topk[2] = 50
    for a in (eng._tok, eng._pos, eng._scales, eng._temp, eng._topk):
        assert np.shares_memory(a, eng._rows_host.numpy())
    eng._rows_dev.copy_(eng._rows_host)
    dev = eng._dev
    assert dev["tok"].shape == (3, 1) and dev["tok"][:, 0].tolist() == [0, 7, 0]
    assert dev["pos"].dtype == torch.int64 and dev["pos"].tolist() == [0, 0, 11]
    assert dev["scales"].tolist() == [0.5, 0.0, 0.0]
    assert dev["temp"].tolist() == pytest.approx([0.0, 0.8, 0.0])
    assert dev["topk"].dtype == torch.int32 and dev["topk"].tolist() == [0, 0, 50]


def test_default_executor_is_shared(world):
    """One process-wide executor: every engine given none, and ``generate``,
    take their closures from it."""
    ex = default_executor()
    assert default_executor() is ex
    a, b = _engine(world), _engine(world, rows=1)
    assert a.serve_executor is ex and b.serve_executor is ex
    meta1 = pack_meta([LoraConfig(rank=RANK, alpha=ALPHA)])
    generate(world["tbase"], lora_zeros(CFG, meta1, device="cpu"), CFG, meta1,
             torch.zeros((1, 4), dtype=torch.int32), 2, device="cpu")
    assert ex.step_fn(CFG, 1) is ex.step_fn(CFG, 1)
    assert ("step", CFG, 1, None) in ex._fns
    own = ServeExecutor()
    assert _engine(world, serve_executor=own).serve_executor is own


def test_capture_needs_cuda(world):
    """``capture=True`` on the CPU raises; ``None`` (the default) and
    ``False`` run eagerly there and capture nothing."""
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        _engine(world, capture=True)
    for capture in (None, False):
        eng = _engine(world, capture=capture, serve_executor=ServeExecutor())
        assert eng.capture is False
        stats = eng.serve(_trace(CFG, n=2))
        assert [len(r.tokens) for r in stats.results] == [5, 5]
        assert eng.captures == [] and eng._graphs == {}


def test_drain_keeps_the_closure_cache(world):
    """A drain builds its closures once: a second drain, and a
    ``decode_once`` of the same rows, add none."""
    ex = ServeExecutor()
    eng = _engine(world, prefill_chunk=CHUNK, serve_executor=ex)
    first = eng.serve(_trace(CFG))
    n = ex.cache_size
    assert n == 2  # the chunk step and the greedy decode step
    again = eng.serve(_trace(CFG))
    for a, b in zip(first.results, again.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    eng.decode_once([1, 2], [12, 13], [2.0, 2.0])
    assert ex.cache_size == n


def test_decode_once_is_the_drains_step(world):
    """``decode_once`` stages the given row vectors as a drain does: its
    greedy tokens are the argmax of its logits, and a sampling step at
    temperature 0 gives the same tokens."""
    eng = _engine(world, serve_executor=ServeExecutor())
    eng.serve(_trace(CFG, n=2))
    snap = tree_map(torch.clone, eng._caches)
    tok, lg = eng.decode_once([3, 4], [12, 13], [2.0, 2.0])
    assert torch.equal(tok, torch.argmax(lg[:, -1, :], dim=-1).to(torch.int32))
    tree_map(lambda d, s: d.copy_(s), eng._caches, snap)
    tok2, lg2 = eng.decode_once([3, 4], [12, 13], [2.0, 2.0], temperature=[0.0, 0.0],
                                top_k=[0, 0], step=3)
    assert torch.equal(tok2, tok) and torch.equal(lg2, lg)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# (arch, quantized base, impls): every decode path the engine runs
FAMILIES = [
    ("qwen25-7b", None, ("auto", "fused")),
    ("gemma3-1b", None, ("auto", "fused")),
    ("minicpm3-4b", None, ("auto", "fused")),
    ("mamba2-370m", None, ("auto", "fused")),
    ("qwen3-moe-30b-a3b", None, ("auto", "fused")),
    ("jamba-v0.1-52b", None, ("auto", "fused")),
    ("whisper-tiny", None, ("auto", "fused")),
    ("internvl2-1b", None, ("auto", "fused")),
    ("command-r-35b", "int8", ("auto", "fused")),
    ("command-r-35b", "nf4", ("fused",)),
]
CASES = [(a, q, i) for a, q, impls in FAMILIES for i in impls]
N_REQ, NEW = 6, 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _gpu_world(arch, quant, dev):
    cfg = reduced(get_config(arch))
    base, _ = init_model(0, cfg, None, dtype=torch.bfloat16, device=dev, quant=quant)
    gen = torch.Generator().manual_seed(1)
    adapters = []
    for i in range(3):
        r = (8, 16)[i % 2]
        tmpl = lora_zeros(cfg, pack_meta([LoraConfig(rank=r, alpha=float(r))]), torch.float32,
                          "cpu")
        tree = tree_map(lambda t: 0.05 * torch.randn(t.shape, generator=gen), tmpl)
        adapters.append((tree_map(lambda t: (t[:, 0] if t.ndim == 4 else t[0]).numpy(), tree),
                         r))
    rng = np.random.RandomState(2)
    lo, hi = (70, 120) if arch == "gemma3-1b" else (8, 40)  # gemma3: past its window
    prompts = [rng.randint(0, cfg.vocab_size, size=rng.randint(lo, hi)).astype(np.int32)
               for _ in range(N_REQ)]
    xgen = torch.Generator().manual_seed(3)
    extras = [{k: 0.1 * torch.randn((1, s, cfg.d_model), generator=xgen)
               for k, s in (("frames", cfg.encoder_seq_len if cfg.is_encdec else 0),
                            ("patches", cfg.n_patch_tokens)) if s} for _ in range(N_REQ)]
    smax = (hi + cfg.n_patch_tokens + NEW + 63) // 64 * 64
    return cfg, base, adapters, prompts, extras, smax


def _requests(prompts, extras, sampled):
    reqs = poisson_requests([f"ad{i % 3}" for i in range(len(prompts))], prompts, 1.5,
                            max_new_tokens=NEW, seed=5)
    return [dataclasses.replace(r, extra=e or None,
                                temperature=0.8 if sampled and i % 2 else 0.0,
                                top_k=50 if sampled and i % 2 else 0)
            for i, (r, e) in enumerate(zip(reqs, extras))]


def _serve(cfg, base, adapters, reqs, smax, impl, quant, capture, dev):
    eng = ServeEngine(cfg, base, rows=4, smax=smax, r_bucket=16, impl=impl, base_dtype=quant,
                      capture=capture, seed=11, device=dev)
    for i, (tree, r) in enumerate(adapters):
        eng.publish(f"ad{i}", tree, {"rank": r, "alpha": float(r)})
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    assert all(r.error is None and len(r.tokens) == NEW for r in stats.results)
    return eng, np.stack([r.tokens for r in stats.results])


@pytest.mark.gpu
@pytest.mark.parametrize("arch,quant,impl", CASES)
def test_captured_drain_equals_eager(cuda, arch, quant, impl):
    cfg, base, adapters, prompts, extras, smax = _gpu_world(arch, quant, cuda)
    counter = {"auto": "packed_matmul", "fused": "fused_matmul_q" if quant else "fused_matmul"}
    # the greedy pass runs first: the process's first capture gives the
    # capture stream a cuBLAS workspace, which stays with the stream, so
    # memory is held to its level before the engine on the sampled pass
    for sampled in (False, True):
        reqs = _requests(prompts, extras, sampled)
        eager, want = _serve(cfg, base, adapters, reqs, smax, impl, quant, False, cuda)
        assert eager.captures == []
        del eager
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(cuda)
        launches.zero()
        eng, got = _serve(cfg, base, adapters, reqs, smax, impl, quant, True, cuda)
        np.testing.assert_array_equal(got, want)
        assert [c["sampling"] for c in eng.captures] == ([False, True] if sampled else [False])
        assert all(c["pool_bytes"] >= 0 and c["seconds"] > 0 for c in eng.captures)
        assert launches.read()[counter[impl]] > 0
        # each replay adds what its capture recorded
        graph = eng._graphs[False]
        recorded = sum(k for (name, _, _), k in graph.launches.items()
                       if name == counter[impl])
        assert recorded > 0
        before = launches.read()[counter[impl]]
        eng.decode_once([1] * 4, [smax - 2] * 4, [1.0] * 4)
        assert launches.read()[counter[impl]] - before == recorded
        # one captured step's logits against the eager step's, same inputs
        snap = tree_map(torch.clone, eng._caches)
        lg = eng.decode_once([5, 6, 7, 8], [smax - 3] * 4, [1.0] * 4)[1].clone()
        tree_map(lambda d, s: d.copy_(s), eng._caches, snap)
        lg_eager = eng.decode_once([5, 6, 7, 8], [smax - 3] * 4, [1.0] * 4, eager=True)[1]
        assert torch.equal(lg, lg_eager)
        del eng, graph, snap, lg, lg_eager
        gc.collect()
        torch.cuda.empty_cache()
        if sampled:
            assert torch.cuda.memory_allocated(cuda) == held
