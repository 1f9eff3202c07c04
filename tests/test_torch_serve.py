"""The port's serve engine against the JAX package's, and its own invariants.

Reduced qwen25-7b with f32 weights from the JAX ``init_model`` (bridged),
three adapters extracted from a LoRA pack + 0.02 (non-zero deltas). The
same requests go through the JAX ``ServeEngine.serve`` and the port's:
greedy tokens must be equal. Inside the port, continuous batching must emit
the tokens of the width-1 ``serve_sequential`` path. The slot-cache and
rejection cases mirror ``tests/test_serve_engine.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import LoraConfig as JLoraConfig
from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.core.adapter import pack_meta as j_pack_meta
from repro.core.packed_lora import extract_adapter as j_extract
from repro.models.model import init_model as j_init_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import ServeExecutor as JServeExecutor
from repro.serve.engine import ServeRequest as JServeRequest
from repro_torch import bridge
from repro_torch.configs import LoraConfig, get_config, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.core.packed_lora import inject_adapter
from repro_torch.models.model import init_model, lora_zeros
from repro_torch.serve import (
    AdapterSlotCache,
    ServeEngine,
    ServeExecutor,
    ServeRequest,
    generate,
    make_prefill,
    make_serve_step,
    pad_caches,
    poisson_requests,
)

JCFG = j_reduced(j_get_config("qwen25-7b"))
CFG = reduced(get_config("qwen25-7b"))
RANK, ALPHA = 8, 16.0


@pytest.fixture(scope="module")
def world():
    meta = j_pack_meta([JLoraConfig(rank=RANK, alpha=ALPHA)] * 3)
    base, lora = j_init_model(jax.random.PRNGKey(0), JCFG, meta)
    lora = jax.tree.map(lambda x: x + 0.02, lora)
    adapters = {f"ad{i}": j_extract(lora, i) for i in range(3)}
    tbase = bridge.to_torch(jax.tree.map(np.asarray, base), "cpu")
    return base, tbase, adapters


def _engine(tbase, adapters, **kw):
    kw.setdefault("rows", 2)
    kw.setdefault("smax", 32)
    kw.setdefault("r_bucket", RANK)
    eng = ServeEngine(CFG, tbase, device="cpu", **kw)
    for aid, tree in adapters.items():
        eng.publish(aid, tree, {"rank": RANK, "alpha": ALPHA})
    return eng


def _prompts(n, lengths=(6, 9), seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG.vocab_size, size=lengths[i % len(lengths)]).astype(np.int32)
            for i in range(n)]


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_engine_tokens_match_reference(world, impl):
    """Same adapters, prompts and arrivals: the port's engine emits the JAX
    engine's greedy tokens (JAX on the CPU runs its plain XLA forms)."""
    base, tbase, adapters = world
    prompts = _prompts(5, lengths=(7,))  # one length: one JAX prefill compile
    jeng = JServeEngine(JCFG, base, rows=2, smax=32, r_bucket=RANK,
                        serve_executor=JServeExecutor(), impl=None if impl == "auto" else impl)
    for aid, tree in adapters.items():
        jeng.publish(aid, tree, {"rank": RANK, "alpha": ALPHA})
    want = jeng.serve([JServeRequest(i, f"ad{i % 3}", p, max_new_tokens=5, arrival=float(i))
                       for i, p in enumerate(prompts)])
    got = _engine(tbase, adapters, impl=impl).serve(
        [ServeRequest(i, f"ad{i % 3}", p, max_new_tokens=5, arrival=float(i))
         for i, p in enumerate(prompts)])
    assert [r.request_id for r in got.results] == [r.request_id for r in want.results]
    for a, b in zip(got.results, want.results):
        assert a.error is None and b.error is None
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert got.steps == want.steps and got.tokens_emitted == want.tokens_emitted


def test_continuous_matches_sequential(world):
    _, tbase, adapters = world
    eng = _engine(tbase, adapters, rows=2)
    reqs = poisson_requests([f"ad{i % 3}" for i in range(5)], _prompts(5), 2.0,
                            max_new_tokens=5, seed=3)
    cont = eng.serve(reqs)
    seq = eng.serve_sequential(reqs)
    assert len(cont.results) == len(seq.results) == 5
    for a, b in zip(cont.results, seq.results):
        assert a.request_id == b.request_id
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert cont.steps < seq.steps
    assert cont.ttft.count == 5 and cont.itl.count > 0


def test_engine_matches_generate(world):
    _, tbase, adapters = world
    prompt = _prompts(1, seed=7)[0]
    stats = _engine(tbase, adapters).serve([ServeRequest(0, "ad1", prompt, max_new_tokens=4)])
    meta1 = pack_meta([LoraConfig(rank=RANK, alpha=ALPHA)])
    tmpl = bridge.to_numpy(lora_zeros(CFG, meta1, device="cpu"))
    lora1 = bridge.to_torch(inject_adapter(tmpl, adapters["ad1"], 0), "cpu")
    toks = generate(tbase, lora1, CFG, meta1, torch.from_numpy(prompt[None, :]), 4, device="cpu")
    np.testing.assert_array_equal(stats.results[0].tokens, toks[0].numpy())
    # the bare closures give the same tokens
    prefill_fn = make_prefill(CFG, meta1, device="cpu")
    step = make_serve_step(CFG, meta1, device="cpu")
    lg, caches = prefill_fn(tbase, lora1, {"tokens": torch.from_numpy(prompt[None, :])})
    caches = pad_caches(caches, len(prompt) + 4)
    tok, out = torch.argmax(lg[:, -1], -1).to(torch.int32), []
    for i in range(4):
        out.append(int(tok[0]))
        tok, _, caches = step(tbase, lora1, caches, tok[:, None], torch.tensor(len(prompt) + i))
    assert out == toks[0].tolist()


def test_row_reuse_after_retirement(world):
    _, tbase, adapters = world
    eng = _engine(tbase, adapters, rows=1)
    stats = eng.serve([ServeRequest(i, f"ad{i}", p, max_new_tokens=3)
                       for i, p in enumerate(_prompts(3))])
    assert [r.request_id for r in stats.results] == [0, 1, 2]
    assert stats.tokens_emitted == 9
    assert all(r is None for r in eng._rows) and (eng._scales == 0.0).all()
    assert eng.slot_cache._pins == {}


def test_prompt_overflow_rejected(world):
    _, tbase, adapters = world
    eng = _engine(tbase, adapters, rows=1, smax=16)
    bad = ServeRequest(0, "ad0", _prompts(1, lengths=(14,))[0], max_new_tokens=8)
    good = ServeRequest(1, "ad1", _prompts(1, lengths=(5,))[0], max_new_tokens=3)
    stats = eng.serve([bad, good])
    rej, ok = stats.results
    assert "exceeds smax" in rej.error and rej.tokens.shape == (0,)
    assert ok.error is None and len(ok.tokens) == 3
    assert eng.slot_cache._pins == {}
    assert stats.queue_wait.count == 1 and stats.ttft.count == 1


def test_unknown_adapter_rejected_engine_keeps_serving(world):
    _, tbase, adapters = world
    eng = _engine(tbase, adapters, rows=1)
    stats = eng.serve([ServeRequest(0, "nope", _prompts(1)[0], max_new_tokens=3),
                       ServeRequest(1, "ad0", _prompts(1, seed=2)[0], max_new_tokens=3)])
    assert "neither staged nor" in stats.results[0].error
    assert stats.results[1].error is None and len(stats.results[1].tokens) == 3
    assert eng.slot_cache._pins == {}


def test_max_steps_and_deadline_exits(world):
    _, tbase, adapters = world
    eng = _engine(tbase, adapters, rows=2)
    stats = eng.serve([ServeRequest(i, f"ad{i}", p, max_new_tokens=10)
                       for i, p in enumerate(_prompts(2))], max_steps=3)
    assert [len(r.tokens) for r in stats.results] == [4, 4]
    assert all(r is None for r in eng._rows) and eng.slot_cache._pins == {}
    late = ServeRequest(5, "ad0", _prompts(1)[0], max_new_tokens=3, deadline_ms=0.0)
    eng.submit(late)
    stats = eng.serve([])
    assert stats.results[0].error == "deadline" and len(stats.results[0].tokens) == 0


def test_slot_cache_lru_pin_and_miss():
    cache = AdapterSlotCache(2)
    cache.publish("a", {"w": 1}, {})
    cache.publish("b", {"w": 2}, {})
    cache.get("a")
    cache.publish("c", {"w": 3}, {})  # evicts b, the least recently used
    assert cache.ids() == ["a", "c"] and cache.evictions == 1
    cache.pin("a")
    cache.pin("c")
    with pytest.raises(RuntimeError, match="pinned"):
        cache.publish("d", {"w": 4}, {})
    cache.unpin("c")
    cache.publish("d", {"w": 4}, {})  # c is evictable now
    assert cache.ids() == ["a", "d"]
    with pytest.raises(KeyError, match="neither staged nor"):
        cache.get("zzz")
    assert cache.misses == 1 and cache.hits == 1


def test_executor_cache_is_reused():
    ex = ServeExecutor()
    assert ex.step_fn(CFG, 2) is ex.step_fn(CFG, 2)
    assert ex.step_fn(CFG, 1) is not ex.step_fn(CFG, 2)
    ex.prefill_fn(CFG, 1)
    ex.prefill_fn(CFG, 1)
    assert ex.cache_size == 3


def test_entry_points_without_cuda_need_a_device(world, monkeypatch):
    """With no CUDA and no device given, the entry points raise: they never
    fall back to the CPU on their own."""
    _, tbase, _ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(0, CFG, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(CFG, tbase)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(tbase, None, CFG, None, torch.zeros((1, 4), dtype=torch.int32), 2)
