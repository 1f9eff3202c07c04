"""Tune-then-serve in the port against the JAX package, on the CPU:
sampling at temperature > 0, slot-cache misses loaded from a checkpoint
pool, ``ServeEngine`` as a ``Runner``, and ``merge_adapter`` /
``merge_model``.

Reduced gemma3-1b (as the reference's serve tests use), its weights drawn
once by the port's ``init_model`` (f32; the LoRA pack + a seeded N(0, 0.02)
perturbation) and carried to the reference as numpy (``bridge.to_numpy``),
so both packages see the same inputs. The reference's ``init_model`` costs
seconds a call on the CPU, which the module does not pay.

Tolerances, stated per case: ``sample_tokens``'s greedy rows bit for bit;
its law within a total-variation distance of 0.04 of the reference's masked
softmax over 20,000 draws (the reference's own sampler meets the same
bound, so both draw from one law; torch cannot reproduce ``jax.random``'s
streams, so the draws themselves differ); ``merge_model`` f32 within 1e-6
of the largest |value| of each leaf, bf16 within one bf16 ulp of each
value; the merged base's forward within 5e-3 of the adapter path (the
reference's ``tests/test_serve.py:100-115``). Engine sampling, the pool and
the runner are held port against port, as their reference tests hold the
reference against itself.
"""
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.packed_lora import extract_adapter as j_extract
from repro.core.packed_lora import merge_adapter as j_merge_adapter
from repro.core.packed_lora import merge_model as j_merge_model
from repro.serve.engine import sample_tokens as j_sample_tokens
from repro.train import checkpoint as jckpt
from repro_torch import bridge
from repro_torch.cluster import DevicePool, Runner
from repro_torch.configs import LoraConfig, get_config, reduced
from repro_torch.core.adapter import pack_meta
from repro_torch.core.packed_lora import (
    extract_adapter,
    inject_adapter,
    merge_adapter,
    merge_model,
)
from repro_torch.kernels.quant import is_quantized, quantize_base_params
from repro_torch.models.model import forward, init_model, lora_zeros
from repro_torch.sched.engine import JobRecord, JobSegment
from repro_torch.sched.planner import ScheduledJob
from repro_torch.serve import (
    AdapterSlotCache,
    ServeEngine,
    ServeExecutor,
    ServeRequest,
    draw_seed,
    sample_tokens,
)
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.data import packed_batch_iterator
from repro_torch.train.trainer import train_loop
from repro_torch.tree import tree_leaves, tree_map

CFG = reduced(get_config("gemma3-1b"))
RANK, ALPHA = 8, 16.0
META = {"rank": RANK, "alpha": ALPHA}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port on one thread: beside the reference's XLA threads, several
    make its small ops slower, not faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """The base (torch and numpy), the 3-adapter LoRA pack (torch and
    numpy) and its adapters as host trees."""
    meta = pack_meta([LoraConfig(rank=RANK, alpha=ALPHA)] * 3)
    base, lora = init_model(0, CFG, meta, device="cpu")
    gen = torch.Generator().manual_seed(3)
    lora = tree_map(lambda t: t + 0.02 * torch.randn(t.shape, generator=gen), lora)
    nlora = bridge.to_numpy(lora)
    return {"base": base, "nbase": bridge.to_numpy(base), "lora": lora, "nlora": nlora,
            "adapters": {f"ad{i}": extract_adapter(nlora, i) for i in range(3)},
            "scales": meta.scales("cpu")}


def _prompts(n, lo=4, hi=9, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG.vocab_size, size=rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _engine(world, publish=True, **kw):
    kw.setdefault("rows", 2)
    kw.setdefault("smax", 48)
    eng = ServeEngine(CFG, world["base"], r_bucket=RANK, serve_executor=ServeExecutor(),
                      device="cpu", **kw)
    if publish:
        for aid, tree in world["adapters"].items():
            eng.publish(aid, tree, META)
    return eng


def _tokens(stats):
    assert all(r.error is None for r in stats.results), [r.error for r in stats.results]
    return {r.request_id: r.tokens for r in stats.results}


# ---------------------------------------------------------------------------
# sample_tokens
# ---------------------------------------------------------------------------


# every reference draw takes one shape, so JAX compiles its sampler once
N_DRAWS, V = 20_000, 64


_j_sample = jax.jit(j_sample_tokens)  # one compile, not one per eager op


def _ref_draw(lg, temp, topk, seed):
    n = lg.shape[0]
    return np.asarray(_j_sample(jnp.asarray(lg), jnp.full((n,), temp, jnp.float32),
                                jnp.full((n,), topk, jnp.int32), jax.random.PRNGKey(seed)))


def _port_draw(lg, temp, topk, seed):
    gen = torch.Generator().manual_seed(seed)
    return sample_tokens(torch.from_numpy(lg), torch.tensor(temp, dtype=torch.float32),
                         torch.tensor(topk, dtype=torch.int32), gen).numpy()


def test_sample_tokens_greedy_rows_are_the_argmax():
    """top_k = 1 and temperature 0 are the argmax bit for bit, as in the
    reference (its ``tests/test_quant.py:309-324``), and a greedy row keeps
    it beside sampled rows."""
    lg = np.random.RandomState(0).randn(N_DRAWS, V).astype(np.float32)
    argmax = lg.argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(_ref_draw(lg, 0.9, 1, 7), argmax)
    np.testing.assert_array_equal(_port_draw(lg, [0.9] * N_DRAWS, [1] * N_DRAWS, 7), argmax)
    np.testing.assert_array_equal(_port_draw(lg, [0.0] * N_DRAWS, [0] * N_DRAWS, 7), argmax)
    mixed = _port_draw(lg[:4], [0.0, 1.5, 0.0, 2.0], [0, 0, 3, 5], 7)
    np.testing.assert_array_equal(mixed[[0, 2]], argmax[[0, 2]])
    assert mixed.dtype == np.int32


def test_sample_tokens_keeps_ties_at_the_threshold():
    """Logits tied at the k-th value: every tied token is kept (``lg >=
    thresh``), as the reference's mask keeps it; nothing below it is drawn."""
    row = np.full((V,), -2.0, np.float32)
    row[[1, 4, 7, 9]] = 1.0  # k = 2 falls inside this tie of four
    row[12] = 3.0
    lg = np.tile(row, (N_DRAWS, 1))
    want = {1, 4, 7, 9, 12}
    got = set(_port_draw(lg, [4.0] * N_DRAWS, [2] * N_DRAWS, 11).tolist())
    assert got == set(_ref_draw(lg, 4.0, 2, 11).tolist()) == want


def test_sample_tokens_same_seed_same_tokens():
    lg = np.random.RandomState(1).randn(8, 64).astype(np.float32)
    a = _port_draw(lg, [1.3] * 8, [5] * 8, 3)
    np.testing.assert_array_equal(a, _port_draw(lg, [1.3] * 8, [5] * 8, 3))
    top5 = np.argsort(lg, axis=-1)[:, -5:]
    assert all(t in top5[i] for i, t in enumerate(a))
    draws = np.stack([_port_draw(lg, [1.3] * 8, [0] * 8, s) for s in range(4)])
    assert len({d.tobytes() for d in draws}) > 1  # the seed reaches the draw


@pytest.mark.parametrize("topk", [0, 5])
def test_sample_tokens_law_matches_the_reference(topk):
    """20,000 draws of each sampler against the exact softmax of the
    reference's masked logits (``jax.nn.softmax``): total variation <= 0.04
    for both."""
    temp = 0.8
    row = (1.5 * np.random.RandomState(2).randn(V)).astype(np.float32)
    lg = np.tile(row, (N_DRAWS, 1))
    k_eff = topk if topk > 0 else V
    thresh = np.sort(row)[V - k_eff]
    exact = np.asarray(jax.nn.softmax(jnp.where(row >= thresh, row, -jnp.inf) / temp))
    port = _port_draw(lg, [temp] * N_DRAWS, [topk] * N_DRAWS, 5)
    for what, draws in (("port", port), ("reference", _ref_draw(lg, temp, topk, 5))):
        freq = np.bincount(draws, minlength=V) / N_DRAWS
        tv = 0.5 * np.abs(freq - exact).sum()
        assert tv <= 0.04, (what, tv)
        assert freq[exact == 0].sum() == 0, what


def test_draw_seed_streams():
    assert draw_seed(0, 1, 3) == draw_seed(0, 1, 3) < 2 ** 63
    assert len({draw_seed(0, 1, 3), draw_seed(0, 2, 3), draw_seed(1, 1, 3),
                draw_seed(0, 1, 4)}) == 4


# ---------------------------------------------------------------------------
# Sampling in the engine
# ---------------------------------------------------------------------------


def _requests(sampled: bool):
    prompts = _prompts(4, seed=4)
    settings = [(0.0, 0), (0.8, 4), (0.0, 0), (1.0, 0)]
    return [ServeRequest(i, f"ad{i % 3}", p, max_new_tokens=5,
                         temperature=t if sampled else 0.0, top_k=k if sampled else 0)
            for i, (p, (t, k)) in enumerate(zip(prompts, settings))]


@pytest.mark.parametrize("chunk", [None, 3], ids=["one_shot", "chunked"])
def test_engine_mixed_greedy_and_sampled_rows(world, chunk):
    """Greedy requests in a mixed drain emit the tokens of an all-greedy
    drain, the sampled ones repeat under one seed, and an all-greedy drain
    never builds the sampling step (the reference's
    ``test_serve_mixed_greedy_and_sampled_rows``)."""
    greedy_eng = _engine(world, prefill_chunk=chunk)
    greedy = _tokens(greedy_eng.serve(_requests(False)))
    assert not any(k[0] == "sample_step" for k in greedy_eng.serve_executor._fns)
    mixed_eng = _engine(world, prefill_chunk=chunk, seed=7)
    mixed = _tokens(mixed_eng.serve(_requests(True)))
    assert any(k[0] == "sample_step" for k in mixed_eng.serve_executor._fns)
    for i in (0, 2):
        np.testing.assert_array_equal(mixed[i], greedy[i])
    assert any(not np.array_equal(mixed[i], greedy[i]) for i in (1, 3))
    again = _tokens(_engine(world, prefill_chunk=chunk, seed=7).serve(_requests(True)))
    for i in range(4):
        np.testing.assert_array_equal(again[i], mixed[i])
    assert all(0 <= t < CFG.vocab_size for r in mixed.values() for t in r)


def test_engine_retire_resets_sampling_state(world):
    eng = _engine(world, seed=1)
    eng.serve(_requests(True))
    assert not eng._temp.any() and not eng._topk.any()


# ---------------------------------------------------------------------------
# Slot-cache misses loaded from a checkpoint pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_miss_loads_from_a_pool_either_package_wrote(world, tmp_path, writer):
    pool_cls = tckpt.CheckpointPool if writer == "port" else jckpt.CheckpointPool
    wpool = pool_cls(str(tmp_path))
    for aid, tree in world["adapters"].items():
        wpool.save_adapter(aid, tree, META)
    reqs = [ServeRequest(i, f"ad{i % 3}", p, max_new_tokens=4)
            for i, p in enumerate(_prompts(3, seed=6))]
    want = _tokens(_engine(world).serve(reqs))
    eng = _engine(world, publish=False, slot_capacity=2,
                  checkpoint_pool=tckpt.CheckpointPool(str(tmp_path)))
    stats = eng.serve(reqs)
    got = _tokens(stats)
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[i])
    assert stats.cache_misses == 3 and stats.cache_evictions == 1
    assert eng.slot_cache.ids() == ["ad1", "ad2"]


def test_miss_without_the_adapter_raises(world, tmp_path):
    pool = tckpt.CheckpointPool(str(tmp_path))
    pool.save_adapter("ad0", world["adapters"]["ad0"], META)
    cache = AdapterSlotCache(1, pool)
    tree, meta = cache.get("ad0")
    assert meta == META and cache.misses == 1 and "ad0" in cache
    for c in (cache, AdapterSlotCache(1)):
        with pytest.raises(KeyError, match="neither staged nor in the checkpoint pool"):
            c.get("nope")
    eng = _engine(world, publish=False, checkpoint_pool=pool)
    stats = eng.serve([ServeRequest(0, "nope", _prompts(1)[0], max_new_tokens=2),
                       ServeRequest(1, "ad0", _prompts(1)[0], max_new_tokens=2)])
    assert "neither staged nor" in stats.results[0].error
    assert stats.results[1].error is None and len(stats.results[1].tokens) == 2


def test_tune_then_serve_without_disk(world, tmp_path):
    """An adapter trained by the port serves from memory (no pool: a disk
    path would fail) the tokens it serves when loaded from a pool (the
    reference's ``test_tune_then_serve_without_disk``)."""
    cfgs = [LoraConfig(rank=RANK, alpha=ALPHA, learning_rate=1e-3, batch_size=1, seq_len=16)]
    meta = pack_meta(cfgs)
    lora0 = inject_adapter(bridge.to_numpy(lora_zeros(CFG, meta, torch.float32, "cpu")),
                           world["adapters"]["ad0"], 0)
    data = packed_batch_iterator(CFG, cfgs, seq=16, device="cpu")
    out = train_loop(world["base"], bridge.to_torch(lora0, "cpu"), CFG, meta, data, 1)
    trained = extract_adapter(out["lora"], 0)
    req = ServeRequest(0, "fresh", _prompts(1, seed=11)[0], max_new_tokens=4)
    eng = _engine(world, publish=False, rows=1)
    eng.publish("fresh", trained, META)
    direct = eng.serve([req])
    assert direct.cache_misses == 0
    pool = tckpt.CheckpointPool(str(tmp_path))
    pool.save_adapter("fresh", trained, META)
    via_pool = _engine(world, publish=False, rows=1, checkpoint_pool=pool).serve([req])
    np.testing.assert_array_equal(direct.results[0].tokens, via_pool.results[0].tokens)
    assert via_pool.cache_misses == 1


# ---------------------------------------------------------------------------
# ServeEngine as a Runner
# ---------------------------------------------------------------------------


class ScriptedExecutor:
    """A ``run_segment`` stand-in: no model, the runner's semantics only."""

    def __init__(self):
        self.calls = []
        self.lock = threading.Lock()

    def pack_template(self, cfg, configs, seed=0, device=None):
        return {}, None

    def run_segment(self, seg, configs_by_cid, total_steps, cfg, base, *, slice_, **kw):
        with self.lock:
            self.calls.append((seg.job_id, slice_.units))
        return JobRecord(ScheduledJob(seg.config_ids, seg.degree, seg.start, seg.end),
                         0.01 * (seg.job_id + 1), np.zeros(len(seg.config_ids)),
                         real_start=0.0, real_end=0.0)


def _segments(n, unit=lambda i: 0):
    return [JobSegment(job_id=i, config_ids=(i,), degree=1, start=float(i), end=i + 1.0,
                       start_steps=(0,), run_steps=2, done_ids=(i,), units=(unit(i),))
            for i in range(n)]


def _runner_engine(world):
    return _engine(world, publish=False, rows=1, smax=16, train_executor=ScriptedExecutor(),
                   device_pool=DevicePool(["fake0", "fake1"]))


def test_serve_engine_is_a_runner(world):
    """The reference's ``test_runner_conformance`` case for the engine."""
    eng = _runner_engine(world)
    assert isinstance(eng, Runner) and hasattr(eng.executor, "run_segment")
    assert eng.concurrent is True and eng.device_pool.total == 2
    cfgs = {i: LoraConfig(rank=8, alpha=8.0 * (i + 1)) for i in range(3)}
    res = eng.run(_segments(3, lambda i: i % 2), cfgs, {i: 2 for i in range(3)}, None, None,
                  seq=16)
    assert [r.job.config_ids for r in res.records] == [(0,), (1,), (2,)]
    assert eng.last_result is res and res.makespan >= 0.0
    assert eng.device_pool.free == 2
    assert sorted(j for j, _ in eng.executor.calls) == [0, 1, 2]
    # on the CPU the default pool is the engine's own device
    cpu = _engine(world, publish=False, rows=1, smax=16)
    assert cpu.device_pool.devices == [torch.device("cpu")] and cpu.concurrent is False


def test_serve_engine_run_respects_a_held_lease(world):
    """Training through ``run`` while ``serve_lease(1)`` holds the last
    unit: the held unit is no leak, and it stays held."""
    eng = _runner_engine(world)
    with eng.serve_lease(1) as sl:
        assert sl.units == (1,) and eng.device_pool.free == 1
        cfgs = {i: LoraConfig(rank=8, alpha=8.0) for i in range(2)}
        res = eng.run(_segments(2), cfgs, {0: 2, 1: 2}, None, None, seq=16)
        assert len(res.records) == 2 and eng.device_pool.free == 1
    assert eng.device_pool.free == 2
    with pytest.raises(ValueError):
        with eng.serve_lease(3):
            pass


def test_publish_from_packed_state_is_bit_exact(world, tmp_path):
    """A packed state the reference saved stages the leaves its own
    ``load_packed_state`` + ``extract_adapter`` give, bit for bit."""
    pool = jckpt.CheckpointPool(str(tmp_path))
    opt = tree_map(np.zeros_like, world["nlora"])
    pool.save_packed_state("t0", world["nlora"], {"m": opt, "v": opt}, {"steps_done": 1})
    eng = _engine(world, publish=False, rows=1, smax=16)
    eng.publish_from_packed_state(tckpt.CheckpointPool(str(tmp_path)), "t0", 1, "hot",
                                  rank=RANK, alpha=ALPHA)
    want_lora, _, _ = pool.load_packed_state("t0")
    want = j_extract(want_lora, 1)
    got, meta = eng.slot_cache.get("hot")
    pairs = _merged_pairs(got, want)
    assert len(pairs) == len(tree_leaves(got)) > 0
    for g, w in pairs:
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    assert meta == META


# ---------------------------------------------------------------------------
# merge_adapter / merge_model
# ---------------------------------------------------------------------------


def _j_merge(base, lora, scales, idx):
    """The reference's ``merge_model`` under one ``jax.jit`` (the scale a
    constant, as its eager call reads it), so JAX compiles once."""
    return jax.jit(lambda b, lo: j_merge_model(b, lo, scales, idx))(base, lora)


def _merged_pairs(got, want):
    """(port leaf, reference leaf) over both trees, structure checked."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        return [p for k in want for p in _merged_pairs(got[k], want[k])]
    return [(got, want)]


def _ulp_bf16(x):
    x = np.abs(x.astype(np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(x, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_model_matches_the_reference(world, dtype):
    tdt, ndt = (torch.float32, np.float32) if dtype == "float32" else (torch.bfloat16,
                                                                       ml_dtypes.bfloat16)
    base = tree_map(lambda t: t.to(tdt), world["base"])
    nbase = tree_map(lambda a: a.astype(ndt), world["nbase"])
    scales = np.asarray(world["scales"])
    got = merge_model(base, world["lora"], scales, 1)
    want = _j_merge(nbase, world["nlora"], scales, 1)
    n_merged = 0
    for g, w in _merged_pairs(got, want):
        w = np.asarray(w).astype(np.float32)
        g = g.float().numpy()
        assert g.shape == w.shape
        if dtype == "float32":
            assert np.abs(g - w).max() <= 1e-6 * max(np.abs(w).max(), 1e-30)
        else:
            assert (np.abs(g - w) <= _ulp_bf16(w)).all()
        n_merged += 1
    assert n_merged == len(tree_leaves(base))
    # merged leaves are new, the rest shared; the base's dtype kept
    blk = got["decoder"]["blocks"]["l0"]
    assert blk["attn"]["q"]["w"].dtype == tdt
    assert blk["attn"]["q"]["w"] is not base["decoder"]["blocks"]["l0"]["attn"]["q"]["w"]
    assert got["embed"]["w"] is base["embed"]["w"]


@pytest.mark.parametrize("lead", [(), (2,)], ids=["plain", "layer_stacked"])
def test_merge_adapter_plain_and_layer_stacked_packs(lead):
    rng = np.random.RandomState(8)
    w = rng.randn(*lead, 24, 40).astype(np.float32)
    lora = {"a": rng.randn(*lead, 3, 24, 4).astype(np.float32),
            "b": rng.randn(*lead, 3, 4, 40).astype(np.float32)}
    got = merge_adapter(torch.from_numpy(w), {k: torch.from_numpy(v) for k, v in lora.items()},
                        0.5, 2)
    want = np.asarray(j_merge_adapter(jnp.asarray(w), lora, 0.5, 2))
    assert got.shape == w.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_merge_model_on_a_quantized_base(world, mode):
    """A quantized W is dequantized, then merged: dense f32 leaves equal
    to the reference's on the same codes (the port's quantization is the
    reference's bit for bit: ``tests/test_torch_train_kernels.py``)."""
    qbase = quantize_base_params(world["base"], mode)
    scales = np.asarray(world["scales"])
    got = merge_model(qbase, world["lora"], scales, 0)
    want = _j_merge(bridge.to_numpy(qbase), world["nlora"], scales, 0)
    q = got["decoder"]["blocks"]["l0"]["attn"]["q"]["w"]
    assert is_quantized(qbase["decoder"]["blocks"]["l0"]["attn"]["q"]["w"])
    assert isinstance(q, torch.Tensor) and q.dtype == torch.float32
    for g, w in _merged_pairs(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy().astype(np.float32) - w.astype(np.float32)).max() \
            <= 1e-6 * max(np.abs(w.astype(np.float32)).max(), 1e-30)


def test_merged_base_forward_matches_the_adapter_path(world):
    """W + (alpha / r) A B served with no adapter == the adapter applied on
    the fly, within 5e-3 (the reference's ``test_merged_weights_match_
    adapter_path``)."""
    meta1 = pack_meta([LoraConfig(rank=RANK, alpha=ALPHA)])
    lora1 = bridge.to_torch(inject_adapter(bridge.to_numpy(lora_zeros(CFG, meta1, device="cpu")),
                                           world["adapters"]["ad2"], 0), "cpu")
    toks = {"tokens": torch.from_numpy(_prompts(1, lo=12, hi=13, seed=9)[0][None])}
    scales = meta1.scales("cpu")
    with torch.no_grad():
        h_adapter, _, _ = forward(world["base"], lora1, scales, toks, CFG)
        merged = merge_model(world["base"], lora1, scales, 0)
        h_merged, _, _ = forward(merged, {}, scales, toks, CFG)
        h_base, _, _ = forward(world["base"], None, scales, toks, CFG)
    np.testing.assert_allclose(h_merged.numpy(), h_adapter.numpy(), rtol=5e-3, atol=5e-3)
    assert float((h_adapter - h_base).abs().max()) > 1e-3  # the adapter moves the output
