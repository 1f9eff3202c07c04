"""The port's autotuner (``repro_torch.kernels.autotune``) against the JAX
package's (``repro.kernels.autotune``), on the CPU, and the launcher's
``--autotune-cache``, ``--trace-out`` and ``--metrics-out``.

With one shared fake ``measure_fn`` the two tuners write the same cache
JSON; a cache either writes loads in the other; the calibrated prior prices
the same packs at exactly the reference's ``iter_time``. On the CPU the
port times the plain fused path once (``blocks=None``), as the reference
does off the TPU; the K-split sweep of the card runs here only through an
explicit candidate list and a fake ``measure_fn``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced as j_reduced
from repro.kernels import autotune as jat
from repro.sched import cost_model as jcm
from repro.sched.profile import ObservationStore as JStore
from repro_torch.cluster import SliceExecutor
from repro_torch.configs import LoraConfig, get_config, reduced
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.obs import Tracer, validate_chrome_trace
from repro_torch.sched import cost_model as tcm
from repro_torch.sched.profile import ObservationStore

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(3, 200, 2048, 1000, 12), (1, 1, 1, 1, 1), (2, 1024, 3584, 3584, 16),
          (2, 1024, 3584, 18944, 16), (4, 4096, 3584, 512, 128)]


def _cfgs(mod_cfg, ranks, seq=512, bs=1):
    return [mod_cfg(rank=r, alpha=2.0 * r, learning_rate=1e-4, batch_size=bs, seq_len=seq)
            for r in ranks]


def _fake_measure(best=None, fused_t=1e-3, twopass_t=1.4e-3):
    """Deterministic measure_fn: candidate ``best`` (and None) is 2x faster
    than the rest; records its calls so cache hits are observable."""
    calls = []

    def measure(n, m, k, l, r, blocks, backend, twopass=True):
        calls.append((n, m, k, l, r, blocks, backend))
        fast = blocks is None if best is None else blocks is not None and tuple(blocks) == best
        return (fused_t if fast else 2 * fused_t), (twopass_t if twopass else None)

    measure.calls = calls
    return measure


@pytest.mark.parametrize("shape", SHAPES)
def test_bucket_flops_and_keys_equal_the_reference(shape):
    assert tat.shape_bucket(*shape) == jat.shape_bucket(*shape)
    assert tat.fused_flops(*shape) == jat.fused_flops(*shape)
    for backend in ("cpu", "cuda"):
        b = tat.shape_bucket(*shape)
        assert tat._bucket_key(backend, b) == jat._bucket_key(backend, b)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_model_shapes_equal_the_reference(fast, reduce):
    jcfg, tcfg = j_get_config("qwen25-7b"), get_config("qwen25-7b")
    if reduce:
        jcfg, tcfg = j_reduced(jcfg), reduced(tcfg)
    from repro.configs.base import LoraConfig as JLora

    for ranks, bs in (((8, 16), 2), ((12,), 1), ((8, 32, 128), 4)):
        assert tat.model_shapes(tcfg, _cfgs(LoraConfig, ranks, bs=bs), 512, fast=fast) == \
            jat.model_shapes(jcfg, _cfgs(JLora, ranks, bs=bs), 512, fast=fast)


def test_tune_writes_the_reference_cache_and_hits_it(tmp_path):
    """One fake measure_fn for both: the same JSON file, byte for byte; a
    second tune on the port's cache measures nothing and opens no span."""
    jm, tm = _fake_measure(), _fake_measure()
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    jp = jat.tune(SHAPES[:3], cache_path=str(jpath), backend="cpu", measure_fn=jm)
    tracer = Tracer()
    tp = tat.tune(SHAPES[:3], cache_path=str(tpath), backend="cpu", measure_fn=tm, tracer=tracer)
    assert tpath.read_text() == jpath.read_text()
    assert tp.to_json() == jp.to_json() and tm.calls == jm.calls
    spans = [s for s in tracer.spans() if s.name == "autotune.measure"]
    assert [s.args["shape"] for s in spans] == [list(s) for s in SHAPES[:3]]
    assert all(s.cat == "autotune" and s.args["blocks"] is None for s in spans)
    again = Tracer()
    tp2 = tat.tune(SHAPES[:3], cache_path=str(tpath), backend="cpu", measure_fn=tm, tracer=again)
    assert len(tm.calls) == 3 and again.spans() == [] and tp2.entries == tp.entries
    # a new shape merges into the file
    tat.tune(SHAPES[3:4], cache_path=str(tpath), backend="cpu", measure_fn=tm)
    assert len(json.loads(tpath.read_text())["entries"]) == 4
    assert tp.rate() == jp.rate() and tp.lora_speedup() == jp.lora_speedup() == \
        pytest.approx(1.4)


def test_caches_load_across_and_a_wrong_schema_raises(tmp_path):
    path = tmp_path / "ref.json"
    jat.tune(SHAPES[:2], cache_path=str(path), backend="cpu", measure_fn=_fake_measure())
    prof = tat.KernelProfile.load(str(path), backend="cpu")
    assert prof.entries == json.loads(path.read_text())["entries"]
    assert prof.entry(*SHAPES[0]) == jat.KernelProfile.load(str(path), backend="cpu").entry(
        *SHAPES[0])
    assert tat.KernelProfile.from_json({"schema": 1, "entries": {}}).backend == "cuda"
    for blob in ({"schema": 2, "entries": {}}, {"entries": {}}):
        with pytest.raises(ValueError, match="schema"):
            tat.KernelProfile.from_json(blob)
        with pytest.raises(ValueError, match="schema"):
            jat.KernelProfile.from_json(blob, backend="cpu")


def test_cuda_sweep_keeps_the_fastest_split():
    """On the "cuda" backend the sweep runs the plan's own choice first and
    then each candidate, one ``autotune.measure`` span each; the two-pass
    baseline is timed once per shape."""
    m = _fake_measure(best=(2,))
    tracer = Tracer()
    entry = tat.autotune_shape(2, 1024, 3584, 3584, 16, backend="cuda",
                               candidates=[(1,), (2,), (4,)], measure_fn=m, tracer=tracer)
    assert entry["blocks"] == [2] and entry["speedup_vs_twopass"] == pytest.approx(1.4)
    assert [c[5] for c in m.calls] == [None, (1,), (2,), (4,)]
    assert [s.args["blocks"] for s in tracer.spans()] == [None, [1], [2], [4]]
    assert all(s.args["seconds"] > 0 for s in tracer.spans())
    prof = tat.KernelProfile("cuda", {tat._bucket_key("cuda", tat.shape_bucket(
        2, 1024, 3584, 3584, 16)): entry})
    assert prof.best_blocks(2, 1000, 3584, 3584, 16) == (2,)
    assert prof.best_blocks(2, 1024, 3584, 512, 16) is None  # another bucket
    won_by_plan = tat.autotune_shape(2, 1024, 3584, 3584, 16, backend="cuda",
                                     candidates=[(1,)], measure_fn=_fake_measure())
    assert won_by_plan["blocks"] is None


@pytest.mark.parametrize("hw", ["A100_40G", "TPU_V5E"])
def test_calibrated_prior_prices_packs_as_the_reference(hw):
    """``calibrate`` sets ragged accounting and the measured LoRA rate on a
    copy: the same ``iter_time`` as the reference's, exactly."""
    from repro.configs.base import LoraConfig as JLora

    entries = {"cpu|4,256,2048,2048,64": {"speedup_vs_twopass": 1.37, "flops_per_s": 1e12},
               "cpu|2,1024,4096,4096,16": {"speedup_vs_twopass": 0.91, "flops_per_s": 2e12},
               "cpu|1,512,4096,4096,8": {"speedup_vs_twopass": 1.12, "flops_per_s": 3e12}}
    jprof, tprof = jat.KernelProfile("cpu", dict(entries)), tat.KernelProfile("cpu", dict(entries))
    jprior = jcm.CostModel(j_get_config("qwen25-7b"), getattr(jcm, hw))
    tprior = tcm.CostModel(get_config("qwen25-7b"), getattr(tcm, hw), **tcm.REFERENCE_MEMORY)
    jcal, tcal = jprof.calibrate(jprior), tprof.calibrate(tprior)
    assert tcal.ragged and tcal.lora_rate_scale == jcal.lora_rate_scale == 1.12
    assert not tprior.ragged and tprior.lora_rate_scale == 1.0
    for ranks, bs, seq, d in (((8, 128), 1, 512, 1), ((16, 16, 32), 2, 1024, 2),
                              ((64,), 4, 128, 1), ((8, 16), 2, 512, 4)):
        jc, tc = _cfgs(JLora, ranks, seq, bs), _cfgs(LoraConfig, ranks, seq, bs)
        assert tcal.iter_time(tc, d, seq) == jcal.iter_time(jc, d, seq)
        assert tprior.iter_time(tc, d, seq) == jprior.iter_time(jc, d, seq)
    assert dataclasses.replace(tcal, ragged=False, lora_rate_scale=1.0) == tprior


def test_seed_observations_fill_the_reference_store():
    from repro.configs.base import LoraConfig as JLora

    entries = {"cpu|2,1024,4096,4096,16": {"speedup_vs_twopass": 1.25}}
    jprior = jcm.CostModel(j_get_config("qwen25-7b"), jcm.A100_40G)
    tprior = tcm.CostModel(get_config("qwen25-7b"), tcm.A100_40G, **tcm.REFERENCE_MEMORY)
    packs = [((8, 16), 2, 512, 1), ((32,), 1, 1024, 2)]
    jstore, tstore = JStore(), ObservationStore()
    jat.KernelProfile("cpu", dict(entries)).seed_observations(
        jstore, jprior, [(_cfgs(JLora, r, s, b), d, s) for r, b, s, d in packs])
    tat.KernelProfile("cpu", dict(entries)).seed_observations(
        tstore, tprior, [(_cfgs(LoraConfig, r, s, b), d, s) for r, b, s, d in packs])
    assert tstore.to_json() == jstore.to_json() and len(tstore) == 2


def test_default_measure_on_the_cpu_times_the_plain_paths():
    """Off the card: one candidate (the plan's own, blocks=None), timed on
    the plain fused formulation against the plain two-pass."""
    tracer = Tracer()
    entry = tat.autotune_shape(2, 16, 64, 48, 8, backend="cpu", tracer=tracer)
    assert entry["blocks"] is None and entry["seconds"] > 0 and entry["speedup_vs_twopass"] > 0
    assert [s.args["blocks"] for s in tracer.spans()] == [None]
    fused, two = tat._default_measure(2, 16, 64, 48, 8, None, "cpu")
    assert fused > 0 and two > 0
    assert tat._default_measure(2, 16, 64, 48, 8, None, "cpu", twopass=False)[1] is None


def test_blocks_reach_the_fused_op_and_the_executor_key():
    """The K-split override goes through ``fused_lora_linear`` (ignored by
    the plain versions on the CPU: no K split) and separates the executor's
    step cache."""
    x, w, a, b = (torch.from_numpy(np.random.default_rng(0).standard_normal(s).astype(np.float32))
                  for s in ((2, 6, 32), (32, 24), (2, 32, 8), (2, 8, 24)))
    al = torch.tensor([0.5, 2.0])
    want = ops.fused_lora_linear(x, w, a, b, al, impl="fused")
    assert torch.equal(ops.fused_lora_linear(x, w, a, b, al, impl="fused", blocks=(3,)), want)
    assert ops.KernelConfig(blocks=(2,)) != ops.KernelConfig()
    cfg = reduced(get_config("qwen25-7b"))
    ex = SliceExecutor()
    ex.step_fn(cfg, 2, impl="fused")
    ex.step_fn(cfg, 2, impl="fused", blocks=(2,))
    ex.step_fn(cfg, 2, impl="fused", blocks=[2])
    ex.step_fn(cfg, 2, impl="fused", blocks=(4,))
    assert (ex.n_builds, ex.n_hits) == (3, 1)


def test_launcher_autotunes_traces_and_exports_metrics(tmp_path, capsys):
    """``--autotune-cache`` switches to the fused tier, writes the cache and
    calibrates the prior; ``--trace-out`` passes ``scripts/check_trace.py
    --min-tiers 2`` (autotune and executor spans) and ``--metrics-out``
    holds the executor's build count. ``--impl plain`` is refused."""
    c, t, m = tmp_path / "c.json", tmp_path / "t.json", tmp_path / "m.json"
    args = ["--reduced", "--device", "cpu", "--steps", "2", "--seq", "16", "--log-every", "0"]
    per = launch_train.main(args + ["--autotune-cache", str(c), "--trace-out", str(t),
                                    "--metrics-out", str(m)])
    out = capsys.readouterr().out
    assert np.isfinite(per).all() and "running the fused tier" in out
    assert "prior, autotuned" in out
    cache = json.loads(c.read_text())
    assert cache["schema"] == 1 and list(cache["entries"]) == ["cpu|2,16,256,256,16"]
    trace = json.loads(t.read_text())
    assert validate_chrome_trace(trace) == []
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"autotune.measure", "executor.train"} <= names
    assert json.loads(m.read_text())["counters"]["executor.compile_cache_builds"] == 1
    check = subprocess.run([sys.executable, str(ROOT / "scripts" / "check_trace.py"), str(t),
                            "--min-tiers", "2"], capture_output=True, text=True, timeout=120,
                           env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert check.returncode == 0, check.stdout + check.stderr
    # a cache hit: the same file, no measurement span in the new trace
    launch_train.main(args + ["--autotune-cache", str(c), "--trace-out", str(t)])
    assert "autotune.measure" not in {e["name"] for e in json.loads(t.read_text())["traceEvents"]}
    for bad in ("plain", "pallas"):
        with pytest.raises(SystemExit):
            launch_train.parse_args(args + ["--autotune-cache", str(c), "--impl", bad])
    assert launch_train.parse_args(args + ["--autotune-cache", str(c), "--impl",
                                           "fused_plain"]).impl == "fused_plain"
    assert set(launch_train.NOT_PORTED) == {
        "--mesh", "--hosts", "--devices-per-host", "--host-classes", "--heartbeat",
        "--drain-after", "--join-after", "--fsdp", "--seq-parallel"}
