"""Micro-benchmark autotuner for the fused LoRA kernel (the port of
``repro/kernels/autotune.py``, with its names and cache schema).

It works in both directions, as the reference's does:

  * **downward** — sweep the fused kernel's free choice per ``(backend,
    shape bucket)``, time each candidate with the kernel's own entry point,
    and persist the winner and its achieved FLOP/s in a JSON cache so
    repeated runs (and other processes) skip the sweep;
  * **upward** — feed the *measured* rates into the scheduling stack:
    ``KernelProfile.calibrate`` returns a copy of a
    :class:`~repro_torch.sched.cost_model.CostModel` prior whose LoRA
    compute term runs at the measured fused-vs-two-pass speedup and whose
    FLOP accounting is ragged (each adapter billed at its own rank, as the
    kernels run ragged same-rank segments), and ``seed_observations``
    writes fused-rate predictions into an
    :class:`~repro_torch.sched.profile.ObservationStore`.

Backend semantics: the backend is the device's type, ``"cuda"`` or
``"cpu"``; entry points run on CUDA unless ``device=`` says otherwise. On
CUDA the free choice is the count of K ranges the fused kernel's plan
splits its base product into (``csrc/fused.cuh``'s ``make_plan``: its
tiles are template constants). The sweep asks the plan's path at the shape
for each count of :data:`SPLIT_GRID` (the plan clamps each: "wgmma" to
``MAX_SPLITS``, "ffma" to 4, both to at least 4 K steps a range), keeps the
distinct counts other than the one the plan picks itself, and times them
after the plan's own choice (``blocks=None``) with CUDA events; a candidate
is stored as ``"blocks": [k_splits]``, and an entry keeps ``None`` unless
another count was faster. The two-pass baseline is the backend's own
unfused tier, ``x @ W`` plus ``packed_lora_delta`` (kernel #1 twice). On
the CPU the tuner times the plain fused formulation against the plain
two-pass, one candidate, ``blocks=None``, as the reference does off the
TPU. ``measure_fn`` is injectable for tests.

Cache format (one JSON file can hold several backends)::

    {"schema": 1, "entries": {"cuda|2,1024,4096,4096,16": {
        "blocks": [2], "seconds": ..., "flops_per_s": ...,
        "speedup_vs_twopass": ..., "n": 2, "m": 1024, "k": 3584,
        "l": 3584, "r": 16}}}
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.obs import NULL_TRACER

_SCHEMA = 1

# K-range counts the sweep asks of each path of the fused plan (each
# clamped as the plan clamps); the paths with no K choice ("decode",
# "split3") have no candidates besides the plan's own
SPLIT_GRID = {"wgmma": (1, 2, 4, 8), "ffma": (1, 2, 3, 4)}


def _pow2(v: int) -> int:
    return 1 << max(0, int(v - 1).bit_length())


def shape_bucket(n: int, m: int, k: int, l: int, r: int) -> Tuple[int, ...]:
    """Power-of-two bucketing: nearby shapes share a tuned entry."""
    return (_pow2(n), _pow2(m), _pow2(k), _pow2(l), max(8, _pow2(r)))


def fused_flops(n: int, m: int, k: int, l: int, r: int) -> float:
    """FLOPs of one fused forward: base GEMM + delta at rank r."""
    return 2.0 * n * m * (k * l + r * (k + l))


def _bucket_key(backend: str, bucket: Tuple[int, ...]) -> str:
    return f"{backend}|" + ",".join(str(v) for v in bucket)


# calls a CUDA timing window holds: back to back, so the device never
# waits for the host's launches (a window of one call would count the
# launch gap, some tens of µs, against calls of 0.2-7 ms)
CUDA_CALLS = 10


def measure(fn: Callable, *args, iters: int = 3) -> float:
    """Best-of-``iters`` steady-state seconds of ``fn(*args)``, after one
    warm-up call (which builds the kernel and its plan). When an argument
    is a CUDA tensor each of the ``iters`` timings is a window of
    :data:`CUDA_CALLS` calls between CUDA events on the current stream of
    its device, divided by their count; else one call under
    ``time.perf_counter``."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    if dev is None or dev.type != "cuda":
        fn(*args)
        best = math.inf
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*args)
            best = min(best, time.perf_counter() - t0)
        return best
    with torch.cuda.device(dev):
        fn(*args)
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        best = math.inf
        for _ in range(iters):
            start.record()
            for _ in range(CUDA_CALLS):
                fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / CUDA_CALLS)
    return best


@dataclass
class KernelProfile:
    """Autotune results + the hooks that feed them into planning."""

    backend: str
    entries: Dict[str, Dict] = field(default_factory=dict)

    # ---------------- lookups ----------------

    def entry(self, n: int, m: int, k: int, l: int, r: int) -> Optional[Dict]:
        return self.entries.get(
            _bucket_key(self.backend, shape_bucket(n, m, k, l, r))
        )

    def best_blocks(self, n: int, m: int, k: int, l: int, r: int) -> Optional[Tuple[int, ...]]:
        """The tuned ``blocks`` of this shape's bucket (on CUDA
        ``(k_splits,)``), or None: the plan's own choice, or not tuned."""
        e = self.entry(n, m, k, l, r)
        if e is None or e.get("blocks") is None:
            return None
        return tuple(e["blocks"])

    def rate(self) -> Optional[float]:
        """Median measured fused FLOP/s across this backend's entries."""
        rates = sorted(
            e["flops_per_s"]
            for k, e in self.entries.items()
            if k.startswith(self.backend + "|") and e.get("flops_per_s")
        )
        if not rates:
            return None
        return rates[len(rates) // 2]

    def lora_speedup(self) -> float:
        """Median measured fused-vs-two-pass speedup (>= 1 when fusing
        wins); 1.0 before any measurement. The calibration uses this ratio,
        not an absolute rate."""
        sp = sorted(
            e["speedup_vs_twopass"]
            for k, e in self.entries.items()
            if k.startswith(self.backend + "|")
            and e.get("speedup_vs_twopass")
        )
        if not sp:
            return 1.0
        return sp[len(sp) // 2]

    # ---------------- planner feedback ----------------

    def calibrate(self, prior):
        """A copy of the analytic prior that prices LoRA work at the
        measured fused-kernel rate and bills ragged (per-adapter-rank)
        FLOPs, what the kernels compute."""
        return dataclasses.replace(
            prior, ragged=True, lora_rate_scale=max(self.lora_speedup(), 1e-9)
        )

    def seed_observations(self, store, prior, packs: Sequence[Tuple]) -> None:
        """Write fused-rate iteration-time predictions into an
        ObservationStore: ``packs`` is an iterable of ``(configs, degree,
        seq)``, each recorded as one observation (measured = the calibrated
        prediction, predicted = the raw prior), so a ProfiledCostModel
        planner prices those pack shapes at fused-kernel rates before the
        first real segment runs."""
        from repro_torch.sched.profile import obs_key

        cal = self.calibrate(prior)
        for configs, d, seq in packs:
            store.update(
                obs_key(prior.cfg.name, configs, d, seq),
                cal.iter_time(configs, d, seq),
                prior.iter_time(configs, d, seq),
            )

    # ---------------- persistence ----------------

    def to_json(self) -> Dict:
        return {"schema": _SCHEMA, "entries": self.entries}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, blob: Dict, backend: Optional[str] = None) -> "KernelProfile":
        if blob.get("schema") != _SCHEMA:
            raise ValueError(f"unknown autotune schema {blob.get('schema')!r}")
        return cls(backend=backend or "cuda", entries=dict(blob.get("entries", {})))

    @classmethod
    def load(cls, path: str, backend: Optional[str] = None) -> "KernelProfile":
        with open(path) as f:
            return cls.from_json(json.load(f), backend=backend)


def operands(n: int, m: int, k: int, l: int, r: int, dtype=torch.float32, device=None):
    """(x, W, A, B, alpha) of one fused call at this shape, drawn from a
    fixed seed on ``device``: x (n, m, k), W (k, l), A (n, k, r), B (n, r,
    l) in ``dtype``, alpha (n,) f32 ones."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    return (rnd((n, m, k), 1.0), rnd((k, l), 0.02), rnd((n, k, r), 0.02), rnd((n, r, l), 0.02),
            torch.ones((n,), dtype=torch.float32, device=dev))


def k_split_candidates(n: int, m: int, k: int, l: int, r: int,
                       dtype=torch.float32) -> List[Tuple[int]]:
    """The CUDA sweep's candidates at this shape besides the plan's own
    choice: ``(k_splits,)`` for each distinct count of K ranges the plan's
    path takes when asked for the counts of :data:`SPLIT_GRID` (operands
    16-byte aligned, W row-major), but the count the plan picks itself,
    which the sweep times as ``blocks=None``; none on a path without that
    choice."""
    from repro_torch.kernels.fused import PATHS, _plan_info
    from repro_torch.kernels.packed_matmul import DTYPE_CODES

    code = DTYPE_CODES[dtype]
    path, _, own = _plan_info("fused", n, m, k, l, r, code, 1, 1)
    seen: List[Tuple[int]] = []
    for s in SPLIT_GRID.get(PATHS[path], ()):
        got = _plan_info("fused", n, m, k, l, r, code, 1, 1, 0, s)[2]
        if got != own and (got,) not in seen:
            seen.append((got,))
    return seen


def _default_measure(
    n, m, k, l, r, blocks, backend, twopass: bool = True, *, dtype=torch.float32, device=None,
) -> Tuple[float, Optional[float]]:
    """(fused_seconds, twopass_seconds|None) for one shape / candidate.

    On CUDA the fused tier is ``fused_lora_linear`` with impl "fused"
    (kernel #2 on its plan's path, K split as ``blocks`` asks) and the
    two-pass baseline the backend's own unfused tier, ``x @ W`` plus
    ``packed_lora_delta`` with impl "auto" (kernel #1 twice): the ratio that
    calibrates the cost model compares against what the backend would run.
    On the CPU both are the plain versions. ``twopass=False`` skips the
    baseline (it does not depend on ``blocks``, so the sweep measures it
    once per shape). Forward only, under ``torch.no_grad``."""
    from repro_torch.kernels.ops import fused_lora_linear, packed_lora_delta

    dev = resolve_device(device if device is not None else backend)
    on_cuda = dev.type == "cuda"
    x, w, a, b, alpha = operands(n, m, k, l, r, dtype, dev)
    with torch.no_grad():
        fused_impl = "fused" if on_cuda else "fused_plain"
        fused_t = measure(
            lambda x, w, a, b, al: fused_lora_linear(x, w, a, b, al, impl=fused_impl,
                                                     blocks=blocks),
            x, w, a, b, alpha)
        if not twopass:
            return fused_t, None
        two_impl = "auto" if on_cuda else "plain"
        twopass_t = measure(
            lambda x, w, a, b, al: x @ w + packed_lora_delta(x, a, b, al, impl=two_impl),
            x, w, a, b, alpha)
    return fused_t, twopass_t


def _backend(backend: Optional[str], device) -> str:
    return backend or resolve_device(device).type


def autotune_shape(
    n: int,
    m: int,
    k: int,
    l: int,
    r: int,
    *,
    backend: Optional[str] = None,
    candidates: Optional[Sequence[Tuple[int, ...]]] = None,
    measure_fn: Optional[Callable] = None,
    tracer=None,
    device=None,
    dtype=torch.float32,
) -> Dict:
    """Tune one shape: on CUDA sweep the plan's own choice and
    ``candidates`` (default: :func:`k_split_candidates` at this shape and
    ``dtype``), elsewhere time the plain fused path once; returns the cache
    entry dict. ``measure_fn(n, m, k, l, r, blocks, backend, twopass=)``
    replaces :func:`_default_measure` (which runs on ``device`` in
    ``dtype``)."""
    tracer = tracer if tracer is not None else NULL_TRACER
    backend = _backend(backend, device)
    if measure_fn is None:
        measure_fn = functools.partial(_default_measure, dtype=dtype, device=device)
    sweep: List[Optional[Tuple[int, ...]]] = [None]
    if backend == "cuda":
        sweep += list(candidates if candidates is not None
                      else k_split_candidates(n, m, k, l, r, dtype))
    best_blocks, best_t, tp_t = None, float("inf"), float("inf")
    for i, blocks in enumerate(sweep):
        # the two-pass baseline is blocks-independent: time it once per
        # shape (first candidate), not once per candidate
        with tracer.span(
            "autotune.measure", cat="autotune", track="autotune",
            shape=[n, m, k, l, r],
            blocks=list(blocks) if blocks else None,
        ) as msp:
            fused_t, twopass_t = measure_fn(
                n, m, k, l, r, blocks, backend, twopass=(i == 0)
            )
            if tracer.enabled:
                msp.args["seconds"] = fused_t
        if twopass_t is not None:
            tp_t = min(tp_t, twopass_t)
        if fused_t < best_t:
            best_t, best_blocks = fused_t, blocks
    return {
        "n": n, "m": m, "k": k, "l": l, "r": r,
        "blocks": list(best_blocks) if best_blocks else None,
        "seconds": best_t,
        "flops_per_s": fused_flops(n, m, k, l, r) / max(best_t, 1e-12),
        "speedup_vs_twopass": tp_t / max(best_t, 1e-12),
    }


def tune(
    shapes: Sequence[Tuple[int, int, int, int, int]],
    *,
    cache_path: Optional[str] = None,
    backend: Optional[str] = None,
    force: bool = False,
    candidates: Optional[Sequence[Tuple[int, ...]]] = None,
    measure_fn: Optional[Callable] = None,
    tracer=None,
    device=None,
    dtype=torch.float32,
) -> KernelProfile:
    """Tune every ``(n, m, k, l, r)`` shape not already in the cache; merge
    into (and re-save) ``cache_path`` when given."""
    backend = _backend(backend, device)
    profile = KernelProfile(backend=backend)
    if cache_path and os.path.exists(cache_path):
        profile = KernelProfile.load(cache_path, backend=backend)
    dirty = False
    for n, m, k, l, r in shapes:
        key = _bucket_key(backend, shape_bucket(n, m, k, l, r))
        if not force and key in profile.entries:
            continue
        profile.entries[key] = autotune_shape(
            n, m, k, l, r,
            backend=backend, candidates=candidates, measure_fn=measure_fn,
            tracer=tracer, device=device, dtype=dtype,
        )
        dirty = True
    if cache_path and dirty:
        profile.save(cache_path)
    return profile


def model_shapes(cfg, configs, seq: int, *, fast: bool = True):
    """Representative fused-kernel shapes of one pack on one model: the
    attention d_model x d_model projection and (full mode) the d_model x
    d_ff MLP projection, at the pack's width / bucket rank / per-adapter
    token count."""
    n = max(1, len(configs))
    m = max((c.batch_size for c in configs), default=1) * seq
    r = max(8, (max((c.rank for c in configs), default=8) + 7) // 8 * 8)
    shapes = [(n, m, cfg.d_model, cfg.d_model, r)]
    if not fast:
        shapes.append((n, m, cfg.d_model, cfg.d_ff, r))
    return shapes


def tune_for_model(
    cfg,
    configs,
    *,
    seq: int,
    cache_path: Optional[str] = None,
    fast: bool = True,
    measure_fn: Optional[Callable] = None,
    tracer=None,
    device=None,
    dtype=torch.float32,
) -> KernelProfile:
    """Launcher hook: tune this pack's representative projection shapes."""
    return tune(
        model_shapes(cfg, configs, seq, fast=fast),
        cache_path=cache_path,
        measure_fn=measure_fn,
        tracer=tracer,
        device=device,
        dtype=dtype,
    )
