"""Slice executor: packed train steps placed on device slices, one CUDA graph
per step shape (the port of ``repro/cluster/executor.py``).

The reference caches one jitted packed step per (model config, pack width,
slice shape); the step (``train.trainer.make_packed_step``) takes the
per-adapter vectors -- scales, learning rates, step budgets -- as runtime
arguments, so same-shape packs share one compile. The port's cache unit on
a CUDA slice is one ``torch.cuda.CUDAGraph`` of the whole step (forward,
backward and AdamW) with its static buffers: the LoRA tree, the optimizer
state, the batch and the three vectors. Before the replays of a pack, its
vectors and initial state are copied into those buffers; before each
replay, its batch. The captured step updates the state buffers in place
(``make_packed_step(in_place=True)``: the eager step's arithmetic, so its
bits, without a second copy of the state), so each replay is one step. One
capture then serves every pack of that shape, as one compile does in the
reference. The graph reads the base in place, so the base's leaves are part
of the key and the entry holds them. A graph launches its kernels on each
replay, so each replay adds the launches it recorded to the kernels' counts
(``repro_torch.kernels.launches``).

A capture that fails raises; nothing falls back to eager. ``capture=False``
is the explicit eager choice, and on a CPU slice the step is always eager.
Each graph holds a private memory pool (what the step allocates:
activations, the cross-entropy's logits, gradients, AdamW's temporaries of
one leaf) besides its buffers; the cache keeps at most ``MAX_GRAPHS``
graphs per device and drops that device's least recently used one (and
returns its memory to the device) before a new capture, so a sweep over
many shapes holds a bounded number of pools. A pack whose shape no cached
graph has drops it before anything of the pack is made on the device (its
LoRA template, its state), so a pack's peak never holds an older shape's
graph; ``PackResult.peak_bytes`` is the whole call's high-water mark. The
templates are drawn without a base (``init_lora``). Before it allocates the
buffers, and again before the capture, the executor checks what the step
needs (the buffers; then the transient peak of the eager warm-up step, which
the graph's pool will hold) against the device's free memory, and raises
``torch.OutOfMemoryError`` with the numbers. ``captures`` records each
capture's pool and buffer bytes and the warm-up's transient bytes.

Each pack runs with its slice's device current. A base that does not lie on
that device is copied there once per device and kept (``clear`` drops the
copies); every segment on that device then reads the one copy. Captures
run one at a time across threads, in the thread-local capture mode, while
the other slices go on stepping.

Batches are pre-generated and placed in bounded chunks (``PREGEN_CHUNK``)
ahead of the step stream, as in the reference: host-side data synthesis
holds the GIL, and interleaving it step by step serialises concurrently
dispatched segments.

Only width-1 slices run: a wider slice needs sharded execution, which the
port does not have yet, and raises.
"""
from __future__ import annotations

import contextlib
import gc
import inspect
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bridge import to_torch
from repro_torch.cluster.pool import MeshSlice
from repro_torch.configs.base import LoraConfig, ModelConfig
from repro_torch.core.adapter import PackMeta, pack_meta
from repro_torch.core.packed_lora import extract_adapter, inject_adapter
from repro_torch.kernels import launches
from repro_torch.obs import NULL_TRACER
from repro_torch.train.optimizer import init_opt_state
from repro_torch.tree import tree_leaves, tree_map

# per-adapter step cap meaning "no budget": larger than any real step count,
# so the budget mask stays 1 and the update equals an unbudgeted AdamW step
NO_BUDGET = np.int32(2**31 - 1)

# batches pre-generated and placed per refill
PREGEN_CHUNK = 256

# eager steps run on a side stream before a capture: they make what the
# step builds on its first call (kernel libraries, plans, ragged index
# tensors, cuBLAS handles), which a capture cannot do
WARMUP_STEPS = 1

# held from an eviction through its capture, by one thread at a time: a
# capture on one card and another thread's ``empty_cache`` (which frees
# every card's cached blocks) must not overlap
_CAPTURING = threading.Lock()

# captured graphs the cache keeps per device (least recently used dropped
# first): at full qwen25-7b width one graph holds 20-47 GB of buffers and
# pool, so one card holds one (PERF.md, the sweep phase's graph pool bytes)
MAX_GRAPHS = 1


def _slice_track(slice_: Optional[MeshSlice]) -> str:
    """Trace track name for a slice: one row per device unit group."""
    if slice_ is None or not slice_.units:
        return "device"
    if len(slice_.units) == 1:
        return f"unit{slice_.units[0]}"
    return f"units{min(slice_.units)}-{max(slice_.units)}"


def _accepts_start_steps(fn) -> bool:
    """Whether a custom data_iter_fn can take per-adapter stream offsets."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return "start_steps" in params or any(
        p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()
    )


def _tensors(tree):
    """A tree of torch tensors (kept where they lie) or numpy arrays (as
    CPU tensors, bf16 included)."""
    return tree_map(lambda t: t if isinstance(t, torch.Tensor) else to_torch(t, "cpu"), tree)


def _signature(tree) -> Tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tree_leaves(tree))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _copy_tree(dst, src) -> None:
    tree_map(lambda d, s: d.copy_(s), dst, src)


def _gb(n: float) -> str:
    return f"{n / 1e9:.2f} GB"


def _check_fits(need: int, device, what: str,
                hint: str = "train a narrower pack, or fewer rows per adapter") -> None:
    """Raise ``torch.OutOfMemoryError`` with the numbers, and ``hint``, when
    ``need`` bytes exceed what ``device`` has free: the CUDA driver's free memory
    plus the blocks the allocator caches but does not use."""
    free, total = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    if need > free:
        raise torch.OutOfMemoryError(
            f"{what} needs {_gb(need)} on {device}, which has {_gb(free)} free of "
            f"{_gb(total)}: {hint}")


@contextlib.contextmanager
def _no_collection():
    """No cycle collection in the block, after one just before it: a graph
    that only a reference cycle still holds (an old executor in a caught
    exception's frames) is destroyed then, not in the middle of a capture,
    where destroying a graph invalidates the capture."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _on_device(dev):
    """``dev`` as the current CUDA device for the block (nothing on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


@dataclass
class PackResult:
    """Final state of one packed training run on a slice.

    On a captured slice ``lora`` and ``opt`` are the graph's state buffers:
    they hold this run's result until the next ``train_pack`` of the same
    shape on the same executor; clone what must outlive that."""

    lora: Any
    opt: Any
    losses: Optional[np.ndarray]  # final per-adapter losses (None if 0 steps)
    wall_seconds: float  # steady-state loop time (capture excluded)
    real_start: float = 0.0  # absolute perf_counter timestamps of the
    real_end: float = 0.0  # placed+timed region (overlap accounting)
    # peak allocated bytes on the slice's CUDA device over the whole call
    # (its peak statistics are reset when the call starts, after the graphs
    # that cannot serve it are dropped); None on the CPU
    peak_bytes: Optional[int] = None
    # whether this call captured its step's graph (a cache miss)
    captured: bool = False


class _CapturedStep:
    """One CUDA graph of a packed train step and its static buffers."""

    def __init__(self, step: Callable, base, lora, opt, batch, vecs, n_pack: int, device,
                 shape: Tuple):
        self.shape = shape  # the pack shape it serves (``SliceExecutor._pack_shape``)
        rows, seq = batch["tokens"].shape
        what = f"the captured step of a pack of {n_pack} ({rows} rows of {seq} tokens)"
        # the LoRA tree, its two Adam moments, the batch
        _check_fits(3 * _nbytes(lora) + _nbytes(batch), device, f"{what}: its buffers")
        self.base = base  # the graph reads it in place: keep it alive
        self.lora = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), lora)
        self.opt = init_opt_state(self.lora, n_pack=n_pack)
        self.batch = {k: torch.empty_like(v, device=device) for k, v in batch.items()}
        self.vecs = tuple(torch.empty_like(v, device=device) for v in vecs)
        self.static_bytes = sum(_nbytes(t) for t in (self.lora, self.opt, self.batch,
                                                      dict(enumerate(self.vecs))))
        self.lock = threading.Lock()
        self.set_batch(batch)
        self.load(lora, opt, vecs)
        # warm-up and capture on a stream of the slice's device (the
        # default capture stream lies on the device of a process's first
        # capture)
        stream = torch.cuda.Stream(device)
        self.transient_bytes = self._warm_up(step, device, stream, what)
        self.load(lora, opt, vecs)  # the warm-up stepped the buffers
        _check_fits(self.transient_bytes, device, f"{what}: its graph's memory pool")
        reserved = torch.cuda.memory_reserved(device)
        self.graph = torch.cuda.CUDAGraph()
        # "thread_local": other threads' slices go on launching and
        # allocating while this thread captures
        with _no_collection(), launches.recorded() as self.launches, torch.cuda.graph(
                self.graph, stream=stream, capture_error_mode="thread_local"):
            _, _, m = step(base, self.lora, self.opt, self.batch, *self.vecs)
        self.metrics = {"loss": m["loss"], "per_adapter_loss": m["per_adapter_loss"]}
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def _warm_up(self, step, device, side, what: str) -> int:
        """Eager steps on the side stream ``side``; then the blocks they
        cached go back to the device, so the capture's pool can take them.
        Returns the steps' transient peak: allocated bytes above what was
        allocated before them."""
        held = torch.cuda.memory_allocated(device)
        side.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    step(self.base, self.lora, self.opt, self.batch, *self.vecs)
        except torch.OutOfMemoryError as e:
            raise torch.OutOfMemoryError(f"{what}: its eager warm-up step ran out of memory "
                                         f"on {device}: {e}") from e
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        return torch.cuda.max_memory_allocated(device) - held

    def load(self, lora, opt, vecs) -> None:
        """A pack's initial state (``opt=None``: fresh) and vectors."""
        _copy_tree(self.lora, lora)
        if opt is None:
            tree_map(torch.Tensor.zero_, self.opt)
        else:
            _copy_tree(self.opt, opt)
        for dst, src in zip(self.vecs, vecs):
            dst.copy_(src)

    def set_batch(self, batch) -> None:
        for k, v in batch.items():
            self.batch[k].copy_(v)

    def __call__(self, batch):
        """One step: the batch into its buffers, then a replay."""
        self.set_batch(batch)
        self.graph.replay()
        launches.add(self.launches)
        return self.metrics


class SliceExecutor:
    """Packed-step execution on device slices, one cached step per shape
    (thread-safe).

    ``capture``: on a CUDA slice, run each step shape as one captured CUDA
    graph (default) or eagerly (``False``). ``lora_init``:
    ``lora_init(cfg, meta, seed)`` -> a LoRA tree (torch or numpy leaves)
    in place of the port's ``init_model`` (a test hands it the reference's
    initialisation)."""

    def __init__(self, *, capture: bool = True, lora_init: Optional[Callable] = None,
                 tracer=None):
        self.capture = capture
        self.lora_init = lora_init
        self._steps: Dict[Tuple, Callable] = {}
        self._graphs: "OrderedDict[Tuple, _CapturedStep]" = OrderedDict()
        self._templates: Dict[Tuple, Any] = {}
        self._bases: Dict[Tuple, Tuple[Any, Any]] = {}  # (id, device) -> (base, its copy)
        self._lock = threading.Lock()
        self.n_builds = 0
        self.n_hits = 0
        self.captures: List[Dict[str, Any]] = []
        self.tracer = tracer if tracer is not None else NULL_TRACER

    # ---------------- pack-state templates ----------------

    def _lora_template(self, cfg: ModelConfig, meta: PackMeta, seed: int, device):
        """The pack's initial LoRA tree on the host, cached: it depends only
        on (config, ranks, seed) and on the device type whose generator drew
        it. Callers get the cached leaves; placement copies them."""
        device = resolve_device(device)
        key = (cfg, meta.ranks, seed, device.type)
        with self._lock:
            hit = self._templates.get(key)
        if hit is None:
            if self.lora_init is not None:
                lora = self.lora_init(cfg, meta, seed)
            else:
                from repro_torch.models.model import init_lora

                lora = init_lora(seed, cfg, meta, device=device)
            hit = tree_map(lambda t: t.detach().to("cpu"), _tensors(lora))
            with self._lock:
                hit = self._templates.setdefault(key, hit)
        return hit

    def pack_template(self, cfg: ModelConfig, configs: Sequence[LoraConfig], seed: int = 0,
                      device=None):
        """Fresh (lora, opt) state for this pack shape: the cached LoRA
        template on the host (``init_model`` from ``seed`` on ``device``'s
        kind of generator, default CUDA), in fresh containers, and
        ``opt=None``, which ``train_pack`` takes as zero optimizer state made
        on the slice's device (a host copy of those zeros would be twice the
        LoRA's bytes)."""
        lora = self._lora_template(cfg, pack_meta(configs), seed, device)
        return tree_map(lambda t: t, lora), None

    # ---------------- the step cache ----------------

    def step_fn(self, cfg: ModelConfig, n_pack: int, slice_: Optional[MeshSlice] = None, *,
                impl: Optional[str] = None, remat: Optional[str] = None,
                ranks: Optional[Tuple[int, ...]] = None,
                base_dtype: Optional[str] = None,
                blocks: Optional[Tuple[int, ...]] = None) -> Callable:
        """The eager packed step for this (config, pack width, kernel
        policy: impl, remat, ranks, base storage and the fused kernel's
        K-split override ``blocks``): ``make_packed_step``, built once per
        key and counted as a build or a hit. A homogeneous rank tuple
        normalises to None (it computes the same), so same-width packs share
        a step across uniform rank buckets. On a captured slice the cache
        unit is the graph instead (``train_pack``)."""
        key = self._step_key(cfg, n_pack, slice_, impl, remat, ranks, base_dtype, blocks)
        return self._cached_step(key, in_place=False)

    def _cached_step(self, key: Tuple, in_place: bool) -> Callable:
        with self._lock:
            self._count((key, in_place) not in self._steps)
        return self._step_closure(key, in_place)

    @staticmethod
    def _step_key(cfg, n_pack, slice_, impl, remat, ranks, base_dtype, blocks) -> Tuple:
        if slice_ is not None and slice_.width > 1:
            slice_.mesh()  # raises: sharded slices are not ported
        ranks = tuple(ranks) if ranks and len(set(ranks)) > 1 else None
        blocks = tuple(int(b) for b in blocks) if blocks is not None else None
        return (cfg, n_pack, 1, (impl, remat, ranks, base_dtype, blocks))

    def _step_closure(self, key: Tuple, in_place: bool) -> Callable:
        with self._lock:
            step = self._steps.get((key, in_place))
            if step is None:
                from repro_torch.train.trainer import make_packed_step

                cfg, n_pack, _, (impl, remat, ranks, base_dtype, blocks) = key
                step = self._steps[key, in_place] = make_packed_step(
                    cfg, n_pack, impl=impl, remat=remat, ranks=ranks, base_dtype=base_dtype,
                    in_place=in_place, blocks=blocks)
            return step

    def _count(self, built: bool) -> None:
        if built:
            self.n_builds += 1
            self.tracer.metrics.counter("executor.compile_cache_builds").inc()
        else:
            self.n_hits += 1
            self.tracer.metrics.counter("executor.compile_cache_hits").inc()

    @staticmethod
    def _pack_shape(key: Tuple, meta: PackMeta, seq: int, base) -> Tuple:
        """What a pack's graph key follows from before its state or batches
        exist: the step key, the rank bucket (with the config, the LoRA
        tree's shapes), the rows and tokens of the default batch, and the
        base's leaves. Packs of one graph key share it."""
        return (key, meta.r_bucket, meta.max_batch, seq,
                tuple(t.data_ptr() for t in tree_leaves(base)))

    def _drop_graphs(self, device, unless: Optional[Tuple] = None) -> None:
        """Drop ``device``'s least recently used graphs until a capture has
        room (``MAX_GRAPHS``) and give their pools and buffers back; nothing
        when one of its graphs serves the pack shape ``unless``. Called with
        ``_CAPTURING`` held."""
        with self._lock:
            mine = [k for k in self._graphs if k[1] == device]  # oldest first
            if unless is not None and any(self._graphs[k].shape == unless for k in mine):
                return
            evicted = [self._graphs.pop(k) for k in mine[:max(0, len(mine) - MAX_GRAPHS + 1)]]
        if evicted:
            del evicted
            torch.cuda.empty_cache()

    def _captured(self, key: Tuple, shape: Tuple, base, lora, opt, batch, vecs, n_pack: int,
                  device, track: str) -> Tuple[_CapturedStep, bool]:
        """(the graph of ``key``, whether it was captured just now): captured
        on its first use, with this pack's state in its buffers, after
        dropping this device's least recently used graphs beyond
        ``MAX_GRAPHS - 1``."""
        with self._lock:
            entry = self._graphs.get(key)
            self._count(entry is None)
            if entry is not None:
                self._graphs.move_to_end(key)
                return entry, False
        with _CAPTURING:
            self._drop_graphs(device)
            with self.tracer.span("executor.compile", cat="executor", track=track,
                                  n_pack=n_pack):
                t0 = time.perf_counter()
                entry = _CapturedStep(self._step_closure(key[0], in_place=True), base, lora,
                                      opt, batch, vecs, n_pack, device, shape)
        self.captures.append({
            "device": str(device), "n_pack": n_pack, "lora_bytes": _nbytes(entry.lora),
            "rows": int(batch["tokens"].shape[0]), "seq": int(batch["tokens"].shape[1]),
            "pool_bytes": entry.pool_bytes, "static_bytes": entry.static_bytes,
            "transient_bytes": entry.transient_bytes, "seconds": time.perf_counter() - t0})
        with self._lock:
            self._graphs[key] = entry
        return entry, True

    def clear(self) -> None:
        """Drop every cached graph (and its pool and buffers) and every copy
        of a base placed on a slice's device."""
        with self._lock:
            self._graphs.clear()
            self._bases.clear()

    def _placed_base(self, base, dev):
        """``base`` on ``dev``: itself when its leaves lie there, else a copy
        made on the first call for this (base, device) and kept."""
        leaves = tree_leaves(base) if base is not None else []
        if all(not isinstance(t, torch.Tensor) or t.device == dev for t in leaves):
            return base
        key = (id(base), dev)
        with self._lock:
            hit = self._bases.get(key)
        if hit is None or hit[0] is not base:
            # outside the lock: one slice per device at a time, so one copier
            hit = (base, tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t,
                                  base))
            with self._lock:
                self._bases[key] = hit
        return hit[1]

    # ---------------- packed training on one slice ----------------

    def train_pack(
        self,
        cfg: ModelConfig,
        configs: Sequence[LoraConfig],
        *,
        n_steps: int,
        seq: int,
        base,
        lora=None,
        opt=None,
        slice_: Optional[MeshSlice] = None,
        seed: int = 0,
        budgets: Optional[np.ndarray] = None,
        data_iter_fn: Optional[Callable] = None,
        data_start_steps: Optional[Sequence[int]] = None,
        step_callback: Optional[Callable] = None,
        impl: Optional[str] = None,
        remat: Optional[str] = None,
        base_dtype: Optional[str] = None,
        init_state: Optional[Callable] = None,
        blocks: Optional[Tuple[int, ...]] = None,
    ) -> PackResult:
        """Train one pack for ``n_steps`` on ``slice_`` (default: CUDA).
        ``lora``/``opt`` may carry resumed state (torch or numpy leaves, left
        as they are; ``lora=None``: the pack template; ``opt=None``: fresh);
        ``init_state(meta, device)`` -> (lora, opt) makes them instead, once
        the device has room for the pack (``run_segment``'s resume);
        ``budgets`` is the per-adapter step-cap vector (None = uncapped);
        ``data_start_steps`` fast-forwards each adapter's data stream past
        batches consumed in earlier segments; ``step_callback(i, metrics)``
        runs after every step. ``blocks`` is the fused kernel's K-split
        override ``(k_splits,)`` (the autotuner's ``best_blocks``; None: each
        call's plan); it is part of the step's key and so of its captured
        graph's. ``base`` is read where it lies on the slice's
        device, else from a copy placed there once. The pack runs with that
        device current. The capture (or the first eager step's build)
        happens outside the timed region: ``wall_seconds`` is steady state.
        Eager steps update a copy of the state in place, as the captured
        step updates its buffers."""
        meta = pack_meta(configs)
        dev = resolve_device(None if slice_ is None else slice_.lead)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = self._step_key(cfg, meta.n, slice_, impl, remat, meta.ranks, base_dtype, blocks)
        with _on_device(dev):
            base = self._placed_base(base, dev)
            shape = None
            if dev.type == "cuda":
                if self.capture and n_steps > 0:
                    shape = self._pack_shape(key, meta, seq, base)
                    with _CAPTURING:
                        self._drop_graphs(dev, unless=shape)
                torch.cuda.reset_peak_memory_stats(dev)
            if init_state is not None:
                lora, opt = init_state(meta, dev)
            res = self._train(key, shape, cfg, configs, meta, dev, n_steps, seq, base, lora, opt,
                              slice_, seed, budgets, data_iter_fn, data_start_steps,
                              step_callback)
            if dev.type == "cuda":
                res.peak_bytes = torch.cuda.max_memory_allocated(dev)
        return res

    def _train(self, key, shape, cfg, configs, meta, dev, n_steps, seq, base, lora, opt, slice_,
               seed, budgets, data_iter_fn, data_start_steps, step_callback) -> PackResult:
        from repro_torch.train.data import packed_batch_iterator

        lora = self._lora_template(cfg, meta, seed, dev) if lora is None else _tensors(lora)
        opt = None if opt is None else _tensors(opt)
        if budgets is None:
            budgets = np.full((meta.n,), NO_BUDGET, np.int32)
        vecs = (meta.scales(dev), meta.lr_vector(dev),
                torch.from_numpy(np.asarray(budgets, np.int32)).to(dev))
        track = _slice_track(slice_)
        real_start = time.perf_counter()
        captured = self.capture and dev.type == "cuda" and n_steps > 0
        if not captured:
            step = self._cached_step(key, in_place=True)
            lora_d = tree_map(lambda t: t.to(dev, copy=True), lora)
            opt_d = (init_opt_state(lora_d, n_pack=meta.n) if opt is None
                     else tree_map(lambda t: t.to(dev, copy=True), opt))
        if n_steps <= 0:
            return PackResult(lora_d, opt_d, None, 0.0, real_start, time.perf_counter())
        skip = (tuple(int(s) for s in data_start_steps)
                if data_start_steps is not None and any(data_start_steps) else None)
        if data_iter_fn:
            # a custom iterator gets the offsets only when a resumed segment
            # needs them and it takes ``start_steps``
            if skip and _accepts_start_steps(data_iter_fn):
                it = data_iter_fn(cfg, list(configs), seq, start_steps=skip)
            else:
                it = data_iter_fn(cfg, list(configs), seq)
        else:
            it = packed_batch_iterator(cfg, list(configs), seq=seq, start_steps=skip, device=dev)

        def put(b):
            return {k: v.to(dev) for k, v in b.items()}

        batches = [put(next(it)) for _ in range(min(n_steps, PREGEN_CHUNK))]
        lock = contextlib.nullcontext()
        if captured:
            gkey = (key, dev, _signature(lora),
                    tuple((k, tuple(v.shape), v.dtype) for k, v in batches[0].items()),
                    tuple(t.data_ptr() for t in tree_leaves(base)))
            step, fresh = self._captured(gkey, shape, base, lora, opt, batches[0], vecs, meta.n,
                                         dev, track)
            lock = step.lock
        with lock:
            if captured and not fresh:
                step.load(lora, opt, vecs)
            with self.tracer.span("executor.train", cat="executor", track=track,
                                  n_pack=meta.n, n_steps=n_steps):
                t0 = time.perf_counter()
                i = 0
                while batches:
                    for batch in batches:
                        if captured:
                            m = step(batch)
                        else:
                            lora_d, opt_d, m = step(base, lora_d, opt_d, batch, *vecs)
                        if step_callback is not None:
                            step_callback(i, m)
                        i += 1
                    batches = [put(next(it)) for _ in range(min(n_steps - i, PREGEN_CHUNK))]
                losses = m["per_adapter_loss"].cpu().numpy()  # waits for the device
                wall = time.perf_counter() - t0
            if captured:
                lora_d, opt_d = step.lora, step.opt
        return PackResult(lora=lora_d, opt=opt_d, losses=losses, wall_seconds=wall,
                          real_start=real_start, real_end=time.perf_counter(),
                          captured=captured and fresh)

    # ---------------- one planned segment (engine integration) ----------------

    def run_segment(
        self,
        seg,  # JobSegment
        configs_by_cid: Dict[int, LoraConfig],
        total_steps: Dict[int, int],
        cfg: ModelConfig,
        base_params,
        *,
        seq: int,
        pool,  # Optional[CheckpointPool]
        data_iter_fn: Optional[Callable] = None,
        seed: int = 0,
        slice_: Optional[MeshSlice] = None,
        impl: Optional[str] = None,
        remat: Optional[str] = None,
        base_dtype: Optional[str] = None,
    ):
        """Execute one planned segment on ``slice_``: resume preempted
        adapters from the checkpoint pool, train ``seg.run_steps`` packed
        iterations, then save finished adapters and re-checkpoint the
        unfinished ones. Returns a ``JobRecord``."""
        from repro_torch.sched.engine import JobRecord
        from repro_torch.sched.planner import ScheduledJob

        track = _slice_track(slice_)
        with self.tracer.span("executor.segment", cat="executor", track=track,
                              job_id=seg.job_id, cids=list(seg.config_ids),
                              degree=seg.degree, units=list(seg.units)):
            job_cfgs = [configs_by_cid[cid] for cid in seg.config_ids]
            budgets = np.asarray([total_steps[cid] for cid in seg.config_ids], np.int32)
            res = self.train_pack(
                cfg, job_cfgs, n_steps=seg.run_steps, seq=seq, base=base_params,
                slice_=slice_, seed=seed, budgets=budgets,
                data_iter_fn=data_iter_fn, data_start_steps=seg.start_steps,
                impl=impl, remat=remat, base_dtype=base_dtype,
                init_state=lambda meta, dev: self._resume(seg, cfg, meta, seed, dev, pool, track),
            )
            save_cm = (self.tracer.span("executor.checkpoint_save", cat="executor",
                                        track=track, cids=list(seg.config_ids))
                       if pool is not None else contextlib.nullcontext())
            with save_cm:
                self._save_segment_state(seg, configs_by_cid, total_steps, pack_meta(job_cfgs),
                                         pool, res.lora, res.opt, res.losses)
            return JobRecord(
                ScheduledJob(seg.config_ids, seg.degree, seg.start, seg.end),
                res.wall_seconds, res.losses,
                real_start=res.real_start, real_end=res.real_end, peak_bytes=res.peak_bytes,
                captured=res.captured,
            )

    def _resume(self, seg, cfg, meta, seed, dev, pool, track):
        """The segment's initial (lora, opt): the pack template, with each
        resumed adapter's weights, moments and step count injected from the
        pool (on the host); ``opt`` is None when nothing resumes."""
        lora = self._lora_template(cfg, meta, seed, dev)
        resumed = [(slot, cid, st0) for slot, (cid, st0)
                   in enumerate(zip(seg.config_ids, seg.start_steps)) if st0]
        if not resumed:
            return lora, None
        opt = init_opt_state(lora, n_pack=meta.n)
        with self.tracer.span("executor.resume_load", cat="executor", track=track,
                              cids=[cid for _, cid, _ in resumed]):
            for slot, cid, st0 in resumed:
                if pool is None or not pool.has_adapter_state(f"{cid:04d}"):
                    raise RuntimeError(
                        f"segment resumes config {cid} at step {st0} but the "
                        "pool holds no checkpointed state for it"
                    )
                state, smeta = pool.load_adapter_state(f"{cid:04d}")
                if int(smeta["steps_done"]) != st0:
                    raise RuntimeError(f"config {cid}: the pool holds step "
                                       f"{smeta['steps_done']}, the segment resumes at {st0}")
                lora = inject_adapter(lora, state["w"], slot)
                opt["m"] = inject_adapter(opt["m"], state["m"], slot)
                opt["v"] = inject_adapter(opt["v"], state["v"], slot)
                opt["step"] = opt["step"].clone()
                opt["step"][slot] = st0
        return lora, opt

    def _save_segment_state(self, seg, configs_by_cid, total_steps, meta, pool, lora, opt,
                            losses):
        done = set(seg.done_ids)
        for slot, cid in enumerate(seg.config_ids):
            c = configs_by_cid[cid]
            if cid in done:
                if pool is None:
                    continue
                pool.save_adapter(
                    f"adapter_{cid:04d}",
                    extract_adapter(lora, slot, meta.ranks),
                    {
                        "rank": c.rank,
                        "alpha": c.alpha,
                        "learning_rate": c.learning_rate,
                        "batch_size": c.batch_size,
                        "final_loss": float(losses[slot]) if losses is not None else float("nan"),
                        "total_steps": int(total_steps[cid]),
                    },
                )
            else:  # preempted mid-training: checkpoint resumable state
                if pool is None:
                    raise RuntimeError(f"config {cid} is preempted but there is no pool")
                pool.save_adapter_state(
                    f"{cid:04d}",
                    {
                        "w": extract_adapter(lora, slot, meta.ranks),
                        "m": extract_adapter(opt["m"], slot, meta.ranks),
                        "v": extract_adapter(opt["v"], slot, meta.ranks),
                    },
                    {
                        "steps_done": int(seg.start_steps[slot] + seg.run_steps),
                        "rank": c.rank,
                        "total_steps": int(total_steps[cid]),
                    },
                )
