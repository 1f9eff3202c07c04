"""Continuous-batching multi-LoRA serving engine.

The port of ``repro/serve/engine.py``. The decode batch has a
fixed width of ``rows`` independent slots, each carrying its *own* adapter:
the packed-LoRA delta runs at row granularity (``n_pack == rows``, one token
per row, per-row scales and per-row decode positions). When a row finishes
its request, the next queued request is admitted into it before the next
step, so the batch never drains while work is queued. Admission prefills a
prompt in one shot (the default), or, with ``prefill_chunk`` set, streams
it into a row-private cache in chunks of at most that many tokens, one
chunk per engine iteration between decode steps (``model.prefill_chunk``;
the reference's ``engine.py:11-16``): the other rows keep emitting while a
long prompt fills, each paying one chunk of inter-token latency a step, not
the whole prefill.

A request at ``temperature`` > 0 samples its tokens (``sample_tokens``:
top-k, then a categorical draw by Gumbel-max from a ``torch.Generator``
re-seeded for each draw from the engine's ``seed`` and the request id (its
first token) or the decode step, so a drain replays exactly); a request at
0 takes the argmax.

``AdapterSlotCache``
    Fixed-capacity host-side staging for adapter weights, LRU-evicted.
    A miss loads the adapter from a ``CheckpointPool`` (the sweep's);
    ``publish()`` inserts an adapter from memory (tune-then-serve with no
    disk round trip). Adapters of active rows are pinned and never evicted.

``ServeExecutor``
    A keyed cache of the prefill, prefill-chunk, decode-step and
    sampling decode-step closures, one per ``(kind, cfg, n_rows, ...)``
    key, with ``scales`` (and temperature, top-k and generator) runtime
    arguments. ``default_executor()`` is the process-wide one that
    ``generate``, ``prefill_chunked`` and every engine given none share.

On a CUDA device the engine runs its decode step as a CUDA graph, as the
reference jits it (``repro/serve/engine.py:356-394``): one graph of the
greedy step and one of the sampling step, each captured on its first use
after an eager warm-up, reading the base, the engine's row pack and caches
in place and its row vectors from static device buffers. Each step stages
those vectors through one pinned host buffer (one copy to the card) and
reads its tokens back through another; the logits stay on the card. The
graphs belong to the engine, never to the executor: they pin its caches
and pack, and go back to the device with it. Prefill stays eager: it
specializes on the prompt's length, so a graph would almost never be
replayed.

``ServeEngine``
    The event loop: ``publish``, ``submit``, ``serve`` and the width-1
    ``serve_sequential`` baseline. It is also a
    :class:`~repro_torch.cluster.api.Runner`: ``run()`` executes planned
    training segments through an inner ``ClusterRunner`` on the engine's
    ``device_pool``, and ``serve_lease()`` reserves units for decoding.

Invariants, checked in ``tests/test_torch_serve.py`` and
``tests/test_torch_chunked_prefill.py``: continuous batching, chunked or
not, emits the same greedy tokens as ``serve_sequential``. Unlike the
reference, the logits are equal only within rounding, not bitwise: the base GEMMs run
at another batch width (PyTorch picks its GEMM by shape), and the
sequential path decodes from compute-dtype caches where the engine's row
caches are bf16 — as in the reference. MoE capacity couples rows (the
experts' slots are shared by every token of a step), so for an MoE model
the two agree only while no expert overflows, as the reference notes
(``repro/serve/engine.py:48``); at 8 decode rows or fewer the capacity
floor of 8 slots drops nothing.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cluster.executor import (
    _CAPTURING,
    WARMUP_STEPS,
    SliceExecutor,
    _check_fits,
    _copy_tree,
    _no_collection,
)
from repro_torch.cluster.pool import DevicePool
from repro_torch.cluster.runner import ClusterRunner
from repro_torch.configs.base import LoraConfig, ModelConfig
from repro_torch.core.adapter import pack_meta
from repro_torch.core.packed_lora import extract_adapter
from repro_torch.kernels import launches
from repro_torch.kernels.quant import base_storage
from repro_torch.models.model import decode_step, init_caches, lora_zeros, prefill, prefill_chunk
from repro_torch.obs import NULL_TRACER, Histogram
from repro_torch.serve.decode import align_prefill_chunk, pad_caches
from repro_torch.tree import tree_map

# ---------------------------------------------------------------------------
# Request / result / stats surface
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServeRequest:
    """One decode request against one adapter.

    ``arrival`` is in virtual time (decode steps since trace start).
    ``extra`` adds fields to the request's prefill batch (its frames or
    patches, on any device); a VLM request's positions start after the
    config's ``n_patch_tokens``, whether or not it carries patches, as in
    the reference.
    ``rank``/``alpha`` override the adapter's own metadata when that lacks
    them. ``deadline_ms`` is a wall-clock SLO from the moment the request
    entered the queue: a queued request past it is rejected before any
    prefill, and an in-flight row that goes overdue retires as a partial
    result; both carry ``error="deadline"``.
    ``temperature`` 0 (the default) takes the argmax; above 0 the request
    samples at that temperature from its ``top_k`` largest logits (0: the
    whole vocabulary; ties at the k-th value are kept)."""

    request_id: int
    adapter_id: str
    prompt: np.ndarray  # (S,) int32 token ids
    max_new_tokens: int = 16
    arrival: float = 0.0
    rank: Optional[int] = None
    alpha: Optional[float] = None
    deadline_ms: Optional[float] = None
    # the prefill batch's other fields: an encoder-decoder's "frames" (1,
    # S_enc, d), a VLM's "patches" (1, P, d)
    extra: Optional[dict] = None
    temperature: float = 0.0
    top_k: int = 0


@dataclass
class ServeResult:
    """Emitted tokens + admission/latency accounting for one request.
    ``error`` is None for a served request; a rejected one has zero tokens."""

    request_id: int
    adapter_id: str
    tokens: np.ndarray  # (<= max_new_tokens,) int32
    n_prompt: int
    arrival: float
    admitted_step: int
    finished_step: int
    admitted_wall: float  # seconds since serve() start
    finished_wall: float
    error: Optional[str] = None


@dataclass
class ServeStats:
    """Aggregate outcome of one drain. ``ttft``: seconds from enqueue to
    the first token; ``itl``: gap between a row's consecutive tokens (any
    admission work in between included); ``queue_wait``: enqueue to start
    of admission."""

    results: List[ServeResult] = field(default_factory=list)
    steps: int = 0
    tokens_emitted: int = 0
    occupancy_sum: int = 0
    wall_seconds: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_evictions: int = 0
    ttft: Histogram = field(default_factory=lambda: Histogram("serve.ttft"))
    itl: Histogram = field(default_factory=lambda: Histogram("serve.itl"))
    queue_wait: Histogram = field(default_factory=lambda: Histogram("serve.queue_wait"))
    # host seconds a decode step takes to stage its row vectors and queue
    # its work, before it waits for its tokens (a graph's capture included)
    step_host: Histogram = field(default_factory=lambda: Histogram("serve.step_host"))

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_emitted / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.steps if self.steps else 0.0

    def latency_summaries(self) -> Dict[str, Dict[str, float]]:
        return {"ttft": self.ttft.summary(), "itl": self.itl.summary(),
                "queue_wait": self.queue_wait.summary(), "step_host": self.step_host.summary()}


def poisson_requests(adapter_ids: Sequence[str], prompts: Sequence[np.ndarray],
                     mean_interarrival: float, *, max_new_tokens: int = 16,
                     seed: int = 0) -> List[ServeRequest]:
    """A Poisson request trace (gaps ~ Exp(mean_interarrival) decode steps),
    shifted so the first request arrives at t=0."""
    if len(adapter_ids) != len(prompts):
        raise ValueError("one adapter id per prompt")
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(mean_interarrival, size=len(adapter_ids))
    times = np.cumsum(gaps) - gaps[0]
    return [
        ServeRequest(request_id=i, adapter_id=aid, prompt=np.asarray(p, np.int32),
                     max_new_tokens=max_new_tokens, arrival=float(t))
        for i, (aid, p, t) in enumerate(zip(adapter_ids, prompts, times))
    ]


# ---------------------------------------------------------------------------
# Adapter slot cache
# ---------------------------------------------------------------------------


class AdapterSlotCache:
    """Fixed-capacity LRU cache of host-side adapter weights. ``get``
    loads a missing adapter from ``pool`` (a ``CheckpointPool``: its
    ``load_adapter`` and ``load_meta``); ``publish`` inserts one from
    memory. ``pin``ned adapters (referenced by active rows) are never
    evicted; if every slot is pinned a new insert is refused rather than
    growing past capacity."""

    def __init__(self, capacity: int, pool=None, *, metrics=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.pool = pool
        self._slots: "OrderedDict[str, Tuple[dict, dict]]" = OrderedDict()
        self._pins: Dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.metrics = metrics if metrics is not None else NULL_TRACER.metrics

    def __contains__(self, adapter_id: str) -> bool:
        return adapter_id in self._slots

    def __len__(self) -> int:
        return len(self._slots)

    def ids(self) -> List[str]:
        """Slot ids in LRU order (least recently used first)."""
        return list(self._slots)

    def pin(self, adapter_id: str) -> None:
        self._pins[adapter_id] = self._pins.get(adapter_id, 0) + 1

    def unpin(self, adapter_id: str) -> None:
        n = self._pins.get(adapter_id, 0) - 1
        if n <= 0:
            self._pins.pop(adapter_id, None)
        else:
            self._pins[adapter_id] = n

    def _evict_to_fit(self) -> None:
        while len(self._slots) >= self.capacity:
            victim = next((aid for aid in self._slots if aid not in self._pins), None)
            if victim is None:
                raise RuntimeError(
                    f"all {self.capacity} adapter slots are pinned by active rows; "
                    "cannot admit a new adapter (raise slot_capacity or lower rows)"
                )
            self._slots.pop(victim)
            self.evictions += 1
            self.metrics.counter("serve.adapter_cache_evictions").inc()

    def publish(self, adapter_id: str, adapter_tree: dict, meta: dict) -> None:
        """Insert (or refresh) an adapter from memory."""
        if adapter_id in self._slots:
            self._slots.pop(adapter_id)
        else:
            self._evict_to_fit()
        self._slots[adapter_id] = (adapter_tree, dict(meta))

    def get(self, adapter_id: str) -> Tuple[dict, dict]:
        if adapter_id in self._slots:
            self.hits += 1
            self.metrics.counter("serve.adapter_cache_hits").inc()
            self._slots.move_to_end(adapter_id)
            return self._slots[adapter_id]
        self.misses += 1
        self.metrics.counter("serve.adapter_cache_misses").inc()
        if self.pool is None or not self.pool.has(adapter_id):
            raise KeyError(f"adapter {adapter_id!r} is neither staged nor in the checkpoint pool")
        tree = self.pool.load_adapter(adapter_id)
        meta = self.pool.load_meta(adapter_id)
        self._evict_to_fit()
        self._slots[adapter_id] = (tree, dict(meta))
        return self._slots[adapter_id]


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
# the two streams of draws: a request's first token (keyed by its id) and a
# decode step's tokens (keyed by the drain's step counter)
FIRST_TOKEN, DECODE_STEP = 1, 2


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def draw_seed(seed: int, stream: int, value: int) -> int:
    """The generator seed of one draw: splitmix64 folded over ``(seed,
    stream, value)``, cut to 63 bits -- the counterpart of the reference's
    ``fold_in(fold_in(PRNGKey(seed), 0x5EED), value)``, whose streams torch
    cannot reproduce. ``stream`` is ``FIRST_TOKEN`` (``value``: the request
    id) or ``DECODE_STEP`` (``value``: the step)."""
    h = _splitmix64(seed & _M64)
    h = _splitmix64(h ^ stream)
    return _splitmix64(h ^ (value & _M64)) >> 1


def sample_tokens(lg: torch.Tensor, temp: torch.Tensor, topk: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """Per-row temperature / top-k sampling over last-position logits (the
    reference's ``engine.py:317-338``).

    lg: (R, V); temp: (R,) f32; topk: (R,) int (0: the whole vocabulary);
    ``generator`` on ``lg``'s device draws the rows' uniforms. A row at
    ``temp == 0`` returns exactly the argmax, in a mixed batch too. The
    top-k threshold is the ``k``-th largest logit (``k`` clipped to [1,
    V]), and every logit at or above it is kept, ties included; the draw is
    categorical over ``masked / max(temp, 1e-6)``, by Gumbel-max (argmax
    of the scaled logits plus -log(-log(u))), as ``jax.random.categorical``
    draws. Returns (R,) int32 on ``lg``'s device; nothing goes to the host."""
    v = lg.shape[-1]
    lg = lg.float()
    greedy = torch.argmax(lg, dim=-1).to(torch.int32)
    k_eff = torch.where(topk > 0, topk, v).clamp(1, v).to(torch.int64)
    thresh = torch.sort(lg, dim=-1).values.gather(-1, (v - k_eff)[:, None])
    masked = torch.where(lg >= thresh, lg, float("-inf"))
    t = temp.float().clamp_min(1e-6)[:, None]
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    sampled = torch.argmax(masked / t + gumbel, dim=-1).to(torch.int32)
    return torch.where(temp > 0, sampled, greedy)


# ---------------------------------------------------------------------------
# Serve executor: keyed closure cache
# ---------------------------------------------------------------------------


class ServeExecutor:
    """One prefill and one decode-step closure per key; ``scales`` is a
    runtime argument of both, so admission never builds a new one. It
    holds closures only: an engine's CUDA graphs of these steps are the
    engine's own."""

    def __init__(self):
        self._fns: Dict[Tuple, Callable] = {}

    @property
    def cache_size(self) -> int:
        return len(self._fns)

    def step_fn(self, cfg: ModelConfig, n_rows: int, *, kcfg=None):
        """``(base, lora, scales, caches, token (R,1), pos () or (R,)) ->
        (next_tok (R,), logits, caches)``; greedy."""
        key = ("step", cfg, n_rows, kcfg)
        if key not in self._fns:

            def step(base, lora, scales, caches, token, pos):
                lg, caches = decode_step(base, lora, scales, token, caches, pos, cfg,
                                         n_pack=n_rows, kcfg=kcfg)
                return torch.argmax(lg[:, -1, :], dim=-1).to(torch.int32), lg, caches

            self._fns[key] = step
        return self._fns[key]

    def sample_step_fn(self, cfg: ModelConfig, n_rows: int, *, kcfg=None):
        """``(base, lora, scales, caches, token, pos, temp (R,), topk (R,),
        generator) -> (next_tok (R,), logits, caches)``: the decode step,
        then ``sample_tokens`` on its last-position logits; temperature,
        top-k and generator are runtime arguments, so one closure serves
        every request's settings (the reference's ``engine.py:373-394``)."""
        key = ("sample_step", cfg, n_rows, kcfg)
        if key not in self._fns:

            def step(base, lora, scales, caches, token, pos, temp, topk, generator):
                lg, caches = decode_step(base, lora, scales, token, caches, pos, cfg,
                                         n_pack=n_rows, kcfg=kcfg)
                return sample_tokens(lg[:, -1, :], temp, topk, generator), lg, caches

            self._fns[key] = step
        return self._fns[key]

    def prefill_fn(self, cfg: ModelConfig, n_rows: int, *, chunk_q: int = 512, kcfg=None):
        """``(base, lora, scales, batch) -> (last-pos logits (R,1,V), caches)``."""
        key = ("prefill", cfg, n_rows, chunk_q, kcfg)
        if key not in self._fns:

            def prefill_(base, lora, scales, batch):
                return prefill(base, lora, scales, batch, cfg, n_pack=n_rows,
                               chunk_q=chunk_q, kcfg=kcfg)

            self._fns[key] = prefill_
        return self._fns[key]

    def prefill_chunk_fn(self, cfg: ModelConfig, n_rows: int, *, kcfg=None):
        """``(base, lora, scales, tokens (R, C), caches, pos) -> (last-pos
        logits (R,1,V), caches)``, the caches advanced in place
        (``model.prefill_chunk``); ``pos`` a Python int. One closure per
        ``(cfg, n_rows, kcfg)``, as the reference's ``engine.py:414-435``."""
        key = ("prefill_chunk", cfg, n_rows, kcfg)
        if key not in self._fns:

            def chunk_(base, lora, scales, tokens, caches, pos):
                return prefill_chunk(base, lora, scales, tokens, caches, pos, cfg,
                                     n_pack=n_rows, kcfg=kcfg)

            self._fns[key] = chunk_
        return self._fns[key]


_DEFAULT_EXECUTOR: Optional[ServeExecutor] = None


def default_executor() -> ServeExecutor:
    """The process-wide ``ServeExecutor`` (the reference's
    ``engine.py:438-447``): ``generate``, ``prefill_chunked`` and every
    engine that brings none share its closures."""
    global _DEFAULT_EXECUTOR
    if _DEFAULT_EXECUTOR is None:
        _DEFAULT_EXECUTOR = ServeExecutor()
    return _DEFAULT_EXECUTOR


# ---------------------------------------------------------------------------
# Captured decode steps
# ---------------------------------------------------------------------------

# the decode step's row vectors, one buffer on the host and one on the
# device: name -> dtype, in an order that keeps every view aligned
_ROW_VECTORS = (("pos", torch.int64), ("tok", torch.int32), ("topk", torch.int32),
                ("scales", torch.float32), ("temp", torch.float32))

# one side stream per CUDA device for every decode capture of the process:
# a stream's first cuBLAS call allocates a workspace that stays with the
# stream, so engines that all capture on one stream leave nothing behind
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _row_vectors(buf: torch.Tensor, rows: int) -> Dict[str, torch.Tensor]:
    """Views of the uint8 ``buf`` as the row vectors of ``_ROW_VECTORS``,
    each (rows,)."""
    out, off = {}, 0
    for name, dt in _ROW_VECTORS:
        n = rows * dt.itemsize
        out[name] = buf[off : off + n].view(dt)
        off += n
    return out


class _CapturedDecode:
    """One CUDA graph of an engine's decode step, greedy or sampling,
    captured as ``cluster.executor._CapturedStep`` captures a train step.
    ``fn(*args)`` is the eager step on the engine's base, row pack, caches
    and static row-vector buffers, which the graph then reads in place. A
    sampling step's ``generator`` is registered with the graph, so that
    re-seeding it before a replay keys the replay's draws as it keys an
    eager step's. Each replay adds the launches the capture recorded to the
    kernels' counts."""

    def __init__(self, fn: Callable, args: Tuple, generator, caches, device, what: str):
        side = _SIDE_STREAMS.get(device)
        if side is None:
            side = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
        # the warm-up steps the caches (an SSM layer's state advances):
        # they go back to what they held before it
        snapshot = tree_map(torch.clone, caches)
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        side.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    fn(*args)
        except torch.OutOfMemoryError as e:
            raise torch.OutOfMemoryError(f"{what}: its eager warm-up step ran out of memory "
                                         f"on {device}: {e}") from e
        torch.cuda.current_stream(device).wait_stream(side)
        _copy_tree(caches, snapshot)
        torch.cuda.synchronize(device)
        del snapshot
        torch.cuda.empty_cache()
        # what the graph's pool will hold: the warm-up's transient peak
        self.transient_bytes = torch.cuda.max_memory_allocated(device) - held
        _check_fits(self.transient_bytes, device, f"{what}: its graph's memory pool",
                    "serve fewer rows, or a shorter smax")
        reserved = torch.cuda.memory_reserved(device)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        with _no_collection(), launches.recorded() as self.launches, torch.cuda.graph(
                self.graph, stream=side, capture_error_mode="thread_local"):
            self.next_tok, self.logits, _ = fn(*args)
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def __call__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """One replay: (next tokens (R,), logits (R, 1, V)), the graph's
        own output buffers."""
        self.graph.replay()
        launches.add(self.launches)
        return self.next_tok, self.logits


# ---------------------------------------------------------------------------
# Row-granular write
# ---------------------------------------------------------------------------


def write_row_caches(caches, row_caches, row: int):
    """Write a width-1 tree into row ``row`` of a width-R tree (decode caches
    or packed lora params — both share the layout), in place, casting to the
    width-R tree's dtype (an SSM layer's conv window and state stay f32:
    ``init_caches`` makes them so). Under a stacked ``"blocks"`` subtree the row axis
    is 1, else 0; a shorter sequence axis fills its leading part."""

    def walk(t, s, in_blocks):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k], in_blocks or k == "blocks") for k in t}
        if t is None or s is None:
            return t
        src = s.select(1 if in_blocks else 0, 0)
        dst = t.select(1 if in_blocks else 0, row)
        for ax in range(src.dim()):
            dst = dst.narrow(ax, 0, src.shape[ax])
        dst.copy_(src)
        return t

    return walk(caches, row_caches, False)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@dataclass
class _PrefillState:
    """A row's chunked prefill in progress (the reference's
    ``engine.py:489-504``): its own width-1 f32 cache of capacity exactly
    its prompt's length, so that every chunk's attention sees the one-shot
    prefill's shapes; written into the row (cast to the engine's cache
    dtype) once the whole prompt is in."""

    lora1: dict  # the row's width-1 adapter tree, on the device
    scale: float
    scales: torch.Tensor  # (1,) f32 of ``scale``, on the device
    caches: dict  # width-1 f32 caches, capacity len(prompt)
    tokens: torch.Tensor  # (1, S) on the device: one copy, sliced per chunk
    filled: int = 0  # prompt tokens already in the cache


@dataclass
class _ActiveRow:
    request: ServeRequest
    emitted: List[int]
    admitted_step: int
    admitted_wall: float
    n_prompt: int
    last_emit_wall: float = 0.0
    # a chunked prefill in progress; None once the row decodes
    prefill: Optional[_PrefillState] = None


class ServeEngine:
    """Continuous-batching decode over ``rows`` adapter slots.

    The base parameters must lie on ``device`` (CUDA unless given); their
    embedding's dtype is the compute dtype, and the row pack of adapters is
    kept in it. Decode caches are bf16, as in the reference, but for an SSM
    layer's conv window and state, which are f32.

    ``impl``, ``remat`` and ``base_dtype`` form the kernel policy of
    prefill and every decode step, as in the reference. ``base_dtype``
    ("int8" | "nf4") marks a quantized base (``kernels/quant.py``; the
    tree's own storage must be that scheme): under a fused impl prefill and
    each decode step run ``fused_matmul_q`` on the codes, at prefill rows
    and at decode rows; under "auto" each projection is dequantized per
    call, the reference's two-pass formulation.

    ``prefill_chunk`` (None or 0: one-shot prefill) streams a plain-token
    request's prompt in chunks of at most that many tokens, rounded up to
    the SSD chunk on a stack with SSM layers (``align_prefill_chunk``):
    one chunk per filling row per engine iteration, before the decode
    step. A request with ``extra`` fields, and any request to a VLM or an
    encoder-decoder, is prefilled in one shot, as in the reference.

    ``checkpoint_pool``: where a slot-cache miss loads its adapter from.
    ``seed`` keys every sampled draw (``draw_seed``); the drain routes its
    steps through the sampling step only while some row samples, so an
    all-greedy drain runs exactly the greedy step.

    ``capture`` (None: on a CUDA device, not on the CPU): run the greedy
    and the sampling decode step each as a CUDA graph of the engine's own
    (``captures`` records each capture's seconds, pool and transient
    bytes), or eagerly (``False``). ``True`` on the CPU raises; a capture
    or replay that fails raises, and nothing falls back to the eager step.
    A capture resets the device's peak memory statistics (its warm-up's
    peak sizes the graph's pool). ``serve_executor`` (default:
    ``default_executor()``) holds the step closures, shared across engines.

    The training side (the ``Runner`` surface): ``device_pool`` (default:
    the CUDA devices, or the engine's own device when it is not CUDA) and
    ``train_executor`` (default: ``SliceExecutor(tracer=)``) back an inner
    ``ClusterRunner`` that ``run`` delegates to."""

    def __init__(self, cfg: ModelConfig, base_params, *, rows: int = 4, smax: int = 64,
                 r_bucket: int = 8, slot_capacity: int = 8,
                 prefill_chunk: Optional[int] = None, checkpoint_pool=None,
                 device_pool: Optional[DevicePool] = None,
                 serve_executor: Optional[ServeExecutor] = None, train_executor=None,
                 impl: Optional[str] = None, remat: Optional[str] = None,
                 base_dtype: Optional[str] = None, seed: int = 0,
                 capture: Optional[bool] = None, tracer=None, device=None):
        self.device = resolve_device(device)
        emb = base_params["embed"]["w"]
        if emb.device != self.device:
            raise ValueError(f"base params on {emb.device}, engine on {self.device}")
        on_cuda = self.device.type == "cuda"
        if capture and not on_cuda:
            raise ValueError(f"capture=True on {self.device}: a CUDA graph needs a CUDA device")
        self.capture = on_cuda if capture is None else capture
        self._graphs: Dict[bool, _CapturedDecode] = {}  # sampling? -> its graph
        self.captures: List[Dict[str, float]] = []
        if base_dtype is not None and base_storage(base_params) != base_dtype:
            raise ValueError(f"base_dtype={base_dtype!r}, but the base is stored as "
                             f"{base_storage(base_params)!r}")
        self.dtype = emb.dtype
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.cfg = cfg
        self.rows = rows
        self.smax = smax
        self.prefill_chunk = align_prefill_chunk(cfg, prefill_chunk)
        # uniform engine-wide rank bucket: every admitted adapter is
        # zero-padded to r_bucket, so the pack shape never changes
        self.meta = pack_meta([LoraConfig(rank=r_bucket, alpha=float(r_bucket))] * rows)
        self.meta1 = pack_meta([LoraConfig(rank=r_bucket, alpha=float(r_bucket))])
        self.kcfg = self.meta.kernel_config(impl, remat, base_dtype)
        self.kcfg1 = self.meta1.kernel_config(impl, remat, base_dtype)
        self.base = base_params
        # device-resident R-row pack (zero: empty rows add exactly nothing)
        self._lora = lora_zeros(cfg, self.meta, self.dtype, self.device)
        self._caches = None  # allocated on first use, then updated in place
        # the row vectors: numpy views of one pinned host buffer, copied as
        # one to the device buffer whose views the steps read; per-row
        # sampling settings among them (temperature 0: a greedy row)
        nbytes = rows * sum(dt.itemsize for _, dt in _ROW_VECTORS)
        self._rows_host = torch.zeros((nbytes,), dtype=torch.uint8, pin_memory=on_cuda)
        self._rows_dev = torch.zeros((nbytes,), dtype=torch.uint8, device=self.device)
        host = {k: v.numpy() for k, v in _row_vectors(self._rows_host, rows).items()}
        self._pos, self._scales, self._temp, self._topk = (
            host["pos"], host["scales"], host["temp"], host["topk"])
        self._tok = host["tok"].reshape(rows, 1)
        self._dev = _row_vectors(self._rows_dev, rows)
        self._dev["tok"] = self._dev["tok"].view(rows, 1)
        # a step's tokens come back through this pinned buffer
        self._tok_out = torch.zeros((rows,), dtype=torch.int32, pin_memory=on_cuda)
        self._tok_out_np = self._tok_out.numpy()
        self._rows: List[Optional[_ActiveRow]] = [None] * rows
        self.seed = seed
        self._gen = torch.Generator(device=self.device)
        self.slot_cache = AdapterSlotCache(slot_capacity, pool=checkpoint_pool,
                                           metrics=self.tracer.metrics)
        self.queue: "deque[ServeRequest]" = deque()
        self._enq_abs: Dict[int, float] = {}
        self._serve_t0 = 0.0
        self.serve_executor = serve_executor or default_executor()
        # the training side
        if device_pool is None:
            device_pool = DevicePool(None if self.device.type == "cuda" else [self.device])
        self.device_pool = device_pool
        self.executor = train_executor or SliceExecutor(tracer=self.tracer)
        self._runner = ClusterRunner(self.executor, self.device_pool, concurrent=None,
                                     tracer=self.tracer)
        self.concurrent = self._runner.concurrent

    # ---------------- Runner surface (the training side) -------------------

    def run(self, segments: Sequence, configs_by_cid: Dict, total_steps: Dict[int, int], cfg,
            base_params, *, seq: int, pool=None, data_iter_fn: Optional[Callable] = None,
            seed: int = 0, estimator=None, impl: Optional[str] = None,
            remat: Optional[str] = None, base_dtype: Optional[str] = None):
        """Execute planned training segments on the engine's device pool
        through its inner ``ClusterRunner`` (the reference's
        ``engine.py:643-670``); units held by ``serve_lease`` stay held."""
        return self._runner.run(
            segments, configs_by_cid, total_steps, cfg, base_params, seq=seq, pool=pool,
            data_iter_fn=data_iter_fn, seed=seed, estimator=estimator, impl=impl, remat=remat,
            base_dtype=base_dtype)

    @property
    def last_result(self):
        """The inner runner's last ``ClusterResult`` (its segment timings)."""
        return self._runner.last_result

    @contextmanager
    def serve_lease(self, n: int = 1):
        """Reserve the last ``n`` units of the device pool for decoding: the
        planner assigns units from 0 upward, so a plan over ``total - n``
        units never waits on them."""
        total = self.device_pool.total
        if not 1 <= n <= total:
            raise ValueError(f"serve_lease({n}) on a pool of {total} units")
        sl = self.device_pool.acquire_units(list(range(total - n, total)))
        try:
            yield sl
        finally:
            self.device_pool.release(sl)

    # ---------------- adapter staging --------------------------------------

    def publish(self, adapter_id: str, adapter_tree: dict, meta: dict) -> None:
        """Stage a finished adapter (a host tree, e.g. from
        ``extract_adapter``) with its ``{"rank", "alpha"}``."""
        self.slot_cache.publish(adapter_id, adapter_tree, meta)

    def publish_from_packed_state(self, pool, state_id: str, idx: int, adapter_id: str, *,
                                  rank: int, alpha: float) -> None:
        """Stage adapter ``idx`` of a whole-pack training snapshot
        (``CheckpointPool.save_packed_state``), as ``extract_adapter`` slices
        it (at the snapshot's rank bucket)."""
        lora, _opt, _meta = pool.load_packed_state(state_id)
        self.publish(adapter_id, extract_adapter(lora, idx), {"rank": rank, "alpha": alpha})

    def _row_lora(self, adapter) -> dict:
        """A request's width-1 adapter pack on the device, in the compute
        dtype: zeros at the rank bucket with the adapter's leaves (host
        trees, as staged) copied into their leading part -- what
        ``inject_adapter`` pads to, with only the adapter's own bytes
        crossing to the card. Leaves the adapter lacks stay zero."""

        def put(t, sub, in_blocks):
            if isinstance(t, dict):
                return {k: put(v, sub.get(k) if isinstance(sub, dict) else None,
                               in_blocks or k == "blocks") for k, v in t.items()}
            if sub is not None:
                src = (sub.detach() if isinstance(sub, torch.Tensor)
                       else torch.from_numpy(np.ascontiguousarray(np.asarray(sub, np.float32))))
                dst = t.select(1 if in_blocks else 0, 0)
                for ax in range(src.dim()):
                    dst = dst.narrow(ax, 0, src.shape[ax])
                dst.copy_(src)
            return t

        return put(lora_zeros(self.cfg, self.meta1, self.dtype, self.device), adapter, False)

    # ---------------- admission / retirement --------------------------------

    def submit(self, req: ServeRequest) -> None:
        """Enqueue a request; queue wait and TTFT count from here."""
        self._enq_abs[req.request_id] = time.perf_counter()
        self.queue.append(req)

    def _deadline_blown(self, req: ServeRequest) -> bool:
        if req.deadline_ms is None:
            return False
        enq = self._enq_abs.get(req.request_id)
        return enq is not None and (time.perf_counter() - enq) * 1e3 > req.deadline_ms

    def _scale_for(self, req: ServeRequest, meta: dict) -> float:
        rank = req.rank if req.rank is not None else meta.get("rank")
        alpha = req.alpha if req.alpha is not None else meta.get("alpha")
        if rank is None or alpha is None:
            raise ValueError(
                f"request {req.request_id} for adapter {req.adapter_id!r}: "
                "rank/alpha neither on the request nor in adapter metadata"
            )
        return float(alpha) / float(rank)

    def _rejected(self, req: ServeRequest, step: int, wall: float, err: str) -> ServeResult:
        self._enq_abs.pop(req.request_id, None)
        return ServeResult(
            request_id=req.request_id, adapter_id=req.adapter_id,
            tokens=np.zeros((0,), np.int32), n_prompt=int(np.asarray(req.prompt).shape[0]),
            arrival=req.arrival, admitted_step=step, finished_step=step,
            admitted_wall=wall, finished_wall=wall, error=err,
        )

    def _admit(self, req: ServeRequest, row: int, step: int, wall: float,
               stats: Optional[ServeStats] = None) -> Optional[ServeResult]:
        """Admit ``req`` into free row ``row``, or reject it (oversized
        prompt, unknown adapter, no rank/alpha) as an errored result --
        validated before any pin or latency sample. The admitted row either
        decodes (a one-shot prefill emitted its first token) or fills its
        cache chunk by chunk (``_prefill_advance``; the reference's
        ``engine.py:788-812``)."""
        prompt = np.asarray(req.prompt, np.int32)
        s_total = prompt.shape[0] + self.cfg.n_patch_tokens
        if s_total + req.max_new_tokens > self.smax:
            return self._rejected(req, step, wall, (
                f"request {req.request_id}: prompt {s_total} + {req.max_new_tokens} "
                f"new tokens exceeds smax={self.smax}"))
        try:
            adapter, ameta = self.slot_cache.get(req.adapter_id)
            scale = self._scale_for(req, ameta)
        except (KeyError, ValueError) as e:
            return self._rejected(req, step, wall, str(e))
        if stats is not None:
            stats.queue_wait.record(max(0.0, time.perf_counter() - self._enq_abs[req.request_id]))
        with self.tracer.span("serve.admit", cat="serve", track=f"row{row}",
                              request_id=req.request_id, adapter=req.adapter_id, step=step):
            self.slot_cache.pin(req.adapter_id)
            lora1 = self._row_lora(adapter)
            write_row_caches(self._lora, lora1, row)
            if (self.prefill_chunk is not None and not req.extra
                    and not self.cfg.n_patch_tokens and not self.cfg.is_encdec):
                self._rows[row] = _ActiveRow(
                    request=req, emitted=[], admitted_step=step, admitted_wall=wall,
                    n_prompt=int(prompt.shape[0]),
                    prefill=_PrefillState(
                        lora1=lora1, scale=scale,
                        scales=torch.full((1,), scale, dtype=torch.float32, device=self.device),
                        caches=init_caches(self.cfg, 1, s_total, torch.float32, self.device),
                        tokens=torch.from_numpy(prompt[None, :]).to(self.device),
                    ),
                )
                return None
            with self.tracer.span("serve.prefill", cat="serve", track=f"row{row}",
                                  request_id=req.request_id, n_prompt=int(prompt.shape[0])):
                pf = self.serve_executor.prefill_fn(self.cfg, 1, kcfg=self.kcfg1)
                lg, c1 = pf(self.base, lora1,
                            torch.full((1,), scale, dtype=torch.float32, device=self.device),
                            self._prefill_batch(req, prompt))
                write_row_caches(self._caches, pad_caches(c1, self.smax), row)
                first = self._first_token(lg, req)
        now = time.perf_counter()
        if stats is not None:
            stats.ttft.record(max(0.0, now - self._enq_abs[req.request_id]))
        self._scales[row] = scale
        self._temp[row] = req.temperature
        self._topk[row] = req.top_k
        self._tok[row, 0] = first
        self._pos[row] = s_total
        self._rows[row] = _ActiveRow(
            request=req, emitted=[first], admitted_step=step, admitted_wall=wall,
            n_prompt=int(prompt.shape[0]), last_emit_wall=now - self._serve_t0,
        )
        return None

    def _prefill_advance(self, row: int, step: int, stats: ServeStats) -> bool:
        """Run one prefill chunk of ``row``'s request (the reference's
        ``engine.py:860-917``) under a ``serve.prefill_chunk`` span on the
        row's track; after a chunk that is not the last, wait for the card,
        so that the span measures the chunk. The last chunk writes the
        row's caches (``write_row_caches``: the prompt's leading part of
        each sequence leaf, every fixed-size leaf, cast to the engine's
        dtypes), emits the first token and records TTFT. Returns True once
        the row decodes."""
        a = self._rows[row]
        ps = a.prefill
        n = ps.tokens.shape[1]
        c = min(self.prefill_chunk, n - ps.filled)
        with self.tracer.span("serve.prefill_chunk", cat="serve", track=f"row{row}",
                              request_id=a.request.request_id, step=step, pos=ps.filled,
                              chunk=c, n_prompt=n):
            fn = self.serve_executor.prefill_chunk_fn(self.cfg, 1, kcfg=self.kcfg1)
            lg, ps.caches = fn(self.base, ps.lora1, ps.scales,
                               ps.tokens[:, ps.filled : ps.filled + c], ps.caches, ps.filled)
            ps.filled += c
            if ps.filled < n:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                return False
            write_row_caches(self._caches, ps.caches, row)
            first = self._first_token(lg, a.request)
        now = time.perf_counter()
        stats.ttft.record(max(0.0, now - self._enq_abs[a.request.request_id]))
        self._scales[row] = ps.scale
        self._temp[row] = a.request.temperature
        self._topk[row] = a.request.top_k
        self._tok[row, 0] = first
        self._pos[row] = n
        a.emitted.append(first)
        a.last_emit_wall = now - self._serve_t0
        a.prefill = None
        return True

    def _keyed(self, stream: int, value: int) -> torch.Generator:
        """The engine's generator, re-seeded for one draw (``draw_seed``)."""
        return self._gen.manual_seed(draw_seed(self.seed, stream, value))

    def _first_token(self, lg: torch.Tensor, req: ServeRequest) -> int:
        """A request's first token from its prefill's (1, S, V) logits: the
        argmax, or at temperature > 0 a draw keyed by its request id, so
        that admission order does not change it."""
        if req.temperature <= 0.0:
            return int(torch.argmax(lg[0, -1, :]))
        return int(sample_tokens(
            lg[:, -1, :], torch.full((1,), float(req.temperature), device=self.device),
            torch.full((1,), int(req.top_k), dtype=torch.int32, device=self.device),
            self._keyed(FIRST_TOKEN, req.request_id))[0])

    def _prefill_batch(self, req: ServeRequest, prompt: np.ndarray) -> dict:
        """A request's width-1 prefill batch: its tokens and its ``extra``
        fields, on the engine's device."""
        extra = {k: torch.as_tensor(v).to(self.device) for k, v in (req.extra or {}).items()}
        return {"tokens": torch.from_numpy(prompt[None, :]).to(self.device), **extra}

    def _retire(self, row: int, step: int, wall: float, error: Optional[str] = None) -> ServeResult:
        active = self._rows[row]
        self._rows[row] = None
        self._scales[row] = 0.0
        self._temp[row] = 0.0
        self._topk[row] = 0
        self.slot_cache.unpin(active.request.adapter_id)
        self._enq_abs.pop(active.request.request_id, None)
        self.tracer.add_span(
            "serve.request", self._serve_t0 + active.admitted_wall, self._serve_t0 + wall,
            cat="serve", track=f"row{row}", request_id=active.request.request_id,
            adapter=active.request.adapter_id, tokens=len(active.emitted),
        )
        return ServeResult(
            request_id=active.request.request_id, adapter_id=active.request.adapter_id,
            tokens=np.asarray(active.emitted, np.int32), n_prompt=active.n_prompt,
            arrival=active.request.arrival, admitted_step=active.admitted_step,
            finished_step=step, admitted_wall=active.admitted_wall, finished_wall=wall,
            error=error,
        )

    # ---------------- the decode loop ---------------------------------------

    def serve(self, requests: Optional[Sequence[ServeRequest]] = None, *,
              max_steps: Optional[int] = None) -> ServeStats:
        """Drain a request trace (plus anything already ``submit()``ted).

        Virtual time is the decode-step counter: a request becomes
        admissible once ``step >= arrival``; freed rows are refilled before
        the next step. ``max_steps`` bounds the drain: rows still in flight,
        filling rows too, retire as partial results."""
        pending = deque(sorted(requests or (), key=lambda r: (r.arrival, r.request_id)))
        self._ensure_caches()
        stats = ServeStats()
        with torch.no_grad(), self.tracer.span(
            "serve.drain", cat="serve", track="serve",
            n_requests=len(pending) + len(self.queue), rows=self.rows,
        ):
            self._serve_drain(pending, stats, max_steps)
        stats.cache_hits = self.slot_cache.hits
        stats.cache_misses = self.slot_cache.misses
        stats.cache_evictions = self.slot_cache.evictions
        stats.results.sort(key=lambda r: r.request_id)
        return stats

    def _fill_rows(self, step: int, wall: float, stats: ServeStats) -> None:
        for row in range(self.rows):
            while self._rows[row] is None and self.queue:
                req = self.queue.popleft()
                if self._deadline_blown(req):
                    stats.results.append(self._rejected(req, step, wall, "deadline"))
                    continue
                rejected = self._admit(req, row, step, wall, stats)
                if rejected is not None:
                    stats.results.append(rejected)
                    continue
                a = self._rows[row]
                if a.prefill is None and len(a.emitted) >= req.max_new_tokens:
                    stats.tokens_emitted += len(a.emitted)
                    stats.results.append(self._retire(row, step, wall))

    def _serve_drain(self, pending, stats: ServeStats, max_steps: Optional[int]) -> None:
        qdepth = self.tracer.metrics.gauge("serve.queue_depth")
        t0 = time.perf_counter()
        self._serve_t0 = t0
        step = 0
        while True:
            wall = time.perf_counter() - t0
            while pending and pending[0].arrival <= step:
                req = pending.popleft()
                self._enq_abs.setdefault(req.request_id, time.perf_counter())
                self.queue.append(req)
            qdepth.set(len(self.queue))
            self._fill_rows(step, wall, stats)
            # one prefill chunk per filling row: admission is paid in bounded
            # slices between decode steps, not as one stall of every row
            for row in range(self.rows):
                a = self._rows[row]
                if (a is not None and a.prefill is not None
                        and self._prefill_advance(row, step, stats)
                        and len(a.emitted) >= a.request.max_new_tokens):
                    wall = time.perf_counter() - t0
                    stats.tokens_emitted += len(a.emitted)
                    stats.results.append(self._retire(row, step, wall))
            for row in range(self.rows):  # filling rows too
                a = self._rows[row]
                if a is not None and self._deadline_blown(a.request):
                    wall = time.perf_counter() - t0
                    stats.tokens_emitted += len(a.emitted)
                    stats.results.append(self._retire(row, step, wall, error="deadline"))
            active = [r for r in range(self.rows) if self._rows[r] is not None]
            if not active:
                if self.queue:
                    continue
                if pending:
                    step = int(np.ceil(pending[0].arrival))
                    continue
                break
            if max_steps is not None and stats.steps >= max_steps:
                wall = time.perf_counter() - t0
                for row in active:
                    stats.tokens_emitted += len(self._rows[row].emitted)
                    stats.results.append(self._retire(row, step, wall))
                break
            decoding = [r for r in active if self._rows[r].prefill is None]
            if not decoding:
                # chunk work only: virtual time still advances, so trace
                # arrivals keep landing in free rows while a prompt fills
                step += 1
                continue
            # the step runs every row; a filling row's stale token writes its
            # k/v at a stale position (masked, and overwritten by the row's
            # own later writes) and moves its SSM state, which its last
            # chunk's write replaces. Some row samples: the sampling step,
            # keyed by (seed, step)
            with self.tracer.span("serve.step", cat="serve", track="serve",
                                  step=step, batch=len(decoding)):
                t_host = time.perf_counter()
                next_tok, _lg = self._decode(bool(self._temp.any()), step, self.capture)
                stats.step_host.record(time.perf_counter() - t_host)
                next_tok = self._tokens_to_host(next_tok)
            step += 1
            stats.steps += 1
            stats.occupancy_sum += len(decoding)
            wall = time.perf_counter() - t0
            for row in decoding:
                a = self._rows[row]
                stats.itl.record(max(0.0, wall - a.last_emit_wall))
                a.last_emit_wall = wall
                a.emitted.append(int(next_tok[row]))
                self._tok[row, 0] = int(next_tok[row])
                self._pos[row] += 1
                if len(a.emitted) >= a.request.max_new_tokens:
                    stats.tokens_emitted += len(a.emitted)
                    stats.results.append(self._retire(row, step, wall))
        stats.wall_seconds = time.perf_counter() - t0

    # ---------------- the decode step ---------------------------------------

    def _ensure_caches(self) -> None:
        if self._caches is None:
            self._caches = init_caches(self.cfg, self.rows, self.smax, device=self.device)

    def _step_call(self, sampling: bool) -> Tuple[Callable, Tuple]:
        """The executor's eager step and its arguments: the base, the row
        pack, the caches and the device's row vectors (a sampling step's
        temperatures, top-k and generator too)."""
        v = self._dev
        args = (self.base, self._lora, v["scales"], self._caches, v["tok"], v["pos"])
        if sampling:
            fn = self.serve_executor.sample_step_fn(self.cfg, self.rows, kcfg=self.kcfg)
            return fn, args + (v["temp"], v["topk"], self._gen)
        return self.serve_executor.step_fn(self.cfg, self.rows, kcfg=self.kcfg), args

    def _capture(self, sampling: bool, fn: Callable, args: Tuple) -> _CapturedDecode:
        """Capture the greedy or the sampling step (``_CapturedDecode``),
        one capture at a time across threads, as the train steps'."""
        kind = "sampling" if sampling else "greedy"
        what = f"the captured {kind} decode step of {self.rows} rows"
        t0 = time.perf_counter()
        with _CAPTURING, self.tracer.span("serve.capture", cat="serve", track="serve",
                                          sampling=sampling):
            graph = _CapturedDecode(fn, args, self._gen if sampling else None, self._caches,
                                    self.device, what)
        self._graphs[sampling] = graph
        self.captures.append({"sampling": sampling, "seconds": time.perf_counter() - t0,
                              "pool_bytes": graph.pool_bytes,
                              "transient_bytes": graph.transient_bytes})
        return graph

    def _decode(self, sampling: bool, step: int, captured: bool):
        """One decode step of every row from the host's row vectors: (next
        tokens (R,) int32, logits (R, 1, V)) on the device, the caches
        advanced in place; a replay of the engine's graph (captured on first
        use) or the eager step. The vectors go to the card in one
        non-blocking copy from pinned memory: the host writes them only
        after the previous step's tokens came back, so after that copy ran."""
        self._rows_dev.copy_(self._rows_host, non_blocking=True)
        fn, args = self._step_call(sampling)
        graph = None
        if captured:
            graph = self._graphs.get(sampling) or self._capture(sampling, fn, args)
        if sampling:  # re-seeded just before the step: the warm-up drew too
            self._keyed(DECODE_STEP, step)
        if graph is not None:
            return graph()
        next_tok, lg, _ = fn(*args)
        return next_tok, lg

    def _tokens_to_host(self, next_tok: torch.Tensor) -> np.ndarray:
        """A step's tokens on the host, through the pinned buffer: waits for
        the step. The array is that buffer's view, rewritten by the next."""
        self._tok_out.copy_(next_tok, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self._tok_out_np

    def decode_once(self, tokens, positions, scales, temperature=None, top_k=None, *,
                    step: int = 0, eager: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decode step of every row outside a drain, on the row pack and
        caches as they stand (the caches advance in place): ``tokens``,
        ``positions``, ``scales`` and, for a sampling step keyed by
        ``step``, ``temperature`` and ``top_k`` are host sequences of
        ``rows`` values, staged as a drain stages them. The engine's graph
        runs unless ``eager`` or the engine does not capture. Returns (next
        tokens (R,) int32, logits (R, 1, V)) on the device; a graph's are
        its output buffers, which its next replay overwrites."""
        self._ensure_caches()
        if self.device.type == "cuda":  # the last step's copy has read the buffer
            torch.cuda.current_stream(self.device).synchronize()
        self._tok[:, 0] = tokens
        self._pos[:] = positions
        self._scales[:] = scales
        self._temp[:] = 0.0 if temperature is None else temperature
        self._topk[:] = 0 if top_k is None else top_k
        with torch.no_grad():
            return self._decode(temperature is not None, step, self.capture and not eager)

    # ---------------- sequential baseline -----------------------------------

    def serve_sequential(self, requests: Sequence[ServeRequest]) -> ServeStats:
        """One request at a time at batch width 1 (``generate()`` semantics)
        through the same executor: the baseline continuous batching is held
        against. Greedy whatever a request's temperature, as in the
        reference."""
        stats = ServeStats()
        t0 = time.perf_counter()
        with torch.no_grad():
            for req in sorted(requests, key=lambda r: (r.arrival, r.request_id)):
                stats.queue_wait.record(time.perf_counter() - t0)
                adapter, ameta = self.slot_cache.get(req.adapter_id)
                scale = self._scale_for(req, ameta)
                lora1 = self._row_lora(adapter)
                prompt = np.asarray(req.prompt, np.int32)
                s_total = prompt.shape[0] + self.cfg.n_patch_tokens
                scales = torch.full((1,), scale, dtype=torch.float32, device=self.device)
                pf = self.serve_executor.prefill_fn(self.cfg, 1, kcfg=self.kcfg1)
                lg, caches = pf(self.base, lora1, scales, self._prefill_batch(req, prompt))
                caches = pad_caches(caches, s_total + req.max_new_tokens)
                admitted = time.perf_counter() - t0
                stats.ttft.record(admitted)
                tok = torch.argmax(lg[:, -1, :], dim=-1).to(torch.int32)
                out = [int(tok[0])]
                fn = self.serve_executor.step_fn(self.cfg, 1, kcfg=self.kcfg1)
                t_prev = time.perf_counter()
                for i in range(req.max_new_tokens - 1):
                    pos = torch.tensor(s_total + i, dtype=torch.int64, device=self.device)
                    tok, _lg, caches = fn(self.base, lora1, scales, caches, tok[:, None], pos)
                    out.append(int(tok[0]))
                    stats.steps += 1
                    stats.occupancy_sum += 1
                    t_now = time.perf_counter()
                    stats.itl.record(t_now - t_prev)
                    t_prev = t_now
                wall = time.perf_counter() - t0
                stats.tokens_emitted += len(out)
                stats.results.append(ServeResult(
                    request_id=req.request_id, adapter_id=req.adapter_id,
                    tokens=np.asarray(out, np.int32), n_prompt=int(prompt.shape[0]),
                    arrival=req.arrival,
                    admitted_step=stats.steps, finished_step=stats.steps,
                    admitted_wall=admitted, finished_wall=wall,
                ))
        stats.wall_seconds = time.perf_counter() - t0
        stats.results.sort(key=lambda r: r.request_id)
        return stats
