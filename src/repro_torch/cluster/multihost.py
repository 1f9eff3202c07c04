"""Multi-host dispatch tier: process-per-host scale-out of the segment
protocol (the port of ``repro/cluster/multihost.py``).

The single-host :class:`~repro_torch.cluster.runner.ClusterRunner` is
thread-per-slice inside one process. This module runs the *same* segment
protocol across simulated (or, with another transport, real) hosts:

  * :class:`HostWorker` -- one ``spawn``-ed subprocess per host (never a
    fork: CUDA does not survive one). Each worker runs the port's own
    :class:`~repro_torch.cluster.executor.SliceExecutor` over a
    :class:`~repro_torch.cluster.pool.DevicePool` of its host's units, all
    on the device the dispatcher names for the host: card ``h %
    torch.cuda.device_count()`` by default (so on a one-card machine every
    host shares ``cuda:0``), the CPU only when the caller asks
    (``device="cpu"``). A worker asked for CUDA where none is visible reports
    ``"fatal"``; it never trains on the CPU instead.
  * a **message protocol** replaces the runner's in-memory shared state:
    segments, resumed adapter state and checkpoint-pool traffic cross a
    pipe transport (:func:`encode_segment`, :func:`encode_tree`,
    :func:`encode_record`). No CUDA tensor crosses it: a tree travels as
    host numpy arrays, a bf16 leaf as its raw 2-byte words with its dtype
    named (:class:`WireArray`), so neither side needs ``ml_dtypes``.
    Workers never touch the central
    :class:`~repro_torch.train.checkpoint.CheckpointPool`; a
    :class:`MemoryPool` captures their checkpoint writes and the dispatcher
    applies them only when the segment succeeds, which is what makes a
    killed worker recoverable: no partial state reaches the pool, so the
    segment's residual re-enters the preempt/resume path on a fresh worker.
  * :class:`HostDispatcher` -- ``(host, unit)`` addressing over
    :class:`HostUnit` and the :class:`~repro_torch.cluster.api.Runner`
    protocol: ``run`` executes planned segments process-per-host, and
    ``.executor`` / ``.device_pool`` plug into
    ``ExecutionEngine._run_adaptive``, whose host-class, host-state and
    join / drain hooks the dispatcher feeds.

A worker receives the base once, in its ``init`` message, places it on its
device and keeps it (the executor keys its graphs on the base's leaves), and
takes the dispatcher's numeric settings (TF32 flags, the float32 matmul
precision, the thread count) with it, so a segment computes the same bits in
the worker as in the dispatcher's process. The dispatcher builds the CUDA
kernels before it spawns a worker for a card, so workers only load them.

Plan host-aware (``ExecutionEngine(cm, g, host_size=...)``) so every
segment's device units stay within one host; the dispatcher rejects
host-spanning slices. A script that builds a dispatcher needs an ``if
__name__ == "__main__":`` guard: the spawned workers import the main module.
"""
from __future__ import annotations

import itertools
import os
import pickle
import threading
import time
import traceback
from dataclasses import dataclass
from queue import Empty
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import launches
from repro_torch.obs import NULL_TRACER, TraceCtx

# ---------------------------------------------------------------------------
# Wire protocol
# ---------------------------------------------------------------------------
#
# Every message is ``(kind, payload)``; payload *contents* are the typed
# dataclasses below (:class:`SegmentMsg`, :class:`RecordMsg`,
# :class:`CheckpointWrite`, :class:`KernelPolicy`,
# :class:`~repro_torch.obs.TraceCtx`) plus plain-python / numpy scalars and
# ``encode_tree``'d arrays, so the protocol survives pickling across process
# boundaries bit-exactly AND a field rename breaks loudly at construction
# instead of silently at a remote KeyError.
#
#   dispatcher -> worker:  ("init", state) ("run", request) ("ping", beat)
#                          ("stop", {})
#   worker -> dispatcher:  ("ready", info) ("done", result) ("err", failure)
#                          ("pong", reply) ("fatal", failure)  # startup death
#
# A "run" payload optionally carries ``"trace"``, a :class:`TraceCtx`
# naming the dispatcher-side parent span; the matching "done" reply then
# carries ``"spans"`` (the worker's finished span tree, as
# :meth:`repro_torch.obs.Span.to_dict` dicts) and ``"span_t0"`` (the worker
# root span's start on the *worker's* monotonic clock) so the dispatcher can
# rebase and stitch them under its own trace. Every "done" also carries
# ``"stats"``: the segment's peak device memory and whether it captured, and
# the worker's last ``init`` (bytes, seconds) and its graph captures.


class TransportError(RuntimeError):
    """The transport to a host worker failed."""


class WorkerDied(TransportError):
    """The host worker process died (crash / kill) with requests in flight."""


class RemoteSegmentError(RuntimeError):
    """A segment raised inside the worker; carries the remote traceback."""


@dataclass(frozen=True)
class WireArray:
    """A bf16 leaf on the wire: its raw 2-byte words as ``int16`` host
    memory, with the dtype named. numpy has no bf16 of its own, so this is
    how the leaf crosses bit for bit without ``ml_dtypes``."""

    dtype: str  # "bfloat16"
    bits: np.ndarray  # int16, the leaf's shape


def _encode_leaf(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return WireArray("bfloat16", t.contiguous().view(torch.int16).numpy())
        return t.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # an ml_dtypes array (a checkpoint read back)
        return WireArray("bfloat16", np.ascontiguousarray(a).view(np.int16))
    return a


def encode_tree(tree):
    """Nested-dict tree with every leaf on the host: a numpy array, or a
    :class:`WireArray` for a bf16 leaf -- the only array types the wire
    carries (bit-exact, device-free). ``None`` leaves pass through."""
    if isinstance(tree, dict):
        return {k: encode_tree(v) for k, v in tree.items()}
    return _encode_leaf(tree)


def decode_tree(tree):
    """:func:`encode_tree`'s inverse on the receiving side: a
    :class:`WireArray` becomes a bf16 CPU tensor; numpy leaves stay numpy
    (every consumer of a tree takes either)."""
    if isinstance(tree, dict):
        return {k: decode_tree(v) for k, v in tree.items()}
    if isinstance(tree, WireArray):
        if tree.dtype != "bfloat16":
            raise ValueError(f"no wire encoding for dtype {tree.dtype!r}")
        return torch.from_numpy(np.array(tree.bits)).view(torch.bfloat16)
    return tree


def _tree_nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, WireArray):
        return tree.bits.nbytes
    return 0 if tree is None else int(np.asarray(tree).nbytes)


@dataclass(frozen=True)
class SegmentMsg:
    """One :class:`~repro_torch.sched.engine.JobSegment` on the wire -- same
    fields, but a plain frozen dataclass so the wire format is decoupled
    from the scheduler's type (and picklable without importing it)."""

    job_id: int
    config_ids: Tuple[int, ...]
    degree: int
    start: float
    end: float
    start_steps: Tuple[int, ...]
    run_steps: int
    done_ids: Tuple[int, ...]
    preempted: bool
    units: Tuple[int, ...]


@dataclass(frozen=True)
class RecordMsg:
    """A finished segment's :class:`~repro_torch.sched.engine.JobRecord` on
    the wire (losses as host numpy; wall time measured on the worker
    clock)."""

    config_ids: Tuple[int, ...]
    degree: int
    start: float
    end: float
    wall_seconds: float
    losses: Optional[np.ndarray]


@dataclass(frozen=True)
class CheckpointWrite:
    """One captured checkpoint-pool write: a finished adapter
    (``kind="adapter"``) or preempted per-adapter training state
    (``kind="state"``). ``tree`` is ``encode_tree``'d (host memory)."""

    kind: str  # "adapter" | "state"
    adapter_id: str
    tree: dict
    meta: dict


@dataclass(frozen=True)
class HeartbeatMsg:
    """Dispatcher -> worker health ping. ``t_send`` is the dispatcher's
    monotonic clock at send time; the worker echoes it untouched so the RTT
    is computed on one clock (worker clocks aren't comparable)."""

    seq: int
    t_send: float


@dataclass(frozen=True)
class HealthReply:
    """Worker -> dispatcher pong: answered *inline* by the worker's message
    loop (segments run on a thread pool), so a missing reply means the loop
    itself is wedged or the process is gone -- hung and crashed workers look
    identical to the watchdog, which is the point."""

    host: int
    seq: int
    t_send: float
    in_flight: int


# membership states of one host, as seen by the dispatcher's watchdog
HOST_ALIVE = "ALIVE"        # answering heartbeats (or heartbeats disabled)
HOST_SUSPECT = "SUSPECT"    # missed a heartbeat deadline; backoff running
HOST_DEAD = "DEAD"          # declared dead (backoff exhausted / drained out)
HOST_DRAINING = "DRAINING"  # graceful retirement in progress


@dataclass(frozen=True)
class KernelPolicy:
    """The kernel policy a segment must run under (``--impl`` / ``--remat`` /
    ``--quant``), shipped with every run request so host workers execute the
    kernel tier the caller selected."""

    impl: Optional[str] = None  # None/"auto" = executor default
    remat: Optional[str] = None  # None = executor default ("save")
    base_dtype: Optional[str] = None  # "int8"/"nf4" = quantized frozen base


_SEGMENT_FIELDS = (
    "job_id", "config_ids", "degree", "start", "end",
    "start_steps", "run_steps", "done_ids", "preempted", "units",
)


def encode_segment(seg) -> SegmentMsg:
    return SegmentMsg(**{f: getattr(seg, f) for f in _SEGMENT_FIELDS})


def decode_segment(m: SegmentMsg):
    from repro_torch.sched.engine import JobSegment

    return JobSegment(**{f: getattr(m, f) for f in _SEGMENT_FIELDS})


def encode_record(rec) -> RecordMsg:
    return RecordMsg(
        config_ids=tuple(rec.job.config_ids),
        degree=rec.job.degree,
        start=rec.job.start,
        end=rec.job.end,
        wall_seconds=rec.wall_seconds,
        losses=None if rec.final_losses is None else np.asarray(rec.final_losses),
    )


def decode_record(m: RecordMsg):
    from repro_torch.sched.engine import JobRecord
    from repro_torch.sched.planner import ScheduledJob

    return JobRecord(
        ScheduledJob(tuple(m.config_ids), m.degree, m.start, m.end),
        m.wall_seconds,
        m.losses,
    )


class MemoryPool:
    """Worker-side stand-in for the central checkpoint pool.

    Reads come from the states the dispatcher shipped with the segment;
    writes are *captured*, not applied -- the dispatcher replays them onto
    the real pool only after the segment's ``done`` message arrives. A
    worker killed mid-segment therefore leaves the central pool exactly as
    it was, and the re-dispatched segment resumes from unchanged state."""

    def __init__(self, states: Optional[Dict[str, Tuple[dict, dict]]] = None):
        self.states = dict(states or {})
        self.writes: List[CheckpointWrite] = []

    def has_adapter_state(self, adapter_id: str) -> bool:
        return adapter_id in self.states

    def load_adapter_state(self, adapter_id: str):
        tree, meta = self.states[adapter_id]
        return decode_tree(tree), meta

    def save_adapter_state(self, adapter_id: str, state_tree, meta: dict):
        self.writes.append(CheckpointWrite("state", adapter_id, encode_tree(state_tree), meta))

    def save_adapter(self, adapter_id: str, adapter_tree, meta: dict):
        self.writes.append(CheckpointWrite("adapter", adapter_id, encode_tree(adapter_tree), meta))


# ---------------------------------------------------------------------------
# Numeric settings: the dispatcher's, applied in every worker
# ---------------------------------------------------------------------------


def numeric_settings() -> Dict[str, Any]:
    """This process's settings that change what a step computes: a spawned
    interpreter starts from PyTorch's defaults, so the worker applies these
    (:func:`apply_numeric_settings`) before any segment. On the CPU the
    thread count matters too: the BLAS splits some products by thread."""
    mm = torch.backends.cuda.matmul
    return {
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "cuda_matmul_allow_tf32": mm.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "allow_bf16_reduced_precision_reduction": mm.allow_bf16_reduced_precision_reduction,
        "allow_fp16_reduced_precision_reduction": mm.allow_fp16_reduced_precision_reduction,
        "num_threads": torch.get_num_threads(),
    }


def apply_numeric_settings(s: Dict[str, Any]) -> None:
    mm = torch.backends.cuda.matmul
    torch.set_float32_matmul_precision(s["float32_matmul_precision"])
    mm.allow_tf32 = s["cuda_matmul_allow_tf32"]
    torch.backends.cudnn.allow_tf32 = s["cudnn_allow_tf32"]
    mm.allow_bf16_reduced_precision_reduction = s["allow_bf16_reduced_precision_reduction"]
    mm.allow_fp16_reduced_precision_reduction = s["allow_fp16_reduced_precision_reduction"]
    if torch.get_num_threads() != s["num_threads"]:
        torch.set_num_threads(s["num_threads"])


# ---------------------------------------------------------------------------
# Frames on a pipe
# ---------------------------------------------------------------------------
#
# A process transport moves each message as one frame on an OS pipe: a
# small pickled header (pickle protocol 5, every contiguous array's bytes
# left out of band), then those bytes written straight to the pipe and read
# straight into buffers of the right size on the other side. A GB-sized
# ``init`` then costs about one copy into the pipe and one out of it,
# where a ``multiprocessing.Queue`` pickles the arrays in band and reads
# them back in pieces (~0.25 GB/s on an 8-core host against ~1 GB/s).

_PIPE_BYTES = 1 << 20  # the pipe's buffer: 16x Linux's default, fewer switches


def _widen(conn) -> None:
    """Enlarge the pipe behind ``conn`` to _PIPE_BYTES where the OS lets
    this process (Linux; within ``/proc/sys/fs/pipe-max-size``)."""
    import fcntl

    try:
        fcntl.fcntl(conn.fileno(), getattr(fcntl, "F_SETPIPE_SZ", 1031), _PIPE_BYTES)
    except OSError:
        pass  # the default buffer works, more slowly


def _write_all(fd: int, buf: memoryview) -> None:
    while len(buf):
        buf = buf[os.write(fd, buf):]


def _read_into(fd: int, buf: memoryview) -> None:
    got = 0
    while got < len(buf):
        n = os.readv(fd, [buf[got:]])
        if n == 0:
            raise EOFError("the pipe closed in the middle of a message")
        got += n


def send_frame(conn, msg) -> None:
    """Write ``msg`` to the pipe of ``conn`` (a ``multiprocessing``
    ``Connection``) as one frame. One writer at a time per pipe."""
    bufs: List[pickle.PickleBuffer] = []
    head = pickle.dumps(msg, protocol=5, buffer_callback=bufs.append)
    raws = [b.raw() for b in bufs]
    conn.send_bytes(pickle.dumps((head, [r.nbytes for r in raws])))
    for r in raws:
        _write_all(conn.fileno(), r)


def recv_frame(conn):
    """Read one frame of :func:`send_frame` from ``conn``; its arrays live in
    buffers of their own (writable)."""
    head, sizes = pickle.loads(conn.recv_bytes())
    bufs = []
    for n in sizes:
        b = np.empty(n, np.uint8)
        _read_into(conn.fileno(), memoryview(b))
        bufs.append(b)
    return pickle.loads(head, buffers=bufs)


# ---------------------------------------------------------------------------
# Worker process (one simulated host)
# ---------------------------------------------------------------------------


def _open_device(host_id: int, device: str) -> torch.device:
    """The worker's device, made current; raises where it does not exist
    (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"host {host_id} was asked to run on {device}, but this process sees no "
                "CUDA device (torch.cuda.is_available() is false)")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"host {host_id} was asked to run on {device}, but this "
                               f"process sees {torch.cuda.device_count()} CUDA device(s)")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)  # the context now, not inside the first segment
    return dev


def _host_tensor(a) -> torch.Tensor:
    """A decoded leaf as a CPU tensor, sharing the unpickled array's memory
    (no second host copy of a GB-sized base)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _placed(state: Dict[str, Any], dev: torch.device) -> Dict[str, Any]:
    """An ``init`` payload with its base decoded and placed on ``dev``."""
    from repro_torch.tree import tree_map

    state = dict(state)
    base = state.get("base")
    if base is not None:
        state["base"] = tree_map(lambda a: _host_tensor(a).to(dev), decode_tree(base))
    return state


def _warm_up(dev: torch.device) -> None:
    """One packed step of the reduced qwen25-7b on ``dev``, captured on a
    card. A fresh interpreter's first step imports and registers much of
    PyTorch besides its own device work (16.5-17.2 s for a worker's first
    8-layer capture against 0.7-1.1 s in a process that has stepped before,
    H100 80GB HBM3, 700 W); a worker takes this step while its base
    arrives, so its first segment does not."""
    from repro_torch.cluster.executor import SliceExecutor
    from repro_torch.cluster.pool import DevicePool
    from repro_torch.configs.base import LoraConfig, get_config, reduced
    from repro_torch.models.model import init_model

    cfg = reduced(get_config("qwen25-7b"))
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    base, _ = init_model(0, cfg, None, dtype=dtype, device=dev)
    SliceExecutor().train_pack(cfg, [LoraConfig(rank=8, seq_len=16)], n_steps=1, seq=16,
                               base=base, slice_=DevicePool([dev]).acquire(1))


def _worker_main(host_id: int, n_devices: int, device: str, inbox, outbox) -> None:
    """Entry point of one simulated host: ``n_devices`` units, all on
    ``device``; ``inbox`` / ``outbox`` are the ends of its two pipes (one
    frame a message, :func:`recv_frame` / :func:`send_frame`)."""
    out_lock = threading.Lock()

    def put(msg) -> None:  # segment threads and the loop share the outbox
        with out_lock:
            send_frame(outbox, msg)

    try:
        dev = _open_device(host_id, device)
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.cluster.executor import SliceExecutor
        from repro_torch.cluster.pool import DevicePool

        executor = SliceExecutor()
        dpool = DevicePool([dev] * n_devices)
        put(("ready", {"host": host_id, "devices": n_devices, "device": str(dev)}))
    except BaseException as e:  # noqa: BLE001 -- shipped to the dispatcher
        put(("fatal", {"host": host_id, "error": repr(e),
                       "traceback": traceback.format_exc()}))
        return

    # the warm-up step runs while the first init arrives; every segment
    # waits for it (and fails with its error), so no segment's launch
    # counts take in the warm-up's
    warm_err: List[BaseException] = []

    def warm() -> None:
        try:
            _warm_up(dev)
            if dev.type == "cuda":
                from repro_torch.cluster.executor import _CAPTURING

                with _CAPTURING:  # never beside another thread's capture
                    torch.cuda.empty_cache()  # the warm-up's graph and base
        except BaseException as e:  # noqa: BLE001 -- raised by the first segment
            warm_err.append(e)

    warmer = threading.Thread(target=warm, name=f"warm-host-{host_id}", daemon=True)
    warmer.start()
    state: Dict[str, Any] = {}
    init_stats: Dict[str, Any] = {}
    # one worker-side tracer shared by every traced request: span stacks
    # are thread-local and pop_root flushes one request's tree, so
    # concurrent do_run threads don't interleave. Created lazily on the
    # first traced request; untraced runs never pay for it.
    wtracer_box: List[Any] = [None]
    wtracer_lock = threading.Lock()

    def do_run(payload: Dict[str, Any]) -> None:
        rid = payload["req"]
        try:
            warmer.join()
            if warm_err:
                raise RuntimeError(f"host {host_id}'s warm-up step failed") from warm_err[0]
            seg = decode_segment(payload["seg"])
            policy = payload.get("policy") or KernelPolicy()
            trace_ctx = payload.get("trace")
            mempool = MemoryPool(payload["states"]) if payload["has_pool"] else None
            spans = span_t0 = None
            root_cm = None
            if trace_ctx is not None:
                from repro_torch.obs import Tracer

                with wtracer_lock:
                    if wtracer_box[0] is None:
                        wtracer_box[0] = Tracer()
                        executor.tracer = wtracer_box[0]
                wtracer = wtracer_box[0]
                root_cm = wtracer.span(f"host{host_id}.segment", cat="host",
                                       job_id=seg.job_id, req=rid)
            counts0 = launches.snapshot()
            with dpool.lease_units(payload["units"]) as slice_:
                if root_cm is not None:
                    root = root_cm.__enter__()
                try:
                    rec = executor.run_segment(
                        seg, state["configs_by_cid"], state["total_steps"], state["cfg"],
                        state["base"], seq=state["seq"], pool=mempool,
                        data_iter_fn=state["data_iter_fn"], seed=state["seed"], slice_=slice_,
                        impl=policy.impl, remat=policy.remat, base_dtype=policy.base_dtype,
                    )
                finally:
                    if root_cm is not None:
                        root_cm.__exit__(None, None, None)
                        spans = wtracer.pop_root(root.span_id)
                        span_t0 = root.start
            # what this process launched over the segment (with several
            # segments in flight on one worker, theirs too)
            counts = {k: n - counts0.get(k, 0) for k, n in launches.snapshot().items()
                      if n != counts0.get(k, 0)}
            stats = {"peak_bytes": rec.peak_bytes, "captured": rec.captured, "launches": counts,
                     "captures": list(executor.captures), **init_stats}
            if dev.type == "cuda":
                stats["reserved_bytes"] = torch.cuda.memory_reserved(dev)
            done = {
                "req": rid,
                "host": host_id,
                "record": encode_record(rec),
                "writes": mempool.writes if mempool is not None else [],
                "stats": stats,
            }
            if spans is not None:
                done["spans"] = spans
                done["span_t0"] = span_t0
            put(("done", done))
        except BaseException as e:  # noqa: BLE001 -- shipped to the dispatcher
            put(("err", {"req": rid, "host": host_id, "error": repr(e),
                         "traceback": traceback.format_exc()}))

    tpe = ThreadPoolExecutor(max_workers=max(n_devices, 1))
    n_running = [0]
    n_lock = threading.Lock()

    def counted_run(payload):
        try:
            do_run(payload)
        finally:
            with n_lock:
                n_running[0] -= 1

    try:
        while True:
            try:
                kind, payload = recv_frame(inbox)
            except (EOFError, OSError):
                break  # the dispatcher's end is gone
            if kind == "stop":
                break
            if kind == "init":
                t0 = time.perf_counter()
                if state:
                    # a new workload: drop the old one's graphs and placed
                    # base before this one's base lands on the device
                    state = {}
                    executor.clear()
                    if dev.type == "cuda":
                        torch.cuda.empty_cache()
                apply_numeric_settings(payload["numerics"])
                state = _placed(payload, dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                # sent_wall: the dispatcher's wall clock at the send; one
                # machine's clock on both sides here
                init_stats = {"init_place_s": time.perf_counter() - t0,
                              "init_s": time.time() - payload["sent_wall"]}
            elif kind == "run":
                with n_lock:
                    n_running[0] += 1
                tpe.submit(counted_run, payload)
            elif kind == "ping":
                # answered inline, never queued behind segments: a worker
                # that stops ponging has a wedged loop, not a busy one
                put(("pong", HealthReply(host=host_id, seq=payload.seq,
                                         t_send=payload.t_send, in_flight=n_running[0])))
    finally:
        tpe.shutdown(wait=True)


class ProcessTransport:
    """Pipe transport to one :func:`_worker_main` subprocess, started with
    the ``spawn`` context (a fresh interpreter: CUDA cannot survive a fork).
    Each direction is one OS pipe carrying frames (:func:`send_frame`);
    ``send`` queues a message for this transport's feeder thread and
    returns, as a ``multiprocessing.Queue`` does, so a heartbeat never waits
    behind a GB-sized ``init`` in its caller."""

    def __init__(self, host_id: int, n_devices: int, device: str = "cuda:0"):
        import multiprocessing as mp
        import queue

        ctx = mp.get_context("spawn")
        in_r, self._in_w = ctx.Pipe(duplex=False)
        self._out_r, out_w = ctx.Pipe(duplex=False)
        _widen(self._in_w)
        self.proc = ctx.Process(
            target=_worker_main,
            args=(host_id, n_devices, str(device), in_r, out_w),
            daemon=True,  # never outlive the dispatcher process
            name=f"plora-host-{host_id}",
        )
        self.proc.start()
        # the child holds its ends now: once it dies, a write here fails
        # (EPIPE) and a read sees the end of the pipe
        in_r.close()
        out_w.close()
        self._outq: "queue.Queue" = queue.Queue()
        self._feeder = threading.Thread(target=self._feed, name=f"feed-host-{host_id}",
                                        daemon=True)
        self._feeder.start()

    def _feed(self) -> None:
        while True:
            msg = self._outq.get()
            if msg is None:
                return
            try:
                send_frame(self._in_w, msg)
            except OSError:  # the worker is gone: what is queued goes nowhere
                return

    def send(self, msg) -> None:
        self._outq.put(msg)

    def recv(self, timeout: Optional[float] = None):
        if not self._out_r.poll(timeout):
            raise Empty
        return recv_frame(self._out_r)

    def alive(self) -> bool:
        return self.proc.is_alive()

    def kill(self) -> None:
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(timeout=5)
        self._outq.put(None)  # the feeder ends (a write under way fails: EPIPE)

    def join(self, timeout: Optional[float] = None) -> None:
        self.proc.join(timeout)


# ---------------------------------------------------------------------------
# Dispatcher side
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HostUnit:
    """One device unit addressed as a ``(host, local unit)`` pair -- the
    virtual 'device' objects backing the dispatcher's :class:`DevicePool`."""

    host: int
    local: int


def _send_with_retry(transport, msg, *, deadline: float = 30.0, retries: int = 2) -> None:
    """Wire send with a per-message deadline and bounded retry: transient
    transport hiccups back off and retry; a send still failing at the
    deadline (or out of attempts) raises :class:`TransportError`."""
    t0 = time.perf_counter()
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            transport.send(msg)
            return
        except Exception as e:  # noqa: BLE001 -- retried, then re-raised
            last = e
            if time.perf_counter() - t0 >= deadline or attempt >= retries:
                break
            time.sleep(min(0.05 * (2 ** attempt), 0.5))
    raise TransportError(f"send failed after {attempt + 1} attempt(s): {last!r}") from last


class _Reply:
    """Future for one in-flight segment request."""

    __slots__ = ("_evt", "_kind", "_payload", "_err")

    def __init__(self):
        self._evt = threading.Event()
        self._kind = self._payload = self._err = None

    def resolve(self, kind: str, payload: Dict[str, Any]) -> None:
        self._kind, self._payload = kind, payload
        self._evt.set()

    def fail(self, err: BaseException) -> None:
        self._err = err
        self._evt.set()

    def wait(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        if not self._evt.wait(timeout):
            raise TransportError(f"no reply within the {timeout:.0f}s request deadline")
        if self._err is not None:
            raise self._err
        if self._kind == "err":
            raise RemoteSegmentError(
                f"segment failed on host {self._payload['host']}: "
                f"{self._payload['error']}\n--- remote traceback ---\n"
                f"{self._payload['traceback']}"
            )
        return self._payload


class HostWorker:
    """Dispatcher-side handle for one host: transport + pump thread + the
    in-flight request table. A dead worker fails all in-flight requests with
    :class:`WorkerDied`; the dispatcher then spawns a *new* ``HostWorker``
    for the host (the handle itself is never resurrected)."""

    def __init__(self, host_id: int, n_devices: int, transport, *,
                 on_pong: Optional[Callable] = None, send_deadline: float = 30.0,
                 send_retries: int = 2):
        self.host_id = host_id
        self.n_devices = n_devices
        self.transport = transport
        self.on_pong = on_pong
        self.send_deadline = send_deadline
        self.send_retries = send_retries
        self.ready = threading.Event()
        self.fatal: Optional[Dict[str, Any]] = None
        self.init_version = -1
        self.dead = False
        # did this worker die with requests in flight? Idle deaths (e.g. a
        # spot reclaim between segments) don't burn a restart credit.
        self.died_in_flight = False
        self._lock = threading.Lock()
        self._pending: Dict[int, _Reply] = {}
        self._pump = threading.Thread(target=self._pump_loop, name=f"pump-host-{host_id}",
                                      daemon=True)
        self._pump.start()

    # -- request lifecycle --------------------------------------------------

    def send(self, msg) -> None:
        """Deadline-bounded wire send (shared by requests / init / pings)."""
        _send_with_retry(self.transport, msg, deadline=self.send_deadline,
                         retries=self.send_retries)

    def request(self, rid: int, msg) -> _Reply:
        reply = _Reply()
        with self._lock:
            if self.dead:
                raise WorkerDied(f"host {self.host_id} worker is dead")
            self._pending[rid] = reply
        try:
            self.send(msg)
        except Exception as e:  # queue to a dead process
            with self._lock:
                self._pending.pop(rid, None)
            raise WorkerDied(f"host {self.host_id} send failed: {e!r}") from e
        return reply

    def in_flight(self) -> int:
        with self._lock:
            return len(self._pending)

    def wait_ready(self, timeout: float) -> None:
        if not self.ready.wait(timeout):
            raise TransportError(f"host {self.host_id} worker not ready after {timeout:.0f}s")
        if self.fatal is not None:
            # the worker reported a startup exception: deterministic, so a
            # respawn would just fail the same way -- no retry
            raise TransportError(
                f"host {self.host_id} worker failed to start: "
                f"{self.fatal['error']}\n{self.fatal['traceback']}"
            )
        if self.dead:
            # hard-died before 'ready' (SIGKILL / OOM / segfault during
            # startup): possibly transient, so surface it as WorkerDied --
            # the segment retry loop respawns, bounded by max_restarts
            raise WorkerDied(f"host {self.host_id} worker died during startup")

    # -- pump ---------------------------------------------------------------

    def _fail_all(self) -> None:
        with self._lock:
            self.dead = True
            pending = list(self._pending.values())
            self._pending.clear()
            if pending:
                self.died_in_flight = True
        err = WorkerDied(f"host {self.host_id} worker died")
        for reply in pending:
            reply.fail(err)
        self.ready.set()  # unblock wait_ready; fatal/dead is checked there

    def _pump_loop(self) -> None:
        while True:
            try:
                msg = self.transport.recv(timeout=0.2)
            except Empty:
                if not self.transport.alive():
                    self._fail_all()
                    return
                continue
            except Exception:  # truncated pickle from a killed writer, EOF
                self._fail_all()
                return
            kind, payload = msg
            if kind == "ready":
                self.ready.set()
            elif kind == "pong":
                if self.on_pong is not None:
                    self.on_pong(self.host_id, payload)
            elif kind == "fatal":
                self.fatal = payload
                self._fail_all()
                return
            else:  # "done" / "err"
                with self._lock:
                    reply = self._pending.pop(payload["req"], None)
                if reply is not None:
                    reply.resolve(kind, payload)


class DispatchExecutor:
    """`SliceExecutor`-shaped facade that executes segments *remotely*.

    ``run_segment`` ships the segment (plus any resumed adapter state read
    from the central pool) to the worker owning the slice's host, blocks on
    the reply, applies the returned checkpoint writes to the central pool,
    and returns a ``JobRecord`` -- so ``ClusterRunner``'s dispatch loop and
    the engine's adaptive loop drive multi-host execution without changes.
    A :class:`WorkerDied` mid-segment restarts the host (bounded by the
    dispatcher's ``max_restarts``) and re-dispatches: the segment's inputs
    are still in the pool (writes are success-atomic), so the retry is the
    existing preempt/resume path and no step is lost or double-counted."""

    def __init__(self, dispatcher: "HostDispatcher"):
        self.disp = dispatcher
        # settable so ClusterRunner's tracer-adoption contract applies to
        # the remote executor exactly like the local one
        self.tracer = dispatcher.tracer

    def pack_template(self, cfg, configs, seed: int = 0, device=None):
        """Pre-warm hook: templates are built inside each worker (their
        cache lives with the devices), so the dispatcher side is a no-op."""
        return None

    def run_segment(self, seg, configs_by_cid: Dict, total_steps: Dict[int, int], cfg,
                    base_params, *, seq: int, pool, data_iter_fn: Optional[Callable] = None,
                    seed: int = 0, slice_=None, impl: Optional[str] = None,
                    remat: Optional[str] = None, base_dtype: Optional[str] = None):
        d = self.disp
        if slice_ is None:
            raise ValueError("multi-host dispatch needs an explicit mesh slice "
                             "(unplanned segments have no host)")
        hosts = {dev.host for dev in slice_.devices}
        if len(hosts) != 1:
            raise RuntimeError(
                f"segment units {slice_.units} span hosts {sorted(hosts)}; plan with "
                "ExecutionEngine(..., host_size=...) so every job's units stay on one host")
        host = hosts.pop()
        local_units = tuple(sorted(dev.local for dev in slice_.devices))
        d._prepare(cfg, configs_by_cid, total_steps, base_params, seq, seed, data_iter_fn)
        states: Dict[str, Tuple[dict, dict]] = {}
        for cid, st0 in zip(seg.config_ids, seg.start_steps):
            if st0 > 0 and pool is not None:
                aid = f"{cid:04d}"
                if pool.has_adapter_state(aid):
                    tree, meta = pool.load_adapter_state(aid)
                    states[aid] = (encode_tree(tree), dict(meta))
        base_payload = {
            "seg": encode_segment(seg),
            "units": local_units,
            "states": states,
            "has_pool": pool is not None,
            # the caller's kernel policy rides with every segment: workers
            # run exactly the tier the dispatcher-side planner selected
            "policy": KernelPolicy(impl=None if impl == "auto" else impl, remat=remat,
                                   base_dtype=base_dtype),
        }
        tracer = self.tracer
        with tracer.span("dispatch.segment", cat="dispatch", track=f"host{host}",
                         job_id=seg.job_id, host=host, units=list(slice_.units)) as dspan:
            if tracer.enabled:
                base_payload["trace"] = tracer.context()
            t_start = time.perf_counter()
            last_died: Optional[WorkerDied] = None
            for _attempt in range(d.max_restarts + 1):
                rid = next(d._rid)
                try:
                    worker = d._ensure_host(host)
                    t_send = time.perf_counter()
                    reply = worker.request(rid, ("run", dict(base_payload, req=rid)))
                    out = reply.wait()
                except WorkerDied as e:
                    last_died = e
                    continue  # respawn + re-dispatch: preempt/resume path
                rec = decode_record(out["record"])
                if pool is not None:
                    for w in out["writes"]:
                        tree = decode_tree(w.tree)
                        if w.kind == "adapter":
                            pool.save_adapter(w.adapter_id, tree, w.meta)
                        else:
                            pool.save_adapter_state(w.adapter_id, tree, w.meta)
                if tracer.enabled and out.get("spans"):
                    # worker clocks aren't comparable: rebase so the
                    # worker's root span starts at the moment this side
                    # handed the request to the transport
                    tracer.ingest(out["spans"], offset=t_send - out["span_t0"],
                                  parent_id=dspan.span_id, track_prefix=f"host{host}/")
                stats = out.get("stats") or {}
                # the worker's launches join this process's counts: a path
                # driven through workers counts as one driven here does
                launches.add(stats.get("launches", {}))
                rec.peak_bytes = stats.get("peak_bytes")
                rec.captured = bool(stats.get("captured", False))
                d.host_stats[host].update(stats)
                # dispatcher-clock interval (worker clocks aren't
                # comparable); ClusterRunner/_run_adaptive re-base these
                # against their t0
                rec.real_start = t_start
                rec.real_end = time.perf_counter()
                return rec
            raise WorkerDied(
                f"host {host} died {d.max_restarts + 1} times executing job {seg.job_id} "
                f"(segment of configs {seg.config_ids})") from last_died


class HostDispatcher:
    """Process-per-host execution of planned segments.

    Implements the :class:`~repro_torch.cluster.api.Runner` protocol: ``run``
    executes a batch of segments (via an internal ``ClusterRunner`` whose
    executor is remote), and ``.executor`` / ``.device_pool`` /
    ``.concurrent`` plug into ``ExecutionEngine._run_adaptive`` directly.

    ``hosts`` is either a per-host device-count list (``[2, 2]`` = two
    2-unit hosts) or an int paired with ``devices_per_host``. Global unit
    ``u`` maps to ``(host, local)`` via the cumulative offsets; plans must
    keep each job on one host (``ExecutionEngine(host_size=...)``).
    ``device``: None (or ``"cuda"``) runs host ``h`` on card ``h %
    torch.cuda.device_count()``; ``"cpu"`` runs every host on the CPU.

    ``transport_factory(host_id, n_devices)`` defaults to spawning a real
    subprocess (:class:`ProcessTransport`) on the host's device; tests
    inject in-memory fakes. Workers are started lazily, restarted on death
    (``max_restarts`` per segment), and torn down by ``close()`` / the
    context manager. ``host_stats[h]`` keeps what was measured of host
    ``h``'s worker: spawns, spawn-to-ready seconds, ``init`` bytes and
    seconds, its graph captures and its last segment's peak memory."""

    def __init__(
        self,
        hosts: Union[int, Sequence[int]],
        devices_per_host: int = 1,
        *,
        transport_factory: Optional[Callable] = None,
        device: Optional[str] = None,
        max_restarts: int = 2,
        start_timeout: float = 300.0,
        tracer=None,
        host_classes: Optional[Sequence[str]] = None,
        heartbeat_interval: float = 0.0,
        heartbeat_timeout: Optional[float] = None,
        heartbeat_dead_after: int = 3,
        send_deadline: float = 30.0,
        send_retries: int = 2,
    ):
        if isinstance(hosts, int):
            hosts = [devices_per_host] * hosts
        self.hosts: Tuple[int, ...] = tuple(int(n) for n in hosts)
        if not self.hosts or any(n <= 0 for n in self.hosts):
            raise ValueError(f"bad host layout {self.hosts}")
        if host_classes is None:
            host_classes = [""] * len(self.hosts)
        if len(host_classes) != len(self.hosts):
            raise ValueError(f"{len(host_classes)} host classes for {len(self.hosts)} hosts")
        if device is not None and torch.device(device).type not in ("cuda", "cpu"):
            raise ValueError(f"hosts run on 'cuda' or 'cpu', not {device!r}")
        self.device = device
        self.host_classes: Tuple[str, ...] = tuple(str(c) for c in host_classes)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.max_restarts = max_restarts
        self.start_timeout = start_timeout
        self._transport_factory = transport_factory or (
            lambda host, n: ProcessTransport(host, n, self.host_device(host)))
        self._built = transport_factory is not None  # fakes need no kernels
        self.n_restarts = 0
        self._rid = itertools.count()
        self._workers: List[Optional[HostWorker]] = [None] * len(self.hosts)
        self._host_locks = [threading.Lock() for _ in self.hosts]
        self.host_stats: List[Dict[str, Any]] = [{} for _ in self.hosts]
        self._payload: Optional[Dict[str, Any]] = None
        self._payload_token = None
        self._payload_refs: Tuple = ()  # pins id()s used in the memo token
        self._payload_version = 0
        self._payload_bytes = 0
        self._payload_encode_s = 0.0
        self._prep_lock = threading.Lock()
        self.send_deadline = send_deadline
        self.send_retries = send_retries

        from repro_torch.cluster.pool import DevicePool

        units = [HostUnit(h, i) for h, n in enumerate(self.hosts) for i in range(n)]
        self.device_pool = DevicePool(devices=units)
        # global unit ids per host (stable: add_host only appends)
        self._host_units: List[Tuple[int, ...]] = []
        off = 0
        for n in self.hosts:
            self._host_units.append(tuple(range(off, off + n)))
            off += n
        self.executor = DispatchExecutor(self)
        self.concurrent = True
        self.last_result = None

        # -- membership / health ------------------------------------------
        self._membership_lock = threading.Lock()
        self._membership_subs: List[Callable] = []
        self._host_state: List[str] = [HOST_ALIVE] * len(self.hosts)
        self._last_pong: List[float] = [0.0] * len(self.hosts)
        self._hb_misses: List[int] = [0] * len(self.hosts)
        self.heartbeat_interval = float(heartbeat_interval)
        self.heartbeat_timeout = (float(heartbeat_timeout) if heartbeat_timeout is not None
                                  else 3.0 * self.heartbeat_interval)
        self.heartbeat_dead_after = int(heartbeat_dead_after)
        self._hb_seq = itertools.count()
        self._closing = threading.Event()
        self._watchdog: Optional[threading.Thread] = None
        self._hosts_alive_gauge()
        if self.heartbeat_interval > 0:
            self._watchdog = threading.Thread(target=self._watchdog_loop,
                                              name="plora-watchdog", daemon=True)
            self._watchdog.start()

    # -- topology -----------------------------------------------------------

    @property
    def total_units(self) -> int:
        return sum(self.hosts)

    @property
    def host_size(self) -> Optional[int]:
        """Uniform per-host width (what ``ExecutionEngine(host_size=...)``
        wants), or None when hosts are heterogeneous."""
        return self.hosts[0] if len(set(self.hosts)) == 1 else None

    def units_of_host(self, host: int) -> Tuple[int, ...]:
        """Global pool unit ids backing one host."""
        return self._host_units[host]

    def host_of_unit(self, unit: int) -> int:
        return self.device_pool.devices[unit].host

    def host_device(self, host: int) -> str:
        """The device host ``host``'s worker runs on."""
        if self.device is not None and torch.device(self.device).type == "cpu":
            return "cpu"
        return f"cuda:{host % max(torch.cuda.device_count(), 1)}"

    def in_flight(self, host: int) -> int:
        w = self._workers[host]
        return 0 if w is None else w.in_flight()

    # -- membership / health ------------------------------------------------

    def host_state(self, host: int) -> str:
        return self._host_state[host]


    @property
    def hosts_alive(self) -> int:
        return sum(1 for s in self._host_state if s in (HOST_ALIVE, HOST_SUSPECT))

    def _hosts_alive_gauge(self) -> None:
        self.tracer.metrics.gauge("cluster.hosts_alive").set(self.hosts_alive)

    def _set_host_state(self, host: int, state: str, **why) -> None:
        prev = self._host_state[host]
        if prev == state:
            return
        self._host_state[host] = state
        self.tracer.instant(f"host{host}.{state}", cat="host", track="membership",
                            host=host, state=state, prev=prev, **why)
        self._hosts_alive_gauge()

    def membership_subscribe(self, cb: Callable) -> Callable:
        """Register ``cb(event_dict)`` for join/drain notifications (called
        from the announcing thread). Returns an unsubscribe callable. The
        engine's adaptive loop uses this to replan onto joining hosts and
        off draining ones."""
        with self._membership_lock:
            self._membership_subs.append(cb)

        def unsubscribe():
            with self._membership_lock:
                if cb in self._membership_subs:
                    self._membership_subs.remove(cb)

        return unsubscribe

    def _announce(self, event: Dict[str, Any]) -> None:
        with self._membership_lock:
            subs = list(self._membership_subs)
        for cb in subs:
            cb(dict(event))

    def add_host(self, n_devices: Optional[int] = None, *, host_class: str = "") -> int:
        """Admit a new host mid-run: extend the layout, register its units
        with the device pool (free immediately -- blocked acquires wake), and
        announce a ``join`` event so the engine replans onto it. The worker
        itself spawns lazily on first dispatch, like every other host.
        Returns the new host id."""
        n = int(n_devices) if n_devices is not None else self.hosts[0]
        if n <= 0:
            raise ValueError(f"bad device count {n}")
        host = len(self.hosts)
        self.hosts = self.hosts + (n,)
        self.host_classes = self.host_classes + (str(host_class),)
        self._workers.append(None)
        self._host_locks.append(threading.Lock())
        self.host_stats.append({})
        self._host_state.append(HOST_ALIVE)
        self._last_pong.append(0.0)
        self._hb_misses.append(0)
        units = self.device_pool.add_devices([HostUnit(host, i) for i in range(n)])
        self._host_units.append(units)
        self.tracer.instant(f"host{host}.{HOST_ALIVE}", cat="host", track="membership",
                            host=host, state=HOST_ALIVE, reason="join",
                            host_class=host_class, units=list(units))
        self._hosts_alive_gauge()
        self._announce({"action": "join", "host": host, "units": units,
                        "host_class": str(host_class), "n_devices": n})
        return host

    def drain_host(self, host: int, *, timeout: float = 120.0) -> None:
        """Gracefully retire one host: announce ``drain`` (the engine stops
        assigning and force-replans residuals off the host), let in-flight
        segments finish -- their checkpoint writes land through the normal
        success-atomic path, so no step is lost -- then retire the units from
        the pool and stop the worker. The graceful sibling of
        :meth:`kill_host`."""
        if self._host_state[host] in (HOST_DRAINING, HOST_DEAD):
            return
        self._set_host_state(host, HOST_DRAINING, reason="drain")
        self._announce({"action": "drain", "host": host, "units": self.units_of_host(host),
                        "host_class": self.host_classes[host]})
        deadline = time.perf_counter() + timeout
        while True:
            # re-read each pass: a mid-drain death respawns the worker (the
            # retry path re-runs the killed segment from its last checkpoint)
            # and the drain must wait out the *current* worker's in-flight.
            w = self._workers[host]
            if w is None or w.dead or w.in_flight() == 0:
                break
            if time.perf_counter() > deadline:
                raise TimeoutError(f"host {host} still has {w.in_flight()} segment(s) in "
                                   f"flight after {timeout:.0f}s drain window")
            time.sleep(0.01)
        # in-flight work done; now the units must come home to the pool
        # (the engine releases each slice as its segment completes)
        self.device_pool.retire_units(self.units_of_host(host),
                                      timeout=max(deadline - time.perf_counter(), 0.01))
        self._stop_workers([self._workers[host]])
        self._set_host_state(host, HOST_DEAD, reason="drained")

    # -- heartbeat watchdog -------------------------------------------------

    def _on_pong(self, host: int, payload) -> None:
        rtt = time.perf_counter() - payload.t_send
        self.tracer.metrics.histogram("cluster.heartbeat_rtt").record(rtt)
        self._last_pong[host] = time.perf_counter()
        self._hb_misses[host] = 0
        if self._host_state[host] == HOST_SUSPECT:
            self._set_host_state(host, HOST_ALIVE, reason="pong")

    def _watchdog_loop(self) -> None:
        """Ping every live worker each interval; a host missing its deadline
        goes SUSPECT, each further miss doubles the grace (exponential
        backoff -- a paused/hung worker can still come back), and after
        ``heartbeat_dead_after`` misses the host is declared DEAD: its
        in-flight replies fail with :class:`WorkerDied` (so ``run()`` never
        hangs on a hung-but-alive process) and the existing restart path
        respawns it on the next dispatch."""
        while not self._closing.wait(self.heartbeat_interval):
            now = time.perf_counter()
            for host in range(len(self.hosts)):
                w = self._workers[host]
                if w is None or w.dead or not w.ready.is_set():
                    continue
                if self._host_state[host] == HOST_DEAD:
                    continue
                if self._last_pong[host] == 0.0:
                    self._last_pong[host] = now  # first ping epoch
                try:
                    w.send(("ping", HeartbeatMsg(seq=next(self._hb_seq),
                                                 t_send=time.perf_counter())))
                except TransportError:  # counted as a miss below
                    pass
                misses = self._hb_misses[host]
                due = self._last_pong[host] + self.heartbeat_timeout * (2 ** misses)
                if now <= due:
                    continue
                self._hb_misses[host] = misses + 1
                if self._host_state[host] == HOST_ALIVE:
                    self._set_host_state(host, HOST_SUSPECT, reason="heartbeat_timeout",
                                         misses=misses + 1)
                if self._hb_misses[host] >= self.heartbeat_dead_after:
                    self._set_host_state(host, HOST_DEAD, reason="heartbeat_expired",
                                         misses=self._hb_misses[host])
                    w._fail_all()
                    try:
                        w.transport.kill()
                    except Exception:  # noqa: BLE001 -- already gone
                        pass

    # -- worker lifecycle ---------------------------------------------------

    def _prepare(self, cfg, configs_by_cid, total_steps, base_params, seq, seed,
                 data_iter_fn) -> None:
        """Cache the run-level init payload (model config, base params,
        budgets, numeric settings) once per workload; (re)started workers
        receive it before any segment. One dispatcher serves one workload at
        a time.

        The memo token holds configs/budgets *by value* (LoraConfig is
        hashable) and pins ``base_params``/``data_iter_fn`` alive on
        ``_payload_refs`` so their id()s cannot be recycled by a later
        workload -- an id-only token could silently reuse stale state."""
        with self._prep_lock:
            numerics = numeric_settings()
            token = (
                cfg, id(base_params), id(data_iter_fn), seq, seed,
                tuple(sorted(configs_by_cid.items())),
                tuple(sorted(total_steps.items())),
                tuple(sorted(numerics.items())),
            )
            if token == self._payload_token:
                return
            if data_iter_fn is not None:
                try:
                    pickle.dumps(data_iter_fn)
                except Exception as e:
                    raise ValueError("data_iter_fn must be picklable (a module-level "
                                     "callable) to cross the host boundary") from e
            t0 = time.perf_counter()
            self._payload = {
                "cfg": cfg,
                "configs_by_cid": dict(configs_by_cid),
                "total_steps": {int(k): int(v) for k, v in total_steps.items()},
                "base": encode_tree(base_params),
                "seq": int(seq),
                "seed": int(seed),
                "data_iter_fn": data_iter_fn,
                "numerics": numerics,
            }
            self._payload_bytes = _tree_nbytes(self._payload["base"])
            self._payload_encode_s = time.perf_counter() - t0
            self._payload_token = token
            self._payload_refs = (base_params, data_iter_fn)
            self._payload_version += 1

    def _send_init(self, host: int, w: HostWorker) -> None:
        w.send(("init", dict(self._payload, sent_wall=time.time())))
        w.init_version = self._payload_version
        st = self.host_stats[host]
        st["init_bytes"] = self._payload_bytes
        st["init_encode_s"] = self._payload_encode_s
        st["inits_sent"] = st.get("inits_sent", 0) + 1

    def _build_kernels(self) -> None:
        """Build the CUDA kernels in this process before a worker spawns for
        a card, so the workers only load them (``kernels/_build.py``)."""
        if self._built or not torch.cuda.is_available():
            return
        from repro_torch.kernels import _build

        _build.build_all()
        self._built = True

    def _ensure_host(self, host: int) -> HostWorker:
        """Live, initialized worker for ``host`` -- spawning or respawning
        (counted in ``n_restarts``) as needed. Safe to call from concurrent
        segment threads; only one respawn happens per death."""
        with self._host_locks[host]:
            w = self._workers[host]
            if w is not None and not w.dead and w.transport.alive():
                if self._payload is not None and w.init_version != self._payload_version:
                    self._send_init(host, w)
                return w
            if w is not None:
                # restart credits are for failures that cost work: a worker
                # that died *idle* (no request in flight) lost nothing, so
                # its respawn is free
                if w.died_in_flight:
                    self.n_restarts += 1
                try:
                    w.transport.kill()
                except Exception:  # noqa: BLE001 -- already gone
                    pass
            if self.host_device(host).startswith("cuda"):
                with self._prep_lock:
                    self._build_kernels()
            t0 = time.perf_counter()
            w = HostWorker(host, self.hosts[host],
                           self._transport_factory(host, self.hosts[host]),
                           on_pong=self._on_pong, send_deadline=self.send_deadline,
                           send_retries=self.send_retries)
            self._workers[host] = w
            w.wait_ready(self.start_timeout)
            st = self.host_stats[host]
            st["spawn_s"] = time.perf_counter() - t0
            st["spawns"] = st.get("spawns", 0) + 1
            self._last_pong[host] = time.perf_counter()
            self._hb_misses[host] = 0
            if self._host_state[host] in (HOST_SUSPECT, HOST_DEAD):
                self._set_host_state(host, HOST_ALIVE, reason="respawn")
            if self._payload is not None:
                self._send_init(host, w)
            return w

    def kill_host(self, host: int) -> None:
        """Fault injection / hard teardown: SIGKILL the host's worker. Any
        in-flight segment fails with :class:`WorkerDied` and is re-dispatched
        onto a fresh worker by :meth:`DispatchExecutor.run_segment`."""
        w = self._workers[host]
        if w is not None:
            w.transport.kill()

    @staticmethod
    def _stop_workers(workers: Sequence[Optional[HostWorker]]) -> None:
        """Graceful stop of workers, kill as fallback: every ``stop`` is sent
        before the first wait, so the workers wind down together."""
        workers = [w for w in workers if w is not None]
        for w in workers:
            try:
                if w.transport.alive():
                    w.transport.send(("stop", {}))
            except Exception:  # noqa: BLE001 -- the kill below still runs
                pass
        for w in workers:
            try:
                w.transport.join(timeout=10)
            except Exception:  # noqa: BLE001 -- the kill below still runs
                pass
            try:
                w.transport.kill()
            except Exception:  # noqa: BLE001 -- already gone
                pass

    def close(self) -> None:
        """Graceful stop of every worker (kill as fallback)."""
        self._closing.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=5)
        self._stop_workers(self._workers)

    def __enter__(self) -> "HostDispatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- Runner protocol ----------------------------------------------------

    def run(self, segments, configs_by_cid, total_steps, cfg, base_params, *, seq: int,
            pool=None, data_iter_fn=None, seed: int = 0, estimator=None,
            impl: Optional[str] = None, remat: Optional[str] = None,
            base_dtype: Optional[str] = None):
        """Execute planned segments across the hosts -- same contract as
        :meth:`ClusterRunner.run` (dispatch order, resume dependencies,
        device-free events from real completions, timings feedback), with
        each segment running in its host's worker process. ``impl``/``remat``/
        ``base_dtype`` ship to the workers as a :class:`KernelPolicy` with
        every segment."""
        from repro_torch.cluster.runner import ClusterRunner

        runner = ClusterRunner(self.executor, self.device_pool, concurrent=True,
                               tracer=self.tracer)
        result = runner.run(segments, configs_by_cid, total_steps, cfg, base_params, seq=seq,
                            pool=pool, data_iter_fn=data_iter_fn, seed=seed,
                            estimator=estimator, impl=impl, remat=remat, base_dtype=base_dtype)
        self.last_result = result
        return result


__all__ = [
    "TransportError", "WorkerDied", "RemoteSegmentError", "WireArray", "encode_tree",
    "decode_tree", "SegmentMsg", "RecordMsg", "CheckpointWrite", "HeartbeatMsg", "HealthReply",
    "HOST_ALIVE", "HOST_SUSPECT", "HOST_DEAD", "HOST_DRAINING", "KernelPolicy",
    "encode_segment", "decode_segment", "encode_record", "decode_record", "MemoryPool",
    "numeric_settings", "apply_numeric_settings", "send_frame", "recv_frame", "ProcessTransport",
    "HostUnit", "HostWorker",
    "DispatchExecutor", "HostDispatcher", "TraceCtx",
]
