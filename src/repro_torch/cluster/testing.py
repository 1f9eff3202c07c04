"""In-memory fakes for the multihost dispatch tier (the port of
``repro/cluster/testing.py``).

:class:`FakeHostTransport` is an in-memory stand-in for
:class:`~repro_torch.cluster.multihost.ProcessTransport`: a scripted worker thread
that speaks the real wire protocol (every message round-trips through
``pickle``), fabricates ``done`` records, honors the checkpoint-write
contract for preempted segments, answers heartbeats, and supports scripted
faults — mid-segment death (``die_on``, SIGKILL semantics: silent AND
``alive()`` flips false) and mid-segment hangs (``hang_on``: the worker goes
silent while ``alive()`` stays true — only the dispatcher's heartbeat
watchdog can tell the difference). Dispatcher-level fault paths are thereby
testable in milliseconds, without subprocesses or a device.

This lives in ``src`` (not ``tests/``) so a benchmark can drive the real
dispatcher + engine over emulated fleets (e.g. a 2-fast + 1-slow class
layout) with the same fake the test-suite trusts.
"""
from __future__ import annotations

import pickle
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


class FakeHostTransport:
    """In-memory ``ProcessTransport`` stand-in speaking the real protocol.

    A worker thread answers ``init``/``run``/``ping``/``stop``; every message
    is forced through ``pickle`` both ways, so anything that would not
    survive the real process boundary fails here too. Fabricated results
    honor the executor's checkpoint contract: ``done_ids`` produce
    ``adapter`` writes, unfinished resumable adapters produce ``state``
    writes with exact ``steps_done`` accounting, and resumed cids *must*
    have had their state shipped in ``states`` (asserted — recorded on
    ``.resumed``).

    Fault injection:

    * ``die_on(run_idx, payload) -> bool`` — the worker drops the request
      and goes silent with ``alive() == False`` (what SIGKILL looks like
      from the dispatcher); ``kill()`` does the same from the outside.
    * ``hang_on(run_idx, payload) -> bool`` — the worker goes silent but
      ``alive()`` stays True: no reply to the segment, no pong to any later
      heartbeat. Indistinguishable from a wedged process; only the
      dispatcher's watchdog deadline can recover it.
    * ``reply_delay`` — seconds of real latency before every run reply
      (delayed replies for deadline tests).
    * ``pong_delay`` — seconds before each heartbeat pong (RTT shaping).

    Timing: ``iter_scale`` prices one fabricated training step;
    ``real_time=True`` makes the worker actually sleep the fabricated wall
    time before replying, so engine-level makespans measured over this fake
    are real wall-clock — that is what lets a benchmark measure
    class-aware vs class-blind placement on an emulated heterogeneous fleet.

    The kernel policy shipped with each run request is recorded on
    ``.policies``; every ``run`` payload's ``trace`` field on
    ``.trace_ctxs`` (with worker-shaped ``spans`` fabricated on the reply
    when tracing is on, exactly like a real traced worker). Heartbeat pings
    received are counted on ``.pings``.
    """

    def __init__(
        self,
        host_id: int,
        n_devices: int,
        *,
        die_on: Optional[Callable] = None,
        hang_on: Optional[Callable] = None,
        iter_scale: float = 1e-3,
        real_time: bool = False,
        reply_delay: float = 0.0,
        pong_delay: float = 0.0,
        on_run: Optional[Callable] = None,
    ):
        self.host_id = host_id
        self.n_devices = n_devices
        self.die_on = die_on
        self.hang_on = hang_on
        self.iter_scale = iter_scale
        self.real_time = real_time
        self.reply_delay = reply_delay
        self.pong_delay = pong_delay
        self.on_run = on_run
        self.runs: List[dict] = []
        self.policies: List = []  # KernelPolicy per run request
        self.trace_ctxs: List = []  # TraceCtx | None per run request
        self.resumed: List[Tuple[int, str]] = []
        self.pings: int = 0
        self.error: Optional[BaseException] = None
        self._in: "queue.Queue" = queue.Queue()
        self._out: "queue.Queue" = queue.Queue()
        self._alive = True
        self._hung = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- transport interface -------------------------------------------------

    def send(self, msg) -> None:
        self._in.put(pickle.dumps(msg))

    def recv(self, timeout: Optional[float] = None):
        return pickle.loads(self._out.get(timeout=timeout))

    def alive(self) -> bool:
        return self._alive

    def kill(self) -> None:
        self._alive = False
        self._in.put(None)  # wake the loop so it exits

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    # -- scripted worker -----------------------------------------------------

    def _reply(self, msg) -> None:
        self._out.put(pickle.dumps(msg))

    def _loop(self) -> None:
        # any exit — scripted death, stop, or an unexpected exception (e.g.
        # a contract assert below) — must leave alive()==False, or the
        # dispatcher pump would wait forever instead of failing crisply.
        # EXCEPT a scripted hang: alive() stays True, silence is the fault.
        try:
            self._run_loop()
        except BaseException as e:  # noqa: BLE001 — surfaced via .error
            self.error = e
            self._alive = False
            raise
        else:
            if not self._hung:
                self._alive = False

    def _run_loop(self) -> None:
        self._reply(("ready", {"host": self.host_id,
                               "devices": self.n_devices}))
        state: Dict = {}
        while True:
            raw = self._in.get()
            if raw is None or not self._alive:
                return
            if self._hung:
                continue  # wedged: consume and ignore everything
            kind, payload = pickle.loads(raw)
            if kind == "stop":
                self._alive = False
                return
            if kind == "init":
                state = payload
                continue
            if kind == "ping":
                from repro_torch.cluster.multihost import HealthReply

                self.pings += 1
                if self.pong_delay:
                    time.sleep(self.pong_delay)
                self._reply(("pong", HealthReply(
                    host=self.host_id, seq=payload.seq,
                    t_send=payload.t_send, in_flight=0,
                )))
                continue
            assert kind == "run", kind
            from repro_torch.cluster.multihost import (
                CheckpointWrite,
                KernelPolicy,
                RecordMsg,
            )

            run_idx = len(self.runs)
            self.runs.append(payload)
            self.policies.append(payload.get("policy") or KernelPolicy())
            self.trace_ctxs.append(payload.get("trace"))
            if self.die_on is not None and self.die_on(run_idx, payload):
                self._alive = False  # died mid-segment: no reply, ever
                return
            if self.hang_on is not None and self.hang_on(run_idx, payload):
                self._hung = True  # wedged mid-segment: silent but "alive"
                continue
            if self.on_run is not None:
                self.on_run(run_idx, payload)
            seg = payload["seg"]  # SegmentMsg
            cids = tuple(seg.config_ids)
            total = state["total_steps"]
            for cid, st0 in zip(cids, seg.start_steps):
                if st0 > 0:
                    aid = f"{cid:04d}"
                    assert aid in payload["states"], (
                        f"resume of cid {cid} without shipped state"
                    )
                    tree, meta = payload["states"][aid]
                    assert int(meta["steps_done"]) == st0, (meta, st0)
                    self.resumed.append((run_idx, aid))
            writes = []
            if payload["has_pool"]:
                done = set(seg.done_ids)
                for slot, (cid, st0) in enumerate(
                    zip(cids, seg.start_steps)
                ):
                    if cid in done:
                        writes.append(
                            CheckpointWrite(
                                "adapter", f"adapter_{cid:04d}",
                                {"w": np.float32(cid)},
                                {"final_loss": 1.0,
                                 "total_steps": int(total[cid])})
                        )
                    else:
                        writes.append(
                            CheckpointWrite(
                                "state", f"{cid:04d}",
                                {"w": np.float32(cid),
                                 "m": np.float32(0), "v": np.float32(0)},
                                {"steps_done": int(st0 + seg.run_steps),
                                 "total_steps": int(total[cid])})
                        )
            wall = self.iter_scale * seg.run_steps
            if self.reply_delay:
                time.sleep(self.reply_delay)
            if self.real_time:
                time.sleep(wall)
            done = {
                "req": payload["req"],
                "host": self.host_id,
                "record": RecordMsg(
                    config_ids=cids,
                    degree=seg.degree,
                    start=seg.start,
                    end=seg.end,
                    wall_seconds=wall,
                    losses=np.full(len(cids), 1.0, np.float32),
                ),
                "writes": writes,
            }
            if payload.get("trace") is not None:
                # worker-shaped span tree on the worker's own clock (t0=0):
                # a host root + one executor child, as Span.to_dict() dicts
                done["spans"] = [
                    {"name": f"host{self.host_id}.segment", "cat": "host",
                     "track": "", "span_id": 1, "parent_id": None,
                     "root_id": 1, "start": 0.0, "end": wall,
                     "args": {"job_id": seg.job_id, "fake": True}},
                    {"name": "executor.segment", "cat": "executor",
                     "track": "unit0", "span_id": 2, "parent_id": 1,
                     "root_id": 1, "start": 0.0, "end": wall,
                     "args": {"job_id": seg.job_id}},
                ]
                done["span_t0"] = 0.0
            self._reply(("done", done))


class DictPool:
    """Minimal in-memory CheckpointPool double for dispatcher-level tests:
    implements exactly the four methods the segment protocol uses."""

    def __init__(self):
        self.adapters: Dict[str, Tuple[dict, dict]] = {}
        self.states: Dict[str, Tuple[dict, dict]] = {}

    def has_adapter_state(self, aid: str) -> bool:
        return aid in self.states

    def load_adapter_state(self, aid: str):
        return self.states[aid]

    def save_adapter_state(self, aid: str, tree, meta: dict):
        self.states[aid] = (tree, dict(meta))

    def save_adapter(self, aid: str, tree, meta: dict):
        self.adapters[aid] = (tree, dict(meta))
