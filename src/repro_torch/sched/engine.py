"""Event-driven execution engine (the port of ``repro/sched/engine.py``,
paper §4, Fig. 3).

The engine is a virtual-clock event loop: a heap of job-finish and
job-arrive events (a finish event is a device-free event) drives one
scheduling loop that supports

  * online admission: ``LoraConfig`` s arrive mid-run on an arrival-time
    trace (:func:`poisson_trace` builds a Poisson workload);
  * dynamic repacking: on every admission and device-free event the engine
    re-invokes the planner's incremental API
    (:func:`repro_torch.sched.planner.replan` -> DTM) over the configs not
    yet started and the free device units (``repack="drain"`` replans only
    when every unit is free: the static baseline), holding an admission
    when waiting for the next finish launches wider (``admission=
    "patient"``);
  * preemption and migration: with ``migration_budget > 0`` a running pack
    can be preempted on an admission event when the cost model says a
    repack pays; its finished adapters complete, its unfinished ones
    re-enter the pending set with their residual steps. In real execution
    they round-trip through the
    :class:`~repro_torch.train.checkpoint.CheckpointPool` (weights, Adam
    moments, step counts) and are injected into whatever pack comes next.

``plan_online`` plays the trace against the cost model's durations on the
pure prior (``cm.virtual_model()``), so a plan is deterministic;
``run_online_local`` executes the planned segments for real through the
cluster subsystem (``repro_torch.cluster``): each segment on the device the
plan gave it, by a :class:`~repro_torch.cluster.runner.ClusterRunner` whose
:class:`~repro_torch.cluster.executor.SliceExecutor` captures one CUDA graph
per step shape on the card. With a
:class:`~repro_torch.sched.profile.ProfiledCostModel` it runs the adaptive
loop instead (:meth:`ExecutionEngine._run_adaptive`): probe a pack shape
not measured yet, continue in place while the measured rate stays within
the drift threshold, otherwise re-plan the residual with the measured rate.
The static ``simulate(schedule)`` / ``run_local(schedule, ...)`` are the
case without arrivals.

The hooks of a heterogeneous or elastic fleet (host classes, host states,
join and drain events) are read with ``getattr`` from the runner and stay
inert until the port has a multi-host runner.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster.pool import pick_class_units, pick_host_units
from repro_torch.configs.base import LoraConfig, ModelConfig
from repro_torch.kernels.quant import MODES, base_storage
from repro_torch.obs import NULL_TRACER
from repro_torch.sched.cost_model import CostEstimator, base_param_bytes
from repro_torch.sched.planner import Schedule, ScheduledJob, replan
from repro_torch.train.checkpoint import CheckpointPool

@dataclass
class ResourceMonitor:
    total: int
    free: int = -1

    def __post_init__(self):
        if self.free < 0:
            self.free = self.total

    def acquire(self, n: int) -> bool:
        if n <= self.free:
            self.free -= n
            return True
        return False

    def release(self, n: int):
        self.free += n
        if self.free > self.total:
            raise RuntimeError(f"released more than the {self.total} units held")


@dataclass
class JobRecord:
    job: ScheduledJob
    wall_seconds: float
    final_losses: Optional[np.ndarray] = None
    # wall-clock interval relative to the cluster runner's dispatch t0:
    # overlapping intervals of different records ran concurrently on
    # disjoint slices
    real_start: float = 0.0
    real_end: float = 0.0
    # peak allocated bytes on the segment's CUDA device (None on the CPU)
    peak_bytes: Optional[int] = None
    # whether the segment captured its step's graph (a cache miss)
    captured: bool = False


# ---------------------------------------------------------------------------
# Arrival traces
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Arrival:
    """One online job submission: a LoRA config arriving at ``time`` that
    needs ``steps`` training iterations (None = the run-level default)."""

    time: float
    config: LoraConfig
    steps: Optional[int] = None


def poisson_trace(
    configs: Sequence[LoraConfig],
    mean_interarrival: float,
    seed: int = 0,
    steps: Optional[Sequence[int]] = None,
) -> List[Arrival]:
    """Poisson arrival process over ``configs`` (order preserved): i.i.d.
    exponential inter-arrival gaps with the given mean, shifted so the first
    config arrives at t=0. Deterministic in ``seed``."""
    rng = np.random.RandomState(seed)
    gaps = rng.exponential(mean_interarrival, size=len(configs))
    times = np.cumsum(gaps) - gaps[0]
    return [
        Arrival(float(t), c, None if steps is None else int(steps[i]))
        for i, (t, c) in enumerate(zip(times, configs))
    ]


# ---------------------------------------------------------------------------
# Online schedule (the event loop's output)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Online schedule (the event loop's output)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class JobSegment:
    """One contiguous run of a packed job on ``degree`` device units.

    ``start_steps[i]`` is how many iterations ``config_ids[i]`` had already
    trained before this segment (0 = fresh; > 0 = resumed from the
    checkpoint pool); ``run_steps`` is the number of packed iterations this
    segment executes; ``done_ids`` are the configs whose step budget
    completes within it; ``preempted`` marks a segment cut before every
    adapter finished (its unfinished adapters are checkpointed). ``units``
    is the segment's planned device group: segments that overlap in time
    hold disjoint units, and the runner maps them onto disjoint slices."""

    job_id: int
    config_ids: Tuple[int, ...]
    degree: int
    start: float
    end: float
    start_steps: Tuple[int, ...]
    run_steps: int
    done_ids: Tuple[int, ...]
    preempted: bool = False
    units: Tuple[int, ...] = ()

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclass
class OnlineSchedule:
    segments: List[JobSegment]
    makespan: float
    g: int
    completed: Dict[int, float]  # cid -> virtual completion time
    total_steps: Dict[int, int]  # cid -> total step budget
    n_repacks: int = 0
    n_migrations: int = 0
    n_f_calls: int = 0
    # adaptive real execution only (profile feedback loop): probe segments
    # dispatched, drift-triggered device-unit re-assignments, and the
    # measured-vs-predicted timing of every executed segment
    n_probes: int = 0
    n_reassignments: int = 0
    timings: List = field(default_factory=list)  # List[SegmentTiming]

    def utilization(self) -> float:
        """Busy device-seconds / (G * makespan)."""
        if not self.segments or self.makespan <= 0:
            return 0.0
        busy = sum(s.duration * s.degree for s in self.segments)
        return busy / (self.g * self.makespan)

    def validate(self, host_size: Optional[int] = None):
        """Raise if any instant oversubscribes the device pool, or if the
        planned device groups (``units``) are malformed: wrong width, out of
        range, shared between time-overlapping segments, or — when
        ``host_size`` is given — spanning more than one host (a mesh slice
        lives inside one host's device pool)."""
        _validate_intervals(
            [(s.start, s.end, s.degree) for s in self.segments], self.g
        )
        timed = [s for s in self.segments if s.units]
        for s in timed:
            if len(s.units) != s.degree or not all(
                0 <= u < self.g for u in s.units
            ):
                raise RuntimeError(
                    f"segment {s.job_id} has units {s.units} for degree "
                    f"{s.degree} on a {self.g}-unit pool"
                )
            if host_size is not None and len(
                {u // host_size for u in s.units}
            ) > 1:
                raise RuntimeError(
                    f"segment {s.job_id} units {s.units} span hosts "
                    f"(host_size={host_size})"
                )
        for i, a in enumerate(timed):
            for b in timed[i + 1:]:
                if a.start < b.end - _EPS and b.start < a.end - _EPS:
                    shared = set(a.units) & set(b.units)
                    if shared:
                        raise RuntimeError(
                            f"overlapping segments {a.job_id}/{b.job_id} "
                            f"share device units {sorted(shared)}"
                        )


def _validate_intervals(intervals: Sequence[Tuple[float, float, int]], g: int):
    monitor = ResourceMonitor(g)
    events = []
    for start, end, degree in intervals:
        events.append((start, 1, degree))
        events.append((end, 0, degree))
    # process releases before acquires at equal timestamps
    for t, kind, d in sorted(events, key=lambda e: (e[0], e[1])):
        if kind == 0:
            monitor.release(d)
        elif not monitor.acquire(d):
            raise RuntimeError(f"schedule oversubscribes devices at t={t:.2f}")


# ---------------------------------------------------------------------------
# Event loop internals
# ---------------------------------------------------------------------------


@dataclass
class _Pending:
    cid: int
    config: LoraConfig
    arrival: float
    steps_done: int
    total_steps: int

    @property
    def residual(self) -> int:
        return self.total_steps - self.steps_done


@dataclass
class _Running:
    job_id: int
    cids: Tuple[int, ...]
    sel: List[LoraConfig]
    degree: int
    start: float
    iter_time: float
    residuals: Tuple[int, ...]
    start_steps: Tuple[int, ...]
    run_steps: int  # max residual: iterations until the job finishes
    est_end: float
    units: Tuple[int, ...] = ()  # concrete device units this job holds


_EPS = 1e-9

# Fraction of the estimated wait-for-victim completion a preemption must
# beat before the engine migrates (guards against churn from the myopic
# single-victim estimate; see ExecutionEngine.plan_online).
MIGRATION_MARGIN = 0.25


class ExecutionEngine:
    """Resource monitor + event loop + job launcher over ``g`` device units.

    ``cm`` is any :class:`~repro_torch.sched.cost_model.CostEstimator`.
    Virtual planning (``plan_online``/``simulate``) always runs on the pure
    prior (``cm.virtual_model()``), so simulation stays deterministic; real
    execution uses ``cm`` itself: give it a
    :class:`~repro_torch.sched.profile.ProfiledCostModel` and
    ``run_online_local`` switches to the adaptive loop
    (:meth:`_run_adaptive`). The runner feeds ``cm`` each segment's
    measured step time (``observe``)."""

    def __init__(self, cm: CostEstimator, g: int, *,
                 host_size: Optional[int] = None, tracer=None):
        """``host_size`` makes unit assignment host-aware: the ``g`` units
        are grouped into hosts of ``host_size`` (unit ``u`` lives on host
        ``u // host_size``), a job's degree is capped at the host width and
        every planned unit group stays within one host. ``None`` (default)
        is the single-host engine."""
        if host_size is not None:
            if host_size <= 0 or g % host_size:
                raise ValueError(
                    f"host_size {host_size} must evenly divide g={g}"
                )
            if host_size & (host_size - 1):
                raise ValueError(
                    f"host_size {host_size} must be a power of two (planned "
                    "degrees are powers of two; other host widths strand "
                    "units that no job can ever use)"
                )
        self.cm = cm
        self.host_size = host_size
        self.monitor = ResourceMonitor(g)
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def _check_base(self, base_params) -> None:
        """Raise unless the cost model prices ``base_params`` at the bytes
        a parameter it holds (an f32 tree under a model priced at 2 bytes,
        say), and a quantized tree's dense leaves and compute at their
        dtype's: a plan made for another footprint packs jobs that may not
        fit. ``None`` (no tree) and an estimator with no memory model
        pass."""
        priced = getattr(self.cm, "base_bytes_per_param", None)
        if base_params is None or priced is None:
            return
        held, dense = base_storage(base_params, dense=True)
        if priced() != base_param_bytes(held):
            raise ValueError(
                f"the cost model prices the frozen base at {priced()} bytes a parameter "
                f"(base_dtype={self.cm.base_dtype!r}), but the tree handed to the engine holds "
                f"{held} ({base_param_bytes(held)} bytes): plan with base_dtype={held!r}")
        prec = self.cm.prec_bytes
        if held in MODES and base_param_bytes(self.cm.dense_dtype, prec) != base_param_bytes(
                dense, prec):
            raise ValueError(
                f"the cost model prices the {held} base's dense leaves as "
                f"dense_dtype={self.cm.dense_dtype!r}, but the tree's are {dense}: plan with "
                f"dense_dtype={dense!r}")

    def _unschedulable(self, n_pending: int) -> RuntimeError:
        g = self.monitor.total
        host = (
            f", or exceeds the {self.host_size}-unit host width?)"
            if self.host_size is not None
            else "?)"
        )
        return RuntimeError(
            f"{n_pending} configs can never be scheduled on {g} free "
            f"device units (min degree exceeds the pool" + host
        )

    def _take_units(
        self, free_units: List[int], degree: int
    ) -> Optional[Tuple[int, ...]]:
        """Claim ``degree`` units from the sorted free list, all on one host
        when ``host_size`` is set (``pick_host_units``). Returns None
        (claiming nothing) when no host can hold the job now; the caller
        holds it for the next device-free event."""
        units = pick_host_units(free_units, degree, self.host_size)
        if units is None:
            return None
        for u in units:
            free_units.remove(u)
        return units

    # ---------------- static entry points ----------------

    def simulate(self, schedule: Schedule) -> float:
        """Replay a static schedule's timeline through the resource monitor;
        returns the makespan and raises if the plan ever oversubscribes."""
        _validate_intervals(
            [(j.start, j.end, j.degree) for j in schedule.jobs], self.monitor.total
        )
        return schedule.makespan

    def run_local(
        self,
        schedule: Schedule,
        configs: Sequence[LoraConfig],
        cfg: ModelConfig,
        base_params,
        *,
        n_steps: int,
        seq: int,
        pool: Optional[CheckpointPool] = None,
        data_iter_fn: Optional[Callable] = None,
        seed: int = 0,
        runner=None,  # Optional[repro_torch.cluster.ClusterRunner]
        impl: Optional[str] = None,
        remat: Optional[str] = None,
        base_dtype: Optional[str] = None,
    ) -> Tuple[List[JobRecord], float]:
        """Execute every job of a static schedule on this host through the
        cluster subsystem. A concurrent runner returns the real wall-clock
        makespan; the sequential runner returns the what-if makespan (each
        job's planned duration replaced by its measured wall time, replayed
        through the resource timeline). ``impl``/``remat``/``base_dtype``
        select the kernel policy of every job (``impl=None``: the caller's
        context-local default, ``kernels.ops.default_impl()``). Without a
        ``runner`` the default one runs on this host's CUDA devices."""
        from repro_torch.cluster.pool import assign_units

        self._check_base(base_params)
        with self.tracer.span("engine.run_local", cat="engine",
                              n_jobs=len(schedule.jobs), g=self.monitor.total):
            units = assign_units(
                [(j.start, j.end, j.degree) for j in schedule.jobs], self.monitor.total,
                host_size=self.host_size,
            )
            segments = [
                JobSegment(
                    job_id=i, config_ids=j.config_ids, degree=j.degree,
                    start=j.start, end=j.end,
                    start_steps=(0,) * len(j.config_ids), run_steps=n_steps,
                    done_ids=j.config_ids, units=units[i],
                )
                for i, j in enumerate(schedule.jobs)
            ]
            result = self._execute_segments(
                segments,
                {i: c for i, c in enumerate(configs)},
                {i: n_steps for i in range(len(configs))},
                cfg, base_params, seq=seq, pool=pool, data_iter_fn=data_iter_fn,
                seed=seed, runner=runner, impl=impl, remat=remat, base_dtype=base_dtype,
            )
        if result.concurrent:
            makespan = result.makespan
        else:
            makespan = replay_measured(schedule, result.records, self.monitor.total)
        return result.records, makespan

    # ---------------- the event loop ----------------

    def plan_online(
        self,
        trace: Sequence[Arrival],
        seq: int,
        n_steps: int,
        *,
        repack: str = "event",
        admission: str = "patient",
        migration_budget: int = 0,
        preempt_min_remaining: Optional[float] = None,
        lookahead_k: int = 3,
    ) -> OnlineSchedule:
        """Play an arrival trace through the virtual-clock event loop.

        ``repack="event"`` replans on every admission/device-free event (the
        online engine); ``repack="drain"`` only replans when the pool is
        fully idle (the frozen-queue static baseline). ``migration_budget``
        caps how many running jobs may be preempted over the whole run;
        ``preempt_min_remaining`` (default ``4 * setup_time``) is the minimum
        estimated remaining time that makes a victim worth re-paying setup
        for.

        ``admission="patient"`` guards against the online-greedy pathology:
        dispatching an arrival immediately onto a few free units can lose to
        waiting for the next job-finish and launching at higher parallelism.
        On every repack with jobs still running, the engine compares the
        estimated completion of launch-now-on-``free`` against
        wait-then-launch-on-``free + soon-freed`` and holds the pending set
        when waiting wins. ``admission="eager"`` always dispatches (exactly
        Algorithm 2's greedy rule, and the t=0 behavior of ``plan``).

        ``lookahead_k`` controls the migration estimator: the wait-option
        against which a preemption must win is evaluated at each of the next
        k finish events (with the devices they cumulatively free), not just
        the victim's own finish — see ``migration_pays``.

        Every launched job is also assigned its concrete device *units*
        (lowest-numbered free units first), carried on ``JobSegment.units``
        so the cluster runner executes each job on exactly the mesh slice
        the scheduler planned."""
        with self.tracer.span(
            "engine.plan_online", cat="engine",
            n_configs=len(trace), g=self.monitor.total,
        ):
            return self._plan_online_impl(
                trace, seq, n_steps, repack=repack, admission=admission,
                migration_budget=migration_budget,
                preempt_min_remaining=preempt_min_remaining,
                lookahead_k=lookahead_k,
            )

    def _plan_online_impl(
        self,
        trace: Sequence[Arrival],
        seq: int,
        n_steps: int,
        *,
        repack: str,
        admission: str,
        migration_budget: int,
        preempt_min_remaining: Optional[float],
        lookahead_k: int,
    ) -> OnlineSchedule:
        if repack not in ("event", "drain"):
            raise ValueError(f"unknown repack policy {repack!r}")
        if admission not in ("patient", "eager"):
            raise ValueError(f"unknown admission policy {admission!r}")
        g = self.monitor.total
        tracer = self.tracer
        # simulation contract: the virtual clock always ticks on the pure
        # prior, independent of any profile/measurement state
        cm = self.cm.virtual_model()
        if preempt_min_remaining is None:
            preempt_min_remaining = 4.0 * cm.setup_time

        heap: List[Tuple[float, int, int, str, int]] = []
        seqno = itertools.count()
        for cid, a in enumerate(trace):
            heapq.heappush(heap, (a.time, 1, next(seqno), "arrive", cid))

        pending: List[_Pending] = []
        running: Dict[int, _Running] = {}
        segments: List[JobSegment] = []
        completed: Dict[int, float] = {}
        total_steps = {
            cid: (a.steps if a.steps is not None else n_steps)
            for cid, a in enumerate(trace)
        }
        free = g
        free_units = list(range(g))  # sorted; lowest-first assignment
        next_job = itertools.count()
        n_repacks = n_migrations = n_f = 0

        def release_units(r: _Running):
            free_units.extend(r.units)
            free_units.sort()

        def finish_segment(r: _Running, end: float, steps_run: int, preempted: bool):
            done = tuple(
                cid
                for cid, resid in zip(r.cids, r.residuals)
                if resid <= steps_run
            )
            for cid, resid in zip(r.cids, r.residuals):
                if resid <= steps_run:
                    completed[cid] = r.start + cm.adapter_finish_offset(
                        r.sel, resid, r.degree, seq
                    )
            segments.append(
                JobSegment(
                    job_id=r.job_id,
                    config_ids=r.cids,
                    degree=r.degree,
                    start=r.start,
                    end=end,
                    start_steps=r.start_steps,
                    run_steps=steps_run,
                    done_ids=done,
                    preempted=preempted,
                    units=r.units,
                )
            )

        def do_repack(now: float):
            nonlocal free, n_repacks, n_f
            if not pending or free <= 0:
                return
            if repack == "drain" and running:
                return  # static baseline: wait for the full drain
            pending.sort(key=lambda e: e.cid)
            cfgs = [e.config for e in pending]
            resid = [e.residual for e in pending]
            with tracer.span(
                "engine.replan", cat="engine",
                pending=len(pending), free=free,
            ):
                res = replan(
                    cm, cfgs, free, seq, n_steps, residual_steps=resid,
                    max_degree=self.host_size,
                )
            n_repacks += 1
            n_f += res.n_f_calls
            if not res.jobs:
                return
            if admission == "patient" and running:
                # launch now at `free`, or wait for the next finish and
                # launch wider? Compare estimated completion times.
                t_next = min(r.est_end for r in running.values())
                freed = free + sum(
                    r.degree
                    for r in running.values()
                    if r.est_end <= t_next + _EPS
                )
                res_wait = replan(
                    cm, cfgs, freed, seq, n_steps, residual_steps=resid,
                    max_degree=self.host_size,
                )
                n_f += res_wait.n_f_calls
                covered_now = sum(len(j.config_ids) for j in res.jobs)
                covered_wait = sum(len(j.config_ids) for j in res_wait.jobs)
                finish_now = now + max(j.est_time for j in res.jobs)
                finish_wait = (
                    t_next + max(j.est_time for j in res_wait.jobs)
                    if res_wait.jobs
                    else float("inf")
                )
                if covered_wait >= covered_now and finish_wait <= finish_now:
                    tracer.instant(
                        "engine.admission_hold", cat="engine",
                        pending=len(pending), free=free,
                    )
                    return  # hold: the next device-free event re-evaluates
            launched = set()
            jobs = res.jobs
            if self.host_size is not None:
                # place wider jobs first (first-fit-decreasing): power-of-2
                # degrees then pack hosts without fragmentation
                jobs = sorted(jobs, key=lambda j: -j.degree)
            for jp in jobs:
                entries = [pending[i] for i in jp.config_ids]
                sel = [e.config for e in entries]
                units = self._take_units(free_units, jp.degree)
                if units is None:
                    # no single host currently has jp.degree free units
                    # (fragmentation across hosts): hold this job; the next
                    # device-free event re-plans and retries
                    continue
                r = _Running(
                    job_id=next(next_job),
                    cids=tuple(e.cid for e in entries),
                    sel=sel,
                    degree=jp.degree,
                    start=now,
                    iter_time=cm.iter_time(sel, jp.degree, seq),
                    residuals=tuple(e.residual for e in entries),
                    start_steps=tuple(e.steps_done for e in entries),
                    run_steps=max(e.residual for e in entries),
                    est_end=now + jp.est_time,
                    units=units,
                )
                running[r.job_id] = r
                heapq.heappush(
                    heap, (r.est_end, 0, next(seqno), "finish", r.job_id)
                )
                free -= jp.degree
                launched |= set(r.cids)
                tracer.instant(
                    "engine.launch", cat="engine", job_id=r.job_id,
                    degree=jp.degree, units=list(units),
                )
            if launched:
                pending[:] = [e for e in pending if e.cid not in launched]

        def steps_run_at(r: _Running, now: float) -> int:
            done = int((now - r.start - cm.setup_time) // r.iter_time)
            return max(0, min(done, r.run_steps))

        def preempt(r: _Running, now: float):
            nonlocal free, n_migrations
            steps_run = steps_run_at(r, now)
            finish_segment(r, now, steps_run, preempted=True)
            for cfg_c, cid, resid, st0 in zip(
                r.sel, r.cids, r.residuals, r.start_steps
            ):
                if resid > steps_run:
                    pending.append(
                        _Pending(
                            cid, cfg_c, now, st0 + steps_run, total_steps[cid]
                        )
                    )
            del running[r.job_id]  # its finish event becomes stale
            free += r.degree
            release_units(r)
            n_migrations += 1
            tracer.instant(
                "engine.preempt", cat="engine", job_id=r.job_id,
                steps_run=steps_run,
            )

        def migration_pays(victim: _Running, now: float) -> bool:
            """Cost-model estimate of the paper's dynamic-task-migration
            trade: preempt the victim and repack its unfinished adapters
            together with the pending set on its devices *now*, versus
            leaving it alone and scheduling the pending set later.

            The wait-option is a *lookahead over the next k finish events*:
            the pending set could launch at any upcoming device-free event
            with the devices those finishes cumulatively release, not only
            when the victim itself ends — the single-victim myopic estimate
            this replaces systematically overstated the cost of waiting and
            triggered preemptions that re-paid setup for nothing. With only
            one running job there is nothing to look ahead over, and the
            estimate falls back to the myopic rule guarded by
            ``MIGRATION_MARGIN``."""
            steps_run = steps_run_at(victim, now)
            unfinished = [
                (c, resid - steps_run)
                for c, resid in zip(victim.sel, victim.residuals)
                if resid > steps_run
            ]
            if not unfinished:
                return False
            avail = free + victim.degree
            merged = [e.config for e in pending] + [c for c, _ in unfinished]
            merged_resid = [e.residual for e in pending] + [
                s for _, s in unfinished
            ]
            res_m = replan(
                cm, merged, avail, seq, n_steps, residual_steps=merged_resid,
                max_degree=self.host_size,
            )
            miss_m = len(merged) - sum(len(j.config_ids) for j in res_m.jobs)
            fin_m = (
                now + max(j.est_time for j in res_m.jobs)
                if res_m.jobs
                else float("inf")
            )
            pend_cfgs = [e.config for e in pending]
            pend_resid = [e.residual for e in pending]
            ends = sorted({r.est_end for r in running.values()})[
                : max(1, lookahead_k)
            ]
            best: Optional[Tuple[int, float]] = None
            for t_i in ends:
                avail_i = free + sum(
                    r.degree
                    for r in running.values()
                    if r.est_end <= t_i + _EPS
                )
                res_i = replan(
                    cm, pend_cfgs, avail_i, seq, n_steps,
                    residual_steps=pend_resid, max_degree=self.host_size,
                )
                if res_i.jobs:
                    cand = (
                        len(pending)
                        - sum(len(j.config_ids) for j in res_i.jobs),
                        t_i + max(j.est_time for j in res_i.jobs),
                    )
                else:
                    cand = (len(pending), float(t_i))
                if best is None or cand < best:
                    best = cand
            assert best is not None  # the victim itself is running
            miss_w, fin_w = best
            if miss_m != miss_w:
                return miss_m < miss_w
            if len(ends) > 1:
                # true lookahead: intermediate frees are accounted for, so
                # the wait estimate is realistic — compare head to head
                return fin_m < fin_w - _EPS
            # single finish event: the myopic estimate is pessimistic, so
            # demand the preemption win clear a safety margin before
            # re-paying setup and churning the pack (fallback rule)
            return fin_m < now + (fin_w - now) * (1.0 - MIGRATION_MARGIN)

        while heap:
            t = heap[0][0]
            arrived = False
            while heap and heap[0][0] <= t + _EPS:
                _, _, _, kind, payload = heapq.heappop(heap)
                if kind == "finish":
                    r = running.pop(payload, None)
                    if r is None:
                        continue  # stale event of a preempted job
                    finish_segment(r, r.est_end, r.run_steps, preempted=False)
                    free += r.degree
                    release_units(r)
                else:
                    a = trace[payload]
                    pending.append(
                        _Pending(payload, a.config, a.time, 0, total_steps[payload])
                    )
                    arrived = True

            do_repack(t)
            # dynamic task migration (paper §4): on admission events, if work
            # is still stranded in the pending set, preempt the running job
            # with the most remaining time and repack everything together.
            while (
                repack == "event"
                and arrived
                and pending
                and running
                and n_migrations < migration_budget
            ):
                victims = [
                    r for r in running.values() if r.start < t - _EPS
                ]
                if not victims:
                    break
                victim = max(victims, key=lambda r: (r.est_end, r.job_id))
                if victim.est_end - t <= preempt_min_remaining:
                    break
                if not migration_pays(victim, t):
                    break
                preempt(victim, t)
                do_repack(t)

        if pending:
            raise self._unschedulable(len(pending))
        makespan = max(
            (s.end for s in segments),
            default=0.0,
        )
        sched = OnlineSchedule(
            segments=segments,
            makespan=makespan,
            g=g,
            completed=completed,
            total_steps=total_steps,
            n_repacks=n_repacks,
            n_migrations=n_migrations,
            n_f_calls=n_f,
        )
        sched.validate(host_size=self.host_size)
        return sched

    # ``simulate`` for the online mode is just the event loop itself.
    simulate_online = plan_online

    def run_online_local(
        self,
        trace: Sequence[Arrival],
        cfg: ModelConfig,
        base_params,
        *,
        n_steps: int,
        seq: int,
        pool: Optional[CheckpointPool] = None,
        repack: str = "event",
        admission: str = "patient",
        migration_budget: int = 0,
        preempt_min_remaining: Optional[float] = None,
        lookahead_k: int = 3,
        data_iter_fn: Optional[Callable] = None,
        seed: int = 0,
        runner=None,  # Optional[repro_torch.cluster.ClusterRunner]
        adaptive: Optional[bool] = None,
        probe_steps: int = 4,
        drift_threshold: Optional[float] = None,
    ) -> Tuple[List[JobRecord], OnlineSchedule]:
        """Real execution of an online trace: the event loop above decides
        the segments (and their device groups); the cluster runner then
        trains every segment for real on its planned mesh slice — segments
        on disjoint slices overlapping in wall-clock time on multi-device
        hosts — with preempted adapters checkpointing through ``pool`` and
        resuming, possibly with different pack partners, via
        ``inject_adapter``.

        With an adaptive estimator (``self.cm.adaptive``, i.e. a
        :class:`~repro_torch.sched.profile.ProfiledCostModel`; overridable via
        ``adaptive=``) the virtual pre-plan is skipped entirely and the
        engine runs the profile feedback loop instead: re-plan against live
        measurements on every real device-free event, probe unmeasured jobs
        for ``probe_steps`` iterations, and re-assign device units when a
        job's measured rate drifts beyond ``drift_threshold`` from plan —
        see :meth:`_run_adaptive` (``repack``/``admission``/
        ``migration_budget`` apply only to the virtual pre-planned path)."""
        self._check_base(base_params)
        if adaptive is None:
            adaptive = self.cm.adaptive
        if adaptive:
            return self._run_adaptive(
                trace,
                cfg,
                base_params,
                n_steps=n_steps,
                seq=seq,
                pool=pool,
                data_iter_fn=data_iter_fn,
                seed=seed,
                runner=runner,
                probe_steps=probe_steps,
                drift_threshold=drift_threshold,
            )
        sched = self.plan_online(
            trace,
            seq,
            n_steps,
            repack=repack,
            admission=admission,
            migration_budget=migration_budget,
            preempt_min_remaining=preempt_min_remaining,
            lookahead_k=lookahead_k,
        )
        if sched.n_migrations and pool is None:
            raise ValueError(
                "preemption occurred but no CheckpointPool was given to "
                "carry resumable adapter state"
            )
        result = self._execute_segments(
            sched.segments,
            {cid: a.config for cid, a in enumerate(trace)},
            sched.total_steps,
            cfg,
            base_params,
            seq=seq,
            pool=pool,
            data_iter_fn=data_iter_fn,
            seed=seed,
            runner=runner,
        )
        return result.records, sched

    # ---------------- adaptive real execution (profile feedback loop) ------

    def _run_adaptive(
        self,
        trace: Sequence[Arrival],
        cfg: ModelConfig,
        base_params,
        *,
        n_steps: int,
        seq: int,
        pool: Optional[CheckpointPool],
        data_iter_fn: Optional[Callable],
        seed: int,
        runner,
        probe_steps: int,
        drift_threshold: Optional[float],
    ) -> Tuple[List[JobRecord], OnlineSchedule]:
        """Profile-guided adaptive execution: plan -> measure -> re-plan.

        Unlike the virtual path (plan the whole trace, then execute), this
        loop schedules against *real* device-free events:

          * on every admission/completion it re-plans the pending set with
            the live (calibrated) estimator over the currently free units;
          * a job whose (pack shape, degree) has never been measured is
            dispatched as a ``probe_steps``-iteration *probe* segment first
            (the existing preempt machinery: the probe checkpoints its
            unfinished adapters through ``pool`` and they resume with exact
            step/data offsets, so splitting is bit-identical to an unbroken
            run);
          * when the probe's measured rate is within ``drift_threshold`` of
            plan, the job continues in place on the same units — no planner
            churn; when it drifts beyond the threshold, the residual re-
            enters the pending set and the next re-plan (now calibrated by
            the measurement) re-assigns device units — starved jobs land on
            units that actually free early, over-provisioned plans shrink.

        Observations recorded here persist on the estimator's store, so a
        profile saved afterwards (``launch.train --profile-out``) seeds the
        next run's planning."""
        import dataclasses
        import queue
        import time as _time
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.cluster import ClusterRunner, SegmentTiming
        from repro_torch.cluster.executor import _slice_track

        est = self.cm
        runner = runner or ClusterRunner(tracer=self.tracer)
        executor, dpool = runner.executor, runner.device_pool
        # -- heterogeneous / elastic fleet wiring (all optional) ------------
        # A multihost runner advertises per-host class tags, live membership
        # (join/drain events) and heartbeat states; local runners have none
        # of these and every hook below degrades to the homogeneous loop.
        class_aware = bool(getattr(est, "class_aware", False))
        host_classes: Dict[int, str] = {}
        for h, c in enumerate(getattr(runner, "host_classes", ()) or ()):
            host_classes[h] = str(c)
        host_state_fn = getattr(runner, "host_state", None)
        hs = self.host_size

        def unit_host(u: int) -> Optional[int]:
            return u // hs if hs else None

        def cls_of_units(units) -> str:
            h = unit_host(units[0]) if units else None
            return host_classes.get(h, "") if h is not None else ""

        def est_kw(units) -> dict:
            c = cls_of_units(units)
            return {"host_class": c} if (class_aware and c) else {}

        def host_suspect(h: Optional[int]) -> bool:
            if h is None or host_state_fn is None:
                return False
            try:
                return host_state_fn(h) == "SUSPECT"
            except Exception:
                return False

        drained_units: set = set()
        # kernel policy: capture the CALLER's context-local default here —
        # the submit() workers below run on executor threads that never see
        # this context's vars, so the impl must cross as an explicit
        # argument (same contract as ClusterRunner.run)
        from repro_torch.kernels.ops import default_impl

        impl = default_impl()
        impl = None if impl == "auto" else impl
        if drift_threshold is None:
            drift_threshold = getattr(est, "drift_threshold", 0.5)
        g = self.monitor.total
        configs_by_cid = {cid: a.config for cid, a in enumerate(trace)}
        total_steps = {
            cid: (a.steps if a.steps is not None else n_steps)
            for cid, a in enumerate(trace)
        }
        order = sorted(range(len(trace)), key=lambda cid: (trace[cid].time, cid))
        next_arr = 0
        pending: List[_Pending] = []
        # job_id -> (segment, entries, predicted iter time, is_probe)
        running: Dict[int, Tuple[JobSegment, List[_Pending], float, bool]] = {}
        events: queue.Queue = queue.Queue()
        free_units = list(range(g))
        segments: List[JobSegment] = []
        records: List[JobRecord] = []
        timings: List = []
        completed: Dict[int, float] = {}
        n_repacks = n_probes = n_reassign = n_f = 0
        next_job = itertools.count()
        tpe = (
            # 2x headroom: hosts admitted mid-run (add_host) raise the
            # number of concurrently running segments beyond the initial g
            ThreadPoolExecutor(max_workers=2 * max(g, 1))
            if runner.concurrent
            else None
        )
        t0 = _time.perf_counter()
        tracer = self.tracer
        # the adaptive loop spans the whole method (multiple exits via the
        # finally below), so the root span is entered/exited manually
        root_cm = tracer.span(
            "engine.run_adaptive", cat="engine", n_configs=len(trace), g=g
        )
        root_id = root_cm.__enter__().span_id or None

        def now() -> float:
            return _time.perf_counter() - t0

        def submit(entries: List[_Pending], degree: int, units: Tuple[int, ...]):
            nonlocal n_probes
            sel = [e.config for e in entries]
            run_steps = max(e.residual for e in entries)
            probe = (
                pool is not None
                and 0 < probe_steps < run_steps
                and not est.observed(sel, degree, seq, **est_kw(units))
            )
            steps_this = probe_steps if probe else run_steps
            seg = JobSegment(
                job_id=next(next_job),
                config_ids=tuple(e.cid for e in entries),
                degree=degree,
                start=now(),
                end=now(),  # placeholder; replaced at completion
                start_steps=tuple(e.steps_done for e in entries),
                run_steps=steps_this,
                done_ids=tuple(
                    e.cid for e in entries if e.residual <= steps_this
                ),
                preempted=steps_this < run_steps,
                units=units,
            )
            pred = est.iter_time(sel, degree, seq, **est_kw(units))
            running[seg.job_id] = (seg, entries, pred, probe)
            if probe:
                n_probes += 1
            slice_ = dpool.acquire_units(dpool.map_units(units))
            tracer.instant(
                "engine.launch", cat="engine", job_id=seg.job_id,
                degree=degree, units=list(units), probe=probe,
            )
            tracer.metrics.gauge("cluster.free_units").set(dpool.free)

            def work():
                # pool threads never see the loop thread's span stack: the
                # explicit ``parent=`` stitches this segment under the
                # adaptive root
                rec = err = None
                try:
                    with dpool.held(slice_):
                        with tracer.span(
                            "runner.segment", cat="runner",
                            parent=root_id, track=_slice_track(slice_),
                            job_id=seg.job_id, probe=probe,
                        ):
                            rec = executor.run_segment(
                                seg,
                                configs_by_cid,
                                total_steps,
                                cfg,
                                base_params,
                                seq=seq,
                                pool=pool,
                                data_iter_fn=data_iter_fn,
                                seed=seed,
                                slice_=slice_,
                                impl=impl,
                            )
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    err = e
                finally:
                    tracer.metrics.gauge("cluster.free_units").set(dpool.free)
                events.put((seg.job_id, rec, err))

            if tpe is not None:
                tpe.submit(work)
            else:
                work()

        def do_replan() -> bool:
            nonlocal n_repacks, n_f
            pending.sort(key=lambda e: e.cid)
            with tracer.span(
                "engine.replan", cat="engine",
                pending=len(pending), free=len(free_units),
            ):
                res = replan(
                    est,
                    [e.config for e in pending],
                    len(free_units),
                    seq,
                    n_steps,
                    residual_steps=[e.residual for e in pending],
                    max_degree=self.host_size,
                )
            n_repacks += 1
            n_f += res.n_f_calls
            if not res.jobs:
                return False
            picked = [
                (jp, [pending[i] for i in jp.config_ids]) for jp in res.jobs
            ]
            if self.host_size is not None:
                # wider jobs first: FFD keeps power-of-2 degrees host-packable
                picked.sort(key=lambda pe: -pe[0].degree)
            launched = set()
            for jp, entries in picked:
                units = take_units(jp.degree)
                if units is None:
                    continue  # fragmented across hosts: retry on next event
                submit(entries, jp.degree, units)
                launched |= {e.cid for e in entries}
            pending[:] = [e for e in pending if e.cid not in launched]
            return bool(launched)

        def take_units(degree: int) -> Optional[Tuple[int, ...]]:
            """Class- and health-aware unit claim: wide jobs to the fastest
            measured class, narrow jobs to the slowest, SUSPECT hosts last
            (see ``pick_class_units``); plain ``_take_units`` when the fleet
            is homogeneous/healthy-only."""
            if hs is not None and (host_classes or host_state_fn is not None):
                units = pick_class_units(
                    sorted(free_units), degree, hs,
                    class_of_host=lambda h: host_classes.get(h, ""),
                    ratio_of_class=lambda c: est.class_ratio(c, degree),
                    avoid_host=host_suspect,
                )
                if units is None:
                    return None
                for u in units:
                    free_units.remove(u)
                return units
            return self._take_units(free_units, degree)

        def on_membership(ev: dict) -> None:
            # called from the dispatcher's announcing thread: queue it into
            # the loop thread like any other real event
            events.put((None, ev, None))

        def handle_membership(ev: dict) -> None:
            action, host = ev.get("action"), ev.get("host")
            units = tuple(ev.get("units", ()))
            if action == "join":
                if hs is not None and len(units) != hs:
                    raise ValueError(
                        f"joining host {host} has {len(units)} units; this "
                        f"engine plans uniform {hs}-unit hosts"
                    )
                host_classes[host] = str(ev.get("host_class", ""))
                fresh = [
                    u for u in units
                    if u not in free_units and u not in drained_units
                ]
                free_units.extend(fresh)
                free_units.sort()
                tracer.instant(
                    "engine.host_join", cat="engine", host=host,
                    units=list(units), host_class=host_classes[host],
                )
            elif action == "drain":
                drained_units.update(units)
                free_units[:] = [u for u in free_units if u not in drained_units]
                tracer.instant(
                    "engine.host_drain", cat="engine", host=host,
                    units=list(units),
                )

        def on_completion(jid: int, rec):
            nonlocal n_reassign
            seg, entries, pred, probe = running.pop(jid)
            end = now()
            seg = dataclasses.replace(seg, end=end)
            segments.append(seg)
            rec.real_start -= t0  # loop-relative, like ClusterResult records
            rec.real_end -= t0
            records.append(rec)
            sel = [e.config for e in entries]
            measured = (
                rec.wall_seconds / seg.run_steps
                if seg.run_steps > 0
                else float("nan")
            )
            if seg.run_steps > 0:
                est.observe(sel, seg.degree, seq, measured,
                            **est_kw(seg.units))
            timing = SegmentTiming(
                job_id=seg.job_id,
                config_ids=seg.config_ids,
                degree=seg.degree,
                run_steps=seg.run_steps,
                seq=seq,
                measured_iter=measured,
                predicted_iter=pred,
            )
            timings.append(timing)
            for cid in seg.done_ids:
                completed[cid] = end
            resumed = []
            for e in entries:
                if e.residual > seg.run_steps:
                    e.steps_done += seg.run_steps
                    resumed.append(e)
            # NaN drift (no steps run / degenerate prediction) counts as
            # within threshold: nothing measurable to react to
            drift = timing.drift
            if drift != drift:
                drift = 0.0
            if resumed:
                # straggler detection: a SUSPECT host (missing heartbeat
                # deadlines) gets half the drift tolerance — work drifting
                # there re-enters the replan path before the host dies
                eff_threshold = drift_threshold * (
                    0.5 if host_suspect(unit_host(seg.units[0])) else 1.0
                )
                on_drained = any(u in drained_units for u in seg.units)
                if abs(drift) <= eff_threshold and not on_drained:
                    # plan confirmed within threshold: continue in place on
                    # the same units — no re-assignment, no planner churn
                    submit(resumed, seg.degree, seg.units)
                    return
                # drifted beyond threshold (or the host is draining): the
                # residual goes back to the planner, which — now calibrated
                # by this very measurement — re-assigns device units on the
                # next replan
                n_reassign += 1
                pending.extend(resumed)
            free_units.extend(
                u for u in seg.units if u not in drained_units
            )
            free_units.sort()

        subscribe = getattr(runner, "membership_subscribe", None)
        unsubscribe = subscribe(on_membership) if callable(subscribe) else None
        try:
            while next_arr < len(order) or pending or running:
                # membership (and any already-finished completion) events
                # queued while this thread was elsewhere: apply them before
                # replanning so the plan sees the current fleet
                while True:
                    try:
                        jid, rec, err = events.get_nowait()
                    except queue.Empty:
                        break
                    if err is not None:
                        raise err
                    if jid is None:
                        handle_membership(rec)
                    else:
                        on_completion(jid, rec)
                while (
                    next_arr < len(order)
                    and trace[order[next_arr]].time <= now() + _EPS
                ):
                    cid = order[next_arr]
                    next_arr += 1
                    pending.append(
                        _Pending(
                            cid,
                            trace[cid].config,
                            trace[cid].time,
                            0,
                            total_steps[cid],
                        )
                    )
                launched = (
                    do_replan() if pending and free_units else False
                )
                if running:
                    timeout = None
                    if next_arr < len(order):
                        timeout = (
                            max(trace[order[next_arr]].time - now(), 0.0)
                            + 1e-3
                        )
                    try:
                        jid, rec, err = events.get(timeout=timeout)
                    except queue.Empty:
                        continue  # the next arrival is due — admit it
                    if err is not None:
                        raise err
                    if jid is None:
                        handle_membership(rec)
                    else:
                        on_completion(jid, rec)
                elif pending and not launched:
                    raise self._unschedulable(len(pending))
                elif not pending and next_arr < len(order):
                    _time.sleep(
                        max(trace[order[next_arr]].time - now(), 0.0)
                    )
        finally:
            if unsubscribe is not None:
                unsubscribe()
            if tpe is not None:
                tpe.shutdown(wait=True)
            root_cm.__exit__(None, None, None)

        sched = OnlineSchedule(
            segments=segments,
            makespan=max((s.end for s in segments), default=0.0),
            g=g,
            completed=completed,
            total_steps=total_steps,
            n_repacks=n_repacks,
            n_migrations=0,
            n_f_calls=n_f,
            n_probes=n_probes,
            n_reassignments=n_reassign,
            timings=timings,
        )
        return records, sched

    # ---------------- shared segment executor (cluster subsystem) ----------

    def _execute_segments(
        self,
        segments: Sequence[JobSegment],
        configs_by_cid: Dict[int, LoraConfig],
        total_steps: Dict[int, int],
        cfg: ModelConfig,
        base_params,
        *,
        seq: int,
        pool: Optional[CheckpointPool],
        data_iter_fn: Optional[Callable],
        seed: int,
        runner=None,
        impl: Optional[str] = None,
        remat: Optional[str] = None,
        base_dtype: Optional[str] = None,
    ):
        """Execute planned segments through ``repro_torch.cluster``: each
        segment on the slice backing its planned units, thread-per-slice when
        the pool has several devices, serially otherwise. Resumed adapters
        (``start_steps > 0``) are loaded from the pool and injected into the
        new pack (weights, Adam moments, per-adapter step count); step
        budgets freeze an adapter once its own count is met. Returns a
        ``repro_torch.cluster.ClusterResult``."""
        from repro_torch.cluster import ClusterRunner

        runner = runner or ClusterRunner(tracer=self.tracer)
        return runner.run(
            segments, configs_by_cid, total_steps, cfg, base_params,
            seq=seq, pool=pool, data_iter_fn=data_iter_fn, seed=seed,
            estimator=self.cm, impl=impl, remat=remat, base_dtype=base_dtype,
        )


def replay_measured(schedule: Schedule, records: List[JobRecord], g: int) -> float:
    """Re-run the schedule's resource timeline with measured durations."""
    free = g
    t = 0.0
    running: List[Tuple[float, int]] = []
    pending = [(r.job.degree, r.wall_seconds) for r in records]
    makespan = 0.0
    i = 0
    while i < len(pending) or running:
        launched = False
        while i < len(pending) and pending[i][0] <= free:
            d, dur = pending[i]
            heapq.heappush(running, (t + dur, d))
            makespan = max(makespan, t + dur)
            free -= d
            i += 1
            launched = True
        if not launched:
            if not running:
                break
            end, d = heapq.heappop(running)
            t, free = end, free + d
    return makespan
