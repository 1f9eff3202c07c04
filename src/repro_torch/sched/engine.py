"""Static execution engine (the port of the static part of
``repro/sched/engine.py``, paper §4, Fig. 3).

``simulate`` replays a planned :class:`~repro_torch.sched.planner.Schedule`
through a resource monitor and raises if it ever oversubscribes the device
units; ``run_local`` executes every job of the schedule for real on this
host through the cluster subsystem (``repro_torch.cluster``): each job is a
:class:`JobSegment` on the device units the schedule planned, run by a
:class:`~repro_torch.cluster.runner.ClusterRunner` on a
:class:`~repro_torch.cluster.pool.DevicePool` slice, with every finished
adapter saved to the :class:`~repro_torch.train.checkpoint.CheckpointPool`.

The reference's online and adaptive engine (arrival traces, repacking on
device-free events, preemption and migration, re-planning on drift) is not
ported yet; :class:`JobSegment` and the runner already carry what it needs
(per-adapter start steps, step budgets, resume dependencies).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import LoraConfig, ModelConfig
from repro_torch.obs import NULL_TRACER
from repro_torch.sched.cost_model import CostEstimator
from repro_torch.sched.planner import Schedule, ScheduledJob
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


class ExecutionEngine:
    """Resource monitor + job launcher over ``g`` device units of one host
    (the reference's ``host_size`` belongs to its multi-host tier).

    ``cm`` is any :class:`~repro_torch.sched.cost_model.CostEstimator`; the
    runner feeds it each segment's measured step time (``observe``), which
    a :class:`~repro_torch.sched.profile.ProfiledCostModel` folds into its
    observation store."""

    def __init__(self, cm: CostEstimator, g: int, *, tracer=None):
        self.cm = cm
        self.monitor = ResourceMonitor(g)
        self.tracer = tracer if tracer is not None else NULL_TRACER

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

        with self.tracer.span("engine.run_local", cat="engine",
                              n_jobs=len(schedule.jobs), g=self.monitor.total):
            units = assign_units(
                [(j.start, j.end, j.degree) for j in schedule.jobs], self.monitor.total
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
