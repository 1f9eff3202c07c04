"""The Job Planner — Algorithm 2 — plus baselines and the Thm 6.1 AR bound.

Greedy event loop: whenever device units are free, run DTM on the remaining
configs, enqueue the returned concurrent jobs, then advance simulated time to
the next completion. Produces the LoRA Job Queue consumed by the execution
engine, a full (start, end, devices) timeline, the makespan, and the
approximation-ratio bound AR <= F / (F - T_last * (G - D)/G).

Baselines (paper §7.1): Min GPU (each config alone on the smallest degree
that fits, list-scheduled) and Max GPU (each config alone on all G units,
sequential).

The port's copy of ``repro/sched/planner.py``: pure Python and numpy, the
same code, so it gives the reference's results exactly.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.configs.base import LoraConfig
from repro_torch.sched.cost_model import CostEstimator, CostModel
from repro_torch.sched.dtm import DTMResult, dtm


@dataclass
class ScheduledJob:
    config_ids: Tuple[int, ...]
    degree: int
    start: float
    end: float
    throughput: float = 0.0

    @property
    def duration(self):
        return self.end - self.start


@dataclass
class Schedule:
    jobs: List[ScheduledJob]
    makespan: float
    g: int
    n_f_calls: int = 0

    def ar_bound(self) -> float:
        """Theorem 6.1: AR <= F / (F - T_last * (G-D)/G)."""
        if not self.jobs:
            return 1.0
        last = max(self.jobs, key=lambda j: j.end)
        f = self.makespan
        denom = f - last.duration * (self.g - last.degree) / self.g
        return f / max(denom, 1e-12)

    def total_device_seconds(self) -> float:
        return sum(j.duration * j.degree for j in self.jobs)

    def ar_bound_work(self) -> float:
        """Work-conservation bound: OPT >= max(W/G, longest job), so
        AR <= F / that. Tighter than Thm 6.1 for single-wave schedules."""
        if not self.jobs:
            return 1.0
        lb = max(
            self.total_device_seconds() / self.g,
            max(j.duration for j in self.jobs),
        )
        return self.makespan / max(lb, 1e-12)

    def ar(self) -> float:
        return min(self.ar_bound(), self.ar_bound_work())


def replan(
    cm: CostEstimator,
    configs: Sequence[LoraConfig],
    free: int,
    seq: int,
    n_steps: int,
    *,
    residual_steps: Optional[Sequence[int]] = None,
    max_policies: int = 4096,
    max_degree: Optional[int] = None,
) -> DTMResult:
    """Incremental replanning API (online engine hook): one DTM invocation
    over the *currently pending* configs and the *currently free* device
    units. The event-driven engine calls this on every admission and
    device-free event instead of draining a frozen queue; ``residual_steps``
    carries the remaining iteration counts of adapters preempted out of
    running jobs (paper §4 dynamic task migration). ``max_degree`` caps a
    single job's parallelism (multi-host engines pass the per-host device
    count: a mesh slice cannot span hosts)."""
    return dtm(
        cm,
        configs,
        free,
        seq,
        n_steps,
        residual_steps=residual_steps,
        max_policies=max_policies,
        max_degree=max_degree,
    )


def plan(
    cm: CostEstimator,
    configs: Sequence[LoraConfig],
    g: int,
    seq: int,
    n_steps: int,
    *,
    max_degree: Optional[int] = None,
) -> Schedule:
    """Algorithm 2: the offline special case of online replanning — every
    config is known at t=0, so the loop below is exactly `replan` on each
    device-free event over the not-yet-started remainder."""
    remaining = set(range(len(configs)))
    free = g
    t = 0.0
    running: List[Tuple[float, int]] = []  # (end_time, degree)
    out: List[ScheduledJob] = []
    n_calls = 0
    while remaining or running:
        launched = False
        if remaining and free > 0:
            res: DTMResult = replan(
                cm, [configs[i] for i in sorted(remaining)], free, seq,
                n_steps, max_degree=max_degree,
            )
            n_calls += res.n_f_calls
            idx_map = sorted(remaining)
            for j in res.jobs:
                ids = tuple(idx_map[i] for i in j.config_ids)
                out.append(
                    ScheduledJob(ids, j.degree, t, t + j.est_time, j.throughput)
                )
                heapq.heappush(running, (t + j.est_time, j.degree))
                free -= j.degree
                remaining -= set(ids)
                launched = True
        if not launched or not remaining:
            if not running:
                break
            end, d = heapq.heappop(running)
            t = end
            free += d
            # release every job ending at the same instant
            while running and running[0][0] <= t + 1e-12:
                _, d2 = heapq.heappop(running)
                free += d2
    makespan = max((j.end for j in out), default=0.0)
    return Schedule(out, makespan, g, n_calls)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------


def _list_schedule(durations_degrees, g) -> Schedule:
    """Greedy list scheduling of (duration, degree) single-config jobs."""
    free = g
    t = 0.0
    running: List[Tuple[float, int]] = []
    out: List[ScheduledJob] = []
    pending = list(enumerate(durations_degrees))
    while pending or running:
        launched = False
        for item in list(pending):
            i, (dur, d) = item
            if d <= free:
                out.append(ScheduledJob((i,), d, t, t + dur))
                heapq.heappush(running, (t + dur, d))
                free -= d
                pending.remove(item)
                launched = True
        if not launched:
            if not running:
                break
            end, d = heapq.heappop(running)
            t, free = end, free + d
            while running and running[0][0] <= t + 1e-12:
                _, d2 = heapq.heappop(running)
                free += d2
    return Schedule(out, max((j.end for j in out), default=0.0), g)


def min_gpu_schedule(
    cm: CostEstimator, configs: Sequence[LoraConfig], g: int, seq: int, n_steps: int
) -> Schedule:
    jobs = []
    for c in configs:
        d = cm.min_degree([c], seq)
        if d is None:
            raise ValueError(f"config {c} does not fit on {g} units")
        jobs.append((cm.job_time([c], d, seq, n_steps), d))
    return _list_schedule(jobs, g)


def max_gpu_schedule(
    cm: CostEstimator, configs: Sequence[LoraConfig], g: int, seq: int, n_steps: int
) -> Schedule:
    jobs = [(cm.job_time([c], g, seq, n_steps), g) for c in configs]
    return _list_schedule(jobs, g)


class _SequentialCostModel(CostModel):
    """Cost model whose packed jobs run adapters sequentially (paper §5.1
    naive execution: batched base pass + per-adapter LoRA kernel loop)."""

    def iter_time(self, configs, d, seq):
        return CostModel.iter_time_sequential(self, configs, d, seq)


def sequential_plora_schedule(
    cm: CostModel, configs: Sequence[LoraConfig], g: int, seq: int, n_steps: int
) -> Schedule:
    """Ablation (paper Fig. 6 'Sequential PLoRA'): PLoRA's planner, but jobs
    execute adapters one at a time (no packed kernels). The planner re-plans
    under the sequential iteration cost, so pack sizes shrink to what the
    naive execution can still amortize (base-pass sharing + setup)."""
    import dataclasses as _dc

    cms = _SequentialCostModel(**{f.name: getattr(cm, f.name) for f in _dc.fields(cm)})
    return plan(cms, configs, g, seq, n_steps)
