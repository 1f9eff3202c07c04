"""Decomposed Throughput Maximization — Algorithm 1 of the paper.

DTMHelper enumerates power-of-2 parallelism degrees (largest-first), calls the
packing solver F(d, K) per degree, and recurses on the remaining devices and
configs; DTM returns the policy with the best objective among all collected
policies. F-calls are memoized on (d, remaining-config ids) — the paper's
"286 ILP calls for 8 GPUs" collapses the same way.

The port's copy of ``repro/sched/dtm.py``: pure Python and numpy, the
same code, so it gives the reference's results exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.configs.base import LoraConfig
from repro_torch.sched.cost_model import CostEstimator
from repro_torch.sched.knapsack import solve_pack


@dataclass(frozen=True)
class JobPlan:
    """One packed fine-tuning job: configs (by index), parallelism, est time."""

    config_ids: Tuple[int, ...]
    degree: int
    est_time: float  # seconds for n_steps
    throughput: float  # sum(rank)/iter_time


@dataclass
class DTMResult:
    jobs: List[JobPlan]
    n_f_calls: int


def dtm(
    cm: CostEstimator,
    configs: Sequence[LoraConfig],
    g: int,
    seq: int,
    n_steps: int,
    *,
    residual_steps: Optional[Sequence[int]] = None,
    max_policies: int = 4096,
    max_degree: Optional[int] = None,
) -> DTMResult:
    """Best set of concurrent jobs for `g` free device units.

    ``residual_steps`` (online engine) gives each config its own remaining
    iteration count — adapters resumed after a preemption need fewer steps
    than fresh arrivals. A packed job's est_time is then
    ``cm.job_time_residual`` (setup + max residual * iter_time). ``None``
    means every config runs the uniform ``n_steps``.

    ``max_degree`` caps the parallelism degree of any single job — the
    multi-host engine passes its per-host device count here, because a
    packed job's mesh slice cannot span hosts even when the *total* free
    unit count is larger.
    """
    all_ids = frozenset(range(len(configs)))
    steps = (
        list(residual_steps)
        if residual_steps is not None
        else [n_steps] * len(configs)
    )
    assert len(steps) == len(configs)
    f_cache: Dict[Tuple[int, FrozenSet[int]], Optional[Tuple[Tuple[int, ...], float]]] = {}
    n_calls = [0]
    policies: List[List[JobPlan]] = []
    seen_states = set()

    total_work = sum(c.rank * c.batch_size for c in configs)

    def f(d: int, ids: FrozenSet[int], g_rem: int):
        key = (d, ids)
        if key not in f_cache:
            n_calls[0] += 1
            sub = sorted(ids)
            # balance hint: a d-unit job should absorb ~its device share of
            # the remaining work, or the final wave leaves a long tail
            # (the Thm 6.1 bubble). 1.25x headroom for granularity.
            work_rem = sum(configs[i].rank * configs[i].batch_size for i in sub)
            cap = 1.25 * work_rem * d / max(g_rem, 1)
            res = solve_pack(
                cm, [configs[i] for i in sub], d, seq, work_cap=cap
            )
            if res is None:
                f_cache[key] = None
            else:
                chosen_local, _ = res
                chosen = tuple(sub[i] for i in chosen_local)
                sel = [configs[i] for i in chosen]
                thr = cm.throughput(sel, d, seq)
                t = cm.job_time_residual(sel, [steps[i] for i in chosen], d, seq)
                f_cache[key] = (chosen, (thr, t))
        return f_cache[key]

    def helper(g_rem: int, acc: List[JobPlan], ids: FrozenSet[int]):
        if len(policies) >= max_policies:
            return
        state = (g_rem, ids, tuple(sorted((j.config_ids, j.degree) for j in acc)))
        if state in seen_states:
            return
        seen_states.add(state)
        if g_rem <= 0 or not ids:
            policies.append(list(acc))
            return
        gp = 1 << (g_rem.bit_length() - 1)  # round down to power of 2
        if max_degree is not None:
            gp = min(gp, 1 << (max_degree.bit_length() - 1))
        d = gp
        expanded = False
        while d >= 1:
            res = f(d, ids, g_rem)
            if res is not None:
                chosen, (thr, t) = res
                job = JobPlan(chosen, d, t, thr)
                helper(g_rem - d, acc + [job], ids - set(chosen))
                expanded = True
            d //= 2
        if not expanded:
            policies.append(list(acc))

    helper(g, [], all_ids)
    if not policies:
        return DTMResult([], n_calls[0])

    n_total = len(configs)

    def score(p: List[JobPlan]):
        # Paper Alg. 1 line 11: argmin T(p). When a policy schedules every
        # remaining config, T(p) is the wave makespan — minimize it (this is
        # what keeps the Thm 6.1 tail small). Otherwise rank by instantaneous
        # throughput (Eq 13), the streaming-optimal criterion.
        #
        # Online-aware tie-break: among otherwise-equal policies prefer the
        # one holding fewer busy device-seconds (shorter jobs first) — its
        # devices free *earlier*, so the engine's next repack-on-free event
        # comes sooner and late arrivals wait less. Offline this is a pure
        # tie-break (primary keys unchanged); online it is what lets
        # repack-on-free win on more traces.
        covered = sum(len(j.config_ids) for j in p)
        dev_seconds = sum(j.est_time * j.degree for j in p)
        if covered == n_total and p:
            return (
                0,
                max(j.est_time for j in p),
                dev_seconds,
                -sum(j.throughput for j in p),
            )
        return (1, -sum(j.throughput for j in p), -covered, dev_seconds)

    best = min(policies, key=score)
    if best and sum(len(j.config_ids) for j in best) == n_total:
        best = _rebalance(cm, configs, best, seq, steps)
    return DTMResult(best, n_calls[0])


def _rebalance(
    cm: CostEstimator,
    configs: Sequence[LoraConfig],
    jobs: List[JobPlan],
    seq: int,
    steps: Sequence[int],
) -> List[JobPlan]:
    """LPT rebalance of a covering wave: keep each job's parallelism degree,
    reassign configs (largest marginal time first) to the job that minimizes
    the running max — this is what makes argmin T(p) (Alg. 1 line 11) tight
    and keeps the Thm 6.1 tail at the ~1.1x the paper reports. The LPT loads
    balance per-iteration time; heterogeneous residual step counts only enter
    the final est_time (a residual-weighted LPT would need per-pair
    max-coupling and buys little at wave granularity)."""
    ids = sorted({i for j in jobs for i in j.config_ids})
    degrees = [j.degree for j in jobs]
    t0 = {d: cm.iter_time([], d, seq) for d in set(degrees)}
    marg = {
        (i, d): max(cm.iter_time([configs[i]], d, seq) - t0[d], 1e-9)
        for i in ids
        for d in set(degrees)
    }
    loads = [t0[d] for d in degrees]
    assign: List[List[int]] = [[] for _ in jobs]
    order = sorted(ids, key=lambda i: -marg[(i, degrees[0])])
    for i in order:
        cand = sorted(range(len(jobs)), key=lambda j: loads[j] + marg[(i, degrees[j])])
        placed = False
        for j in cand:
            sel = [configs[k] for k in assign[j] + [i]]
            if cm.fits(sel, degrees[j], seq):
                assign[j].append(i)
                loads[j] += marg[(i, degrees[j])]
                placed = True
                break
        if not placed:  # memory-tight: leave with the original owner
            owner = next(k for k, jb in enumerate(jobs) if i in jb.config_ids)
            assign[owner].append(i)
            loads[owner] += marg[(i, degrees[owner])]
    out = []
    for j, jb in enumerate(jobs):
        if not assign[j]:
            continue
        sel = [configs[k] for k in assign[j]]
        out.append(
            JobPlan(
                tuple(assign[j]),
                jb.degree,
                cm.job_time_residual(
                    sel, [steps[k] for k in assign[j]], jb.degree, seq
                ),
                cm.throughput(sel, jb.degree, seq),
            )
        )
    # rebalance must not beat memory: fall back if anything went infeasible
    for jp in out:
        if not cm.fits([configs[k] for k in jp.config_ids], jp.degree, seq):
            return jobs
    return out
