"""F(D, K): max-throughput packing of LoRA configs into ONE job (paper Eq 18).

The paper hands this to Gurobi as an ILP. Offline we solve the same problem
exactly under an additive-time surrogate with a Dinkelbach fractional-
programming loop over 0/1-knapsacks (numpy DP), then score candidates with
the TRUE (non-additive, roofline) cost model:

  maximize  (sum_k r_k) / T(H, D)   s.t.   mem(H) <= C * M_gpu * D

Dinkelbach: given lambda, maximize sum_k (r_k - lambda * t_k) via knapsack on
memory; iterate lambda <- best ratio until the optimal value hits ~0. For the
small instances of tests, ``brute_force`` verifies optimality.

The port's copy of ``repro/sched/knapsack.py``: pure Python and numpy, the
same code, so it gives the reference's results exactly.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import LoraConfig
from repro_torch.sched.cost_model import CostEstimator


def _knapsack(values: np.ndarray, weights: np.ndarray, capacity: int):
    """0/1 knapsack, integer weights, float values; returns (best, chosen)."""
    n = len(values)
    dp = np.full(capacity + 1, -np.inf)
    dp[0] = 0.0
    take = np.zeros((n, capacity + 1), bool)
    for i in range(n):
        w, v = int(weights[i]), float(values[i])
        if v <= 0 or w > capacity:
            continue
        cand = dp[: capacity + 1 - w] + v
        tail = dp[w:]
        better = cand > tail
        dp[w:] = np.where(better, cand, tail)
        take[i, w:] = better
    j = int(np.argmax(dp))
    best = dp[j]
    chosen = []
    for i in range(n - 1, -1, -1):
        if j >= 0 and take[i, j]:
            chosen.append(i)
            j -= int(weights[i])
    return best, chosen[::-1]


def solve_pack(
    cm: CostEstimator,
    configs: Sequence[LoraConfig],
    d: int,
    seq: int,
    *,
    grain: int = 512,
    max_iter: int = 25,
    work_cap: Optional[float] = None,
) -> Optional[Tuple[List[int], float]]:
    """Best subset (indices into configs) for ONE job at parallelism d.
    Returns (indices, throughput r/T) or None if even the base doesn't fit."""
    cap_bytes = cm.load_factor * cm.hw.mem_bytes * d
    base_bytes = cm.base_weight_bytes()
    if base_bytes >= cap_bytes:
        return None
    unit = cap_bytes / grain
    mem = np.array(
        [
            (cm.lora_bytes(c, seq) + cm.base_act_bytes(c.batch_size, seq))
            / unit
            for c in configs
        ]
    )
    mem = np.maximum(1, np.ceil(mem)).astype(np.int64)
    capacity = int((cap_bytes - base_bytes) / unit)
    if capacity <= 0:
        return None
    # LoRA-FLOP proxy: the paper's Eq (13) uses rank via "LoRA FLOP is linear
    # in rank" (§2.1); with heterogeneous batch sizes in the space the
    # per-iteration LoRA FLOP is linear in rank * batch, so we weight by both.
    ranks = np.array([c.rank * c.batch_size for c in configs], float)
    # additive time surrogate: marginal iteration-time of each config alone
    t0 = cm.iter_time([], d, seq)
    tk = np.array(
        [max(cm.iter_time([c], d, seq) - t0, 1e-9) for c in configs]
    )

    lam = 0.0
    chosen: List[int] = []
    for _ in range(max_iter):
        vals = ranks - lam * tk
        best, chosen = _knapsack(vals, mem, capacity)
        if not chosen:
            break
        ratio = ranks[chosen].sum() / (t0 + tk[chosen].sum())
        if abs(best - lam * t0) < 1e-9 or abs(ratio - lam) < 1e-12:
            break
        lam = ratio
    # memory feasibility under the true model too
    while chosen and not cm.fits([configs[i] for i in chosen], d, seq):
        worst = max(chosen, key=lambda i: mem[i])
        chosen.remove(worst)

    # Local search on the TRUE (non-additive, saturating) cost model. The
    # additive Dinkelbach surrogate badly underestimates packing benefit when
    # the device is unsaturated (marginal cost of an extra adapter << its
    # standalone cost — the paper's core observation), so the seed is refined
    # by greedy add / drop moves scored with cm.throughput directly.
    n = len(configs)

    def thr(ids: List[int]) -> float:
        if not ids:
            return 0.0
        return cm.throughput([configs[i] for i in ids], d, seq)

    def work(ids) -> float:
        return float(ranks[list(ids)].sum()) if ids else 0.0

    cur = list(chosen)
    best_thr = thr(cur)
    improved = True
    while improved:
        improved = False
        # adds (respecting the DTM balance cap)
        outside = [i for i in range(n) if i not in cur]
        gains = []
        for i in outside:
            if work_cap is not None and work(cur) + ranks[i] > work_cap:
                continue
            trial = cur + [i]
            if not cm.fits([configs[k] for k in trial], d, seq):
                continue
            t = thr(trial)
            if t > best_thr * (1 + 1e-9):
                gains.append((t, i))
        if gains:
            t, i = max(gains)
            cur.append(i)
            best_thr = t
            improved = True
            continue
        # drops
        for i in list(cur):
            trial = [k for k in cur if k != i]
            t = thr(trial)
            if t > best_thr * (1 + 1e-9):
                cur = trial
                best_thr = t
                improved = True
                break
    if not cur:
        return None
    return sorted(cur), best_thr


def brute_force(
    cm: CostEstimator, configs: Sequence[LoraConfig], d: int, seq: int
) -> Optional[Tuple[List[int], float]]:
    """Exhaustive optimum (tests only; len(configs) <= ~15)."""
    n = len(configs)
    best, best_set = None, None
    for mask in range(1, 1 << n):
        sel_idx = [i for i in range(n) if mask >> i & 1]
        sel = [configs[i] for i in sel_idx]
        if not cm.fits(sel, d, seq):
            continue
        thr = cm.throughput(sel, d, seq)
        if best is None or thr > best:
            best, best_set = thr, sel_idx
    if best is None:
        return None
    return best_set, best
