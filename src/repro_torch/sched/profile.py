"""Profile-guided cost estimation: measured segment timings fed back into
planning.

The paper calibrates its analytic roofline from ~10 profiled iterations and
then trusts it for the whole run; on oversubscribed or heterogeneous hardware
that prior drifts, and the cluster executor already measures every segment's
real wall-clock anyway. This module closes the loop:

  * :class:`ObservationStore` — a thread-safe online store of
    (model, pack width, bucket rank, batch, degree, seq) -> per-iteration
    wall-time observations, EWMA-smoothed with observation counts, JSON
    save/load so a profile survives across runs (``launch.train
    --profile-out/--profile-in``);
  * :class:`ProfiledCostModel` — a :class:`~repro_torch.sched.cost_model
    .CostEstimator` that answers ``iter_time`` from measurements when it has
    them and falls back to the analytic prior (scaled by the observed
    prediction-error ratio) when it does not. Memory queries always delegate
    to the prior — measurements say nothing about feasibility.

Fallback ladder for an unmeasured key, most- to least-specific:

  1. exact key observed            -> its EWMA;
  2. same *degree* observed        -> prior * ratio[degree]   (TP overheads
     are the dominant per-degree modeling error on real hosts);
  3. nothing at this degree        -> the pure prior.

Step 3 is deliberately *optimistic*: an unmeasured degree keeps the
prior's (usually rosy) estimate rather than inheriting another degree's
error ratio. That optimism is what drives exploration — when the degree
the prior favored turns out slow, the planner's next-best degree still
looks cheap, gets tried, gets measured, and the comparison is honest from
then on. Scaling unseen degrees by a global ratio would preserve the
prior's (wrong) degree ordering forever. The cross-key global ratio is
still tracked (``ObservationStore.ratio()``) for diagnostics.

The virtual-clock simulator must never see any of this:
``ProfiledCostModel.virtual_model()`` returns the pure prior, keeping
``ExecutionEngine.simulate`` (and the reference's online planner)
byte-identical and deterministic regardless of measurement state.

The port's copy of ``repro/sched/profile.py``: pure Python and numpy, the
same code, so it gives the reference's results exactly.
"""
from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.configs.base import LoraConfig
from repro_torch.sched.cost_model import CostEstimator, CostModel

# EWMA weight of a NEW observation (responsive: two observations already
# weight the prior measurement down to 25%)
DEFAULT_ALPHA = 0.5

# |measured / predicted - 1| beyond which the engine treats a running job's
# rate as having drifted from plan and re-assigns device units (the
# reference's adaptive engine; the port reports drift per segment)
DEFAULT_DRIFT_THRESHOLD = 0.5

_SCHEMA = 2  # 2: obs keys carry a host-class tag (schema-1 loads as "")


@dataclass
class Observation:
    """EWMA of one key's measured per-iteration seconds + sample count."""

    ewma: float
    n: int = 1

    def update(self, x: float, alpha: float) -> None:
        self.ewma = (1.0 - alpha) * self.ewma + alpha * x
        self.n += 1


def obs_key(
    model_name: str,
    configs: Sequence[LoraConfig],
    d: int,
    seq: int,
    host_class: str = "",
) -> Tuple[str, int, int, int, int, int, str]:
    """Observation key of one packed job: iteration time depends on the pack's
    *shape* — width, bucket rank, total batch — not on which adapters fill it
    (hyperparameters are runtime args; same-shape packs share executables).
    ``host_class`` is the hardware class tag of the host the pack ran on
    ("" = unclassed / homogeneous fleet): the same shape on a different
    hardware generation is a different measurement. The degree stays at
    index 4 — :meth:`ObservationStore.update` keys its ratio ladder on it."""
    return (
        model_name,
        len(configs),
        CostModel.bucket_rank(configs) if configs else 0,
        sum(c.batch_size for c in configs),
        d,
        seq,
        host_class,
    )


class ObservationStore:
    """Thread-safe (key -> EWMA iter-time) store with prediction-error ratios.

    Besides the per-key EWMAs it maintains per-degree and global EWMAs of
    ``measured / prior_predicted`` — the calibration ratios the profiled
    estimator uses to price configurations it has never run (the planner
    constantly asks about packs/degrees that differ from what executed)."""

    def __init__(self, alpha: float = DEFAULT_ALPHA):
        self.alpha = alpha
        self._obs: Dict[Tuple, Observation] = {}
        self._ratio_by_degree: Dict[int, Observation] = {}
        # heterogeneous fleets: calibration per host class, most-specific
        # first — (class, degree) then class-wide. The class-blind ratios
        # above still see every observation, so a homogeneous run ("" class
        # everywhere) behaves exactly as before.
        self._ratio_by_class: Dict[Tuple[str, int], Observation] = {}
        self._ratio_class_any: Dict[str, Observation] = {}
        self._ratio: Optional[Observation] = None
        self._lock = threading.Lock()

    @staticmethod
    def _bump(table: Dict, key, r: float, alpha: float) -> None:
        hit = table.get(key)
        if hit is None:
            table[key] = Observation(r)
        else:
            hit.update(r, alpha)

    # ---------------- updates / queries ----------------

    def update(self, key: Tuple, measured: float, predicted_prior: float) -> None:
        with self._lock:
            hit = self._obs.get(key)
            if hit is None:
                self._obs[key] = Observation(measured)
            else:
                hit.update(measured, self.alpha)
            if predicted_prior > 0.0:
                r = measured / predicted_prior
                d = int(key[4])
                self._bump(self._ratio_by_degree, d, r, self.alpha)
                cls = str(key[6]) if len(key) > 6 else ""
                if cls:
                    self._bump(self._ratio_by_class, (cls, d), r, self.alpha)
                    self._bump(self._ratio_class_any, cls, r, self.alpha)
                if self._ratio is None:
                    self._ratio = Observation(r)
                else:
                    self._ratio.update(r, self.alpha)

    def get(self, key: Tuple) -> Optional[Observation]:
        with self._lock:
            return self._obs.get(key)

    def ratio(self, d: Optional[int] = None) -> Optional[float]:
        """Calibration ratio for degree ``d``, or — with ``d=None`` — the
        global cross-key ratio (diagnostics only; see the module docstring
        on why unseen degrees do NOT inherit it). None before any
        observation at that degree."""
        with self._lock:
            if d is not None:
                rd = self._ratio_by_degree.get(d)
                return rd.ewma if rd is not None else None
            return self._ratio.ewma if self._ratio is not None else None

    def class_ratio(
        self, host_class: str, d: Optional[int] = None
    ) -> Optional[float]:
        """Measured slowdown of ``host_class`` vs the prior: the
        per-(class, degree) EWMA when ``d`` was observed on that class, else
        the class-wide EWMA, else None (class never measured)."""
        with self._lock:
            if d is not None:
                rc = self._ratio_by_class.get((host_class, d))
                if rc is not None:
                    return rc.ewma
            ra = self._ratio_class_any.get(host_class)
            return ra.ewma if ra is not None else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._obs)

    @property
    def n_observations(self) -> int:
        with self._lock:
            return sum(o.n for o in self._obs.values())

    # ---------------- persistence ----------------

    def to_json(self) -> Dict:
        with self._lock:
            return {
                "schema": _SCHEMA,
                "alpha": self.alpha,
                "observations": [
                    {"key": list(k), "ewma": o.ewma, "n": o.n}
                    for k, o in sorted(self._obs.items())
                ],
                "ratio_by_degree": {
                    str(d): {"ewma": o.ewma, "n": o.n}
                    for d, o in sorted(self._ratio_by_degree.items())
                },
                "ratio_by_class": [
                    {"class": c, "degree": d, "ewma": o.ewma, "n": o.n}
                    for (c, d), o in sorted(self._ratio_by_class.items())
                ],
                "ratio_class_any": {
                    c: {"ewma": o.ewma, "n": o.n}
                    for c, o in sorted(self._ratio_class_any.items())
                },
                "ratio": (
                    {"ewma": self._ratio.ewma, "n": self._ratio.n}
                    if self._ratio is not None
                    else None
                ),
            }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @classmethod
    def from_json(cls, blob: Dict) -> "ObservationStore":
        schema = blob.get("schema")
        if schema not in (1, _SCHEMA):
            raise ValueError(f"unknown profile schema {schema!r}")
        store = cls(alpha=float(blob.get("alpha", DEFAULT_ALPHA)))
        for row in blob.get("observations", []):
            key = tuple(row["key"])
            if schema == 1:  # pre-class keys: tag as unclassed
                key = key + ("",)
            store._obs[key] = Observation(float(row["ewma"]), int(row["n"]))
        for d, row in blob.get("ratio_by_degree", {}).items():
            store._ratio_by_degree[int(d)] = Observation(
                float(row["ewma"]), int(row["n"])
            )
        for row in blob.get("ratio_by_class", []):
            store._ratio_by_class[(str(row["class"]), int(row["degree"]))] = (
                Observation(float(row["ewma"]), int(row["n"]))
            )
        for c, row in blob.get("ratio_class_any", {}).items():
            store._ratio_class_any[str(c)] = Observation(
                float(row["ewma"]), int(row["n"])
            )
        if blob.get("ratio") is not None:
            store._ratio = Observation(
                float(blob["ratio"]["ewma"]), int(blob["ratio"]["n"])
            )
        return store

    @classmethod
    def load(cls, path: str) -> "ObservationStore":
        with open(path) as f:
            return cls.from_json(json.load(f))


class ProfiledCostModel(CostEstimator):
    """The analytic prior wrapped with an online observation store.

    Time queries prefer measurements (fallback ladder in the module
    docstring); memory/feasibility queries and every other attribute
    delegate to the prior, so the packing solver's memory accounting is
    identical whether planning runs calibrated or not — only *durations*
    adapt. ``virtual_model()`` returns the pure prior for simulation."""

    def __init__(
        self,
        prior: CostModel,
        store: Optional[ObservationStore] = None,
        *,
        drift_threshold: float = DEFAULT_DRIFT_THRESHOLD,
    ):
        self.prior = prior
        self.store = store if store is not None else ObservationStore()
        self.drift_threshold = drift_threshold

    def __getattr__(self, name):
        # memory model, hardware spec, setup_time, calibrate, ... — anything
        # not overridden here is the prior's business. (Guard 'prior' itself:
        # attribute lookup during unpickling/copy runs before __init__.)
        if name == "prior":
            raise AttributeError(name)
        return getattr(self.prior, name)

    # the engine passes host_class= to time/feedback queries only when the
    # estimator advertises it (plain CostModels stay class-blind)
    class_aware = True

    def key(
        self, configs: Sequence[LoraConfig], d: int, seq: int,
        host_class: str = "",
    ) -> Tuple:
        return obs_key(self.prior.cfg.name, configs, d, seq, host_class)

    # ---------------- time ----------------

    def iter_time(
        self, configs: Sequence[LoraConfig], d: int, seq: int,
        host_class: str = "",
    ) -> float:
        """Fallback ladder (module docstring), extended per host class:
        exact key (with class) -> that class's measured ratio (per-degree,
        then class-wide) -> the class-blind per-degree ratio -> prior."""
        obs = self.store.get(self.key(configs, d, seq, host_class))
        if obs is not None:
            return obs.ewma
        prior_t = self.prior.iter_time(configs, d, seq)
        if host_class:
            cr = self.store.class_ratio(host_class, d)
            if cr is not None:
                return prior_t * cr
        ratio = self.store.ratio(d)
        return prior_t if ratio is None else prior_t * ratio

    def class_ratio(self, host_class: str, d: Optional[int] = None) -> float:
        """Measured slowdown of a host class vs the prior (1.0 when the
        class is unmeasured or unclassed) — the engine's placement ranking."""
        if not host_class:
            return 1.0
        r = self.store.class_ratio(host_class, d)
        return 1.0 if r is None else r

    # ---------------- memory (always the prior) ----------------

    def fits(self, configs: Sequence[LoraConfig], d: int, seq: int) -> bool:
        return self.prior.fits(configs, d, seq)

    def min_degree(self, configs: Sequence[LoraConfig], seq: int) -> Optional[int]:
        return self.prior.min_degree(configs, seq)

    # ---------------- feedback ----------------

    def observe(
        self,
        configs: Sequence[LoraConfig],
        d: int,
        seq: int,
        measured_iter_time: float,
        host_class: str = "",
    ) -> None:
        self.store.update(
            self.key(configs, d, seq, host_class),
            measured_iter_time,
            self.prior.iter_time(configs, d, seq),
        )

    def observed(
        self, configs: Sequence[LoraConfig], d: int, seq: int,
        host_class: str = "",
    ) -> bool:
        return self.store.get(self.key(configs, d, seq, host_class)) is not None

    def drift(
        self,
        configs: Sequence[LoraConfig],
        d: int,
        seq: int,
        measured_iter_time: float,
        host_class: str = "",
    ) -> float:
        """Signed relative error of the *current* prediction against a fresh
        measurement: ``measured / predicted - 1``. Positive = the job runs
        slower than planned (starved / oversubscribed); negative = faster
        (over-provisioned)."""
        pred = self.iter_time(configs, d, seq, host_class)
        if pred <= 0.0:
            return 0.0
        return measured_iter_time / pred - 1.0

    # ---------------- simulation contract ----------------

    @property
    def adaptive(self) -> bool:
        return True

    def virtual_model(self) -> CostModel:
        return self.prior
