"""Cluster runner: real concurrent execution of planned segments (the port
of ``repro/cluster/runner.py``).

The engine's event loop plans *virtual* segments — (configs, degree, device
units, start/end). The runner turns that plan into wall-clock reality:

  * a dispatch loop walks segments in virtual-start order;
  * each segment first waits for its resume dependencies (the checkpointed
    state a preempted predecessor writes), then blocks in
    ``DevicePool.acquire_units`` until its *planned* units are freed by the
    real completions of earlier segments — device-free events fire from
    actual training, not the virtual clock;
  * with ``concurrent=True`` the segment then runs on its own thread against
    its own disjoint :class:`MeshSlice`, so segments scheduled on different
    groups genuinely overlap; ``concurrent=False`` runs the identical
    placement serially (the degenerate single-slice pool).

Because both modes execute the same per-segment computation on the same
slice widths, per-adapter losses are bit-identical between them (the port's
tests check this on two CPU "devices").
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.executor import SliceExecutor, _slice_track
from repro_torch.cluster.pool import DevicePool, MeshSlice
from repro_torch.obs import NULL_TRACER


@dataclass(frozen=True)
class SegmentTiming:
    """Measured-vs-predicted per-iteration wall time of one executed segment
    — the raw material of the profile feedback loop. ``predicted_iter`` is
    the estimator's answer at dispatch time (NaN when no estimator was
    given); ``drift`` is ``measured / predicted - 1``."""

    job_id: int
    config_ids: Tuple[int, ...]
    degree: int
    run_steps: int
    seq: int
    measured_iter: float
    predicted_iter: float

    @property
    def drift(self) -> float:
        if not (self.predicted_iter > 0.0):  # NaN / zero -> undefined
            return float("nan")
        return self.measured_iter / self.predicted_iter - 1.0


@dataclass
class ClusterResult:
    """Outcome of executing one batch of segments on the pool."""

    records: List  # JobRecord per segment, in virtual-start order
    makespan: float  # wall-clock seconds, first dispatch -> last completion
    concurrent: bool
    # (job_id, real_start, real_end, units) per segment, runner-relative
    timeline: List[Tuple[int, float, float, Tuple[int, ...]]] = field(
        default_factory=list
    )
    # per-segment measured step times (virtual-start order, like records)
    timings: List[SegmentTiming] = field(default_factory=list)

    def max_overlap(self) -> int:
        """Peak number of segments running at the same wall-clock instant."""
        return peak_overlap([(s, e) for _, s, e, _ in self.timeline])


def resume_deps(order: Sequence) -> List[List[int]]:
    """Checkpoint-resume dependencies between virtual-ordered segments.

    ``deps[i]`` lists the indices (into ``order``) whose completion segment
    ``order[i]`` must wait for before it can load resumed adapter state: a
    segment that starts config ``cid`` at step ``s > 0`` depends on the
    LAST earlier segment that checkpoints cid's state at exactly step ``s``.
    Keying on the latest writer (not a bare ``(cid, step)`` event) matters:
    a zero-step re-preemption re-writes the same ``(cid, step)``, and a
    segment must never end up waiting on *itself* or on a later writer —
    that would deadlock the dispatch loop."""
    writer_of: Dict[Tuple[int, int], int] = {}
    deps: List[List[int]] = []
    for idx, seg in enumerate(order):
        deps.append(
            sorted(
                {
                    writer_of[(cid, st0)]
                    for cid, st0 in zip(seg.config_ids, seg.start_steps)
                    if st0 > 0 and (cid, st0) in writer_of
                }
            )
        )
        if seg.preempted:
            done = set(seg.done_ids)
            for cid, st0 in zip(seg.config_ids, seg.start_steps):
                if cid not in done:
                    writer_of[(cid, st0 + seg.run_steps)] = idx
    return deps


def peak_overlap(intervals: Sequence[Tuple[float, float]]) -> int:
    """Sweep-line peak of concurrently open ``(start, end)`` intervals."""
    events = []
    for s, e in intervals:
        events.append((s, 1))
        events.append((e, -1))
    peak = cur = 0
    for _, d in sorted(events):
        cur += d
        peak = max(peak, cur)
    return peak


class ClusterRunner:
    """Drives planned segments onto a :class:`DevicePool`.

    The port's :class:`~repro_torch.cluster.api.Runner` implementation.
    ``concurrent=None`` (default) auto-selects: concurrent when the pool
    holds more than one device, else the sequential mode. Without an
    ``executor`` or a ``pool`` it makes the defaults: a capturing
    :class:`SliceExecutor` and the host's CUDA devices."""

    def __init__(
        self,
        executor: Optional[SliceExecutor] = None,
        pool: Optional[DevicePool] = None,
        *,
        concurrent: Optional[bool] = None,
        tracer=None,
    ):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.executor = executor or SliceExecutor(tracer=self.tracer)
        # a caller-supplied executor without its own tracer adopts ours, so
        # one `tracer=` at the runner threads through the whole segment path
        # (executor fakes without a .tracer attribute are left alone)
        ex_tracer = getattr(self.executor, "tracer", None)
        if (self.tracer.enabled and ex_tracer is not None
                and not ex_tracer.enabled):
            self.executor.tracer = self.tracer
        self.device_pool = pool or DevicePool()
        self.concurrent = (
            self.device_pool.total > 1 if concurrent is None else concurrent
        )
        self.last_result: Optional[ClusterResult] = None

    def run(
        self,
        segments: Sequence,  # JobSegment
        configs_by_cid: Dict,
        total_steps: Dict[int, int],
        cfg,
        base_params,
        *,
        seq: int,
        pool=None,  # CheckpointPool
        data_iter_fn: Optional[Callable] = None,
        seed: int = 0,
        estimator=None,  # Optional[repro_torch.sched.cost_model.CostEstimator]
        impl: Optional[str] = None,
        remat: Optional[str] = None,
        base_dtype: Optional[str] = None,
    ) -> ClusterResult:
        """Execute planned segments. With an ``estimator``, each segment's
        predicted per-iteration time is captured at dispatch and its measured
        time is fed back via ``estimator.observe(...)`` on completion (a
        no-op for the pure analytic prior) — the measured/predicted pairs are
        surfaced on ``ClusterResult.timings`` either way.

        ``impl``/``remat``/``base_dtype`` select the kernel policy for every
        segment (``base_dtype`` marks a quantized frozen base); when
        ``impl`` is None the *caller's* context-local default
        (``ops.default_impl()``) is captured here — worker threads never see
        the caller's contextvars, so the policy must cross the thread
        boundary as an explicit argument."""
        if impl is None:
            from repro_torch.kernels.ops import default_impl

            impl = default_impl()
        impl = None if impl == "auto" else impl
        # the pool may be shared with a live serve loop holding its own
        # lease: the drain invariant is "free count returns to what it was
        # at entry", not "fully free"
        free0 = self.device_pool.free
        order = sorted(segments, key=lambda s: (s.start, s.job_id))
        done_events = [threading.Event() for _ in order]
        deps = resume_deps(order)
        results: List = [None] * len(order)
        predicted: List[float] = [float("nan")] * len(order)
        errors: List[BaseException] = []

        tracer = self.tracer
        free_gauge = tracer.metrics.gauge("cluster.free_units")
        run_parent: List[Optional[int]] = [None]

        def worker(idx: int, seg, slice_: MeshSlice):
            # the slice was acquired by the dispatch loop (to preserve
            # dispatch order); `held` guarantees this thread gives it back
            # no matter how the executor dies. The explicit ``parent=``
            # stitches this pool-thread span under the dispatcher-thread
            # "runner.run" span (thread-local stacks don't cross threads).
            try:
                with self.device_pool.held(slice_):
                    with tracer.span(
                        "runner.segment", cat="runner",
                        parent=run_parent[0], track=_slice_track(slice_),
                        job_id=seg.job_id, units=list(slice_.units),
                    ):
                        rec = self.executor.run_segment(
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
                            remat=remat,
                            base_dtype=base_dtype,
                        )
                    results[idx] = rec
                    if estimator is not None and seg.run_steps > 0:
                        estimator.observe(
                            [configs_by_cid[cid] for cid in seg.config_ids],
                            seg.degree,
                            seq,
                            rec.wall_seconds / seg.run_steps,
                        )
            except BaseException as e:  # noqa: BLE001 — re-raised by run()
                errors.append(e)
            finally:
                free_gauge.set(self.device_pool.free)
                done_events[idx].set()

        # Pre-warm the pack-state template of every distinct pack shape in
        # the dispatcher thread: template init is expensive, so concurrent
        # workers racing to build the same one would serialize anyway --
        # build each once, up front (on the pool's first device's kind of
        # generator, which every slice of a homogeneous pool shares).
        seen = set()
        for seg in order:
            job_cfgs = tuple(configs_by_cid[cid] for cid in seg.config_ids)
            if job_cfgs not in seen:
                seen.add(job_cfgs)
                self.executor.pack_template(cfg, job_cfgs, seed,
                                            device=self.device_pool.devices[0])

        t0 = time.perf_counter()
        tpe = (
            ThreadPoolExecutor(max_workers=self.device_pool.total)
            if self.concurrent
            else None
        )
        with tracer.span(
            "runner.run", cat="runner", n_segments=len(order),
            concurrent=self.concurrent,
        ) as run_span:
            run_parent[0] = run_span.span_id or None
            try:
                for idx, seg in enumerate(order):
                    if errors:
                        break
                    if estimator is not None:
                        predicted[idx] = estimator.iter_time(
                            [configs_by_cid[cid] for cid in seg.config_ids],
                            seg.degree,
                            seq,
                        )
                    with tracer.span(
                        "runner.wait_units", cat="runner",
                        job_id=seg.job_id,
                        units=list(getattr(seg, "units", ()) or ()),
                    ):
                        for dep in deps[idx]:
                            done_events[dep].wait()
                        units = getattr(seg, "units", ()) or ()
                        if units:
                            slice_ = self.device_pool.acquire_units(
                                self.device_pool.map_units(units)
                            )
                        else:  # unplanned segment: grab whatever fits
                            slice_ = self.device_pool.acquire(
                                min(seg.degree, self.device_pool.total)
                            )
                    free_gauge.set(self.device_pool.free)
                    try:
                        if tpe is not None:
                            tpe.submit(worker, idx, seg, slice_)
                        else:
                            worker(idx, seg, slice_)
                    except RuntimeError:
                        # submit refused (executor already shutting down):
                        # the worker never ran, so give the slice back here
                        self.device_pool.release(slice_)
                        done_events[idx].set()
                        raise
            finally:
                if tpe is not None:
                    tpe.shutdown(wait=True)
        if errors:
            raise errors[0]
        # free dropping below its entry level means a segment path here
        # released without a lease; a *rise* just means some foreign lease
        # (e.g. a serve loop's) was returned while we ran — not ours to flag
        leaked = free0 - self.device_pool.free
        if leaked > 0:
            raise RuntimeError(
                f"device pool leaked {leaked} unit(s) at run exit — a "
                "segment path released without going through a lease"
            )

        timeline = []
        timings = []
        makespan = 0.0
        for idx, (seg, rec) in enumerate(zip(order, results)):
            rec.real_start -= t0
            rec.real_end -= t0
            makespan = max(makespan, rec.real_end)
            timeline.append(
                (seg.job_id, rec.real_start, rec.real_end,
                 tuple(getattr(seg, "units", ()) or ()))
            )
            timings.append(
                SegmentTiming(
                    job_id=seg.job_id,
                    config_ids=tuple(seg.config_ids),
                    degree=seg.degree,
                    run_steps=seg.run_steps,
                    seq=seq,
                    measured_iter=(
                        rec.wall_seconds / seg.run_steps
                        if seg.run_steps > 0
                        else float("nan")
                    ),
                    predicted_iter=predicted[idx],
                )
            )
        result = ClusterResult(
            records=list(results),
            makespan=makespan,
            concurrent=self.concurrent,
            timeline=timeline,
            timings=timings,
        )
        self.last_result = result
        return result
