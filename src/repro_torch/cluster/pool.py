"""Device pool: partition the host's devices into disjoint slices (the port
of ``repro/cluster/pool.py``).

The scheduler plans jobs over ``g`` abstract *device units*; this module owns
the mapping from those units to real devices: the host's CUDA devices by
default, or any list the caller gives (the CPU tests pass
``[torch.device("cpu")] * n``, or plain strings for accounting alone).
A :class:`MeshSlice` is a disjoint device subset wide enough for one packed
job's parallelism degree; the pool hands slices out (`acquire` /
`acquire_units`) and takes them back (`release`) with strict accounting, so
concurrently running segments can never share a device by accident.

The pool is thread-safe: the cluster runner's dispatch thread blocks in
``acquire_units`` until a segment's planned units are freed by the real
completions of earlier segments — this is what turns the engine's virtual
device-free events into wall-clock ones.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class MeshSlice:
    """A disjoint subset of the pool's devices backing one packed job."""

    units: Tuple[int, ...]  # pool unit ids (sorted, disjoint across slices)
    devices: Tuple  # the actual devices, one per unit (deduplicated)

    @property
    def width(self) -> int:
        return len(self.devices)

    @property
    def lead(self):
        return self.devices[0]

    def mesh(self):
        """The device this slice runs on: the port runs width-1 slices only,
        so a wider slice, which needs a device mesh, raises (sharded slices
        are not ported yet)."""
        if self.width > 1:
            raise NotImplementedError(
                f"a slice of {self.width} devices needs sharded execution, which the "
                "port does not have yet: plan with degree 1 per job"
            )
        return self.lead


class DevicePool:
    """Thread-safe partition of devices into disjoint, accountable slices."""

    def __init__(self, devices: Optional[Sequence] = None):
        if devices is None:
            import torch

            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError(
                "DevicePool needs at least one device: no CUDA device here (pass "
                "devices=[torch.device('cpu')] to run on the CPU)"
            )
        self.devices = list(devices)
        self._lock = threading.Condition()
        self._free = set(range(len(self.devices)))

    @property
    def total(self) -> int:
        return len(self.devices)

    @property
    def free(self) -> int:
        with self._lock:
            return len(self._free)

    def _make_slice(self, units: Tuple[int, ...]) -> MeshSlice:
        devs = tuple(self.devices[u] for u in units)
        return MeshSlice(units=units, devices=devs)

    def try_acquire(self, g: int) -> Optional[MeshSlice]:
        """Non-blocking: a slice of ``g`` units, or None if fewer are free."""
        if g <= 0:
            raise ValueError(f"slice width must be positive, got {g}")
        if g > self.total:
            raise ValueError(
                f"slice of width {g} requested but the pool holds only "
                f"{self.total} devices"
            )
        with self._lock:
            if len(self._free) < g:
                return None
            units = tuple(sorted(self._free)[:g])
            self._free -= set(units)
            return self._make_slice(units)

    def acquire(self, g: int, timeout: Optional[float] = None) -> MeshSlice:
        """Block until ``g`` units are free, then take them."""
        if g > self.total:
            raise ValueError(
                f"slice of width {g} requested but the pool holds only "
                f"{self.total} devices"
            )
        with self._lock:
            if not self._lock.wait_for(
                lambda: len(self._free) >= g, timeout=timeout
            ):
                raise TimeoutError(
                    f"timed out waiting for {g} free units "
                    f"({len(self._free)}/{self.total} free)"
                )
            units = tuple(sorted(self._free)[:g])
            self._free -= set(units)
            return self._make_slice(units)

    def acquire_units(
        self, units: Sequence[int], timeout: Optional[float] = None
    ) -> MeshSlice:
        """Block until the *specific* planned units are all free, then take
        them — the cluster runner uses this to honor the scheduler's device
        groups instead of grabbing whatever is idle."""
        want = tuple(sorted(set(units)))
        for u in want:
            if not 0 <= u < self.total:
                raise ValueError(f"unit {u} outside pool of {self.total}")
        with self._lock:
            if not self._lock.wait_for(
                lambda: all(u in self._free for u in want), timeout=timeout
            ):
                busy = [u for u in want if u not in self._free]
                raise TimeoutError(f"timed out waiting for units {busy}")
            self._free -= set(want)
            return self._make_slice(want)

    # ---------------- leases: acquisition as a context manager ----------------
    #
    # A bare ``acquire`` + ``release`` pair leaks units whenever the code
    # between them dies (an executor crash, a killed worker, an exception in
    # the dispatch loop) — the unit is then gone for the lifetime of the
    # pool and later segments planned on it hang forever. The context
    # managers below make release structurally unskippable, and
    # ``ClusterRunner.run`` asserts the pool drained back to empty at exit.

    @contextmanager
    def lease(self, g: int, timeout: Optional[float] = None):
        """``acquire`` whose release is guaranteed by ``with``-scoping."""
        s = self.acquire(g, timeout=timeout)
        try:
            yield s
        finally:
            self.release(s)

    @contextmanager
    def lease_units(self, units: Sequence[int], timeout: Optional[float] = None):
        """``acquire_units`` whose release is guaranteed by ``with``-scoping."""
        s = self.acquire_units(units, timeout=timeout)
        try:
            yield s
        finally:
            self.release(s)

    @contextmanager
    def held(self, s: MeshSlice):
        """Adopt an *already acquired* slice: release it when the block
        exits, crash or no crash. Used when acquisition must happen in one
        thread (the dispatch loop, to preserve dispatch order) while the
        work — and therefore the crash risk — lives in another."""
        try:
            yield s
        finally:
            self.release(s)

    def release(self, s: MeshSlice) -> None:
        with self._lock:
            dup = set(s.units) & self._free
            if dup:
                raise RuntimeError(f"double release of units {sorted(dup)}")
            bad = [u for u in s.units if not 0 <= u < self.total]
            if bad:
                raise RuntimeError(f"release of foreign units {bad}")
            self._free |= set(s.units)
            self._lock.notify_all()

    def map_units(self, units: Sequence[int]) -> Tuple[int, ...]:
        """Fold the scheduler's abstract unit ids onto this pool's units.

        When the virtual pool is wider than the host (the degenerate case —
        e.g. an 8-unit plan executed on a 1-device laptop), planned units
        wrap modulo the pool size; colliding segments then serialize on the
        shared device instead of failing."""
        return tuple(sorted({u % self.total for u in units}))


def pick_host_units(
    free: Sequence[int], degree: int, host_size: Optional[int]
) -> Optional[Tuple[int, ...]]:
    """Pick ``degree`` units from ``free`` (sorted unit ids) such that they
    all live on one host (``unit // host_size``): a packed job's mesh slice
    can never span hosts. ``host_size=None`` is the single-host case —
    lowest-numbered free units, exactly the pre-multihost behavior. With
    hosts, best-fit: the feasible host with the fewest free units (ties to
    the lowest host id), so wide jobs keep finding whole hosts. Returns None
    when no single host currently has ``degree`` free units — callers hold
    the job and retry at the next device-free event."""
    if len(free) < degree:
        return None
    if host_size is None:
        return tuple(free[:degree])
    by_host: Dict[int, List[int]] = {}
    for u in free:
        by_host.setdefault(u // host_size, []).append(u)
    fitting = [(len(us), h) for h, us in by_host.items() if len(us) >= degree]
    if not fitting:
        return None
    _, h = min(fitting)
    return tuple(sorted(by_host[h])[:degree])


def pick_class_units(
    free: Sequence[int],
    degree: int,
    host_size: int,
    *,
    class_of_host: Callable[[int], str],
    ratio_of_class: Callable[[str], float],
    avoid_host: Optional[Callable[[int], bool]] = None,
) -> Optional[Tuple[int, ...]]:
    """Class-aware variant of :func:`pick_host_units` for heterogeneous
    fleets: hosts carry a class tag and ``ratio_of_class`` prices each class
    (measured slowdown vs the prior; 1.0 = unknown/baseline, larger =
    slower). Placement policy:

      * *wide* jobs (``degree == host_size``, occupying a whole host) go to
        the **fastest** feasible class — they dominate the makespan tail;
      * *narrow* jobs go to the **slowest** feasible class — they keep slow
        hosts busy with work whose serial fraction is small, leaving fast
        hosts whole for wide jobs (straggler-aware placement);
      * within a class, best-fit (fewest free units) then lowest host id —
        the same fragmentation-avoidance as the homogeneous picker;
      * hosts flagged by ``avoid_host`` (e.g. heartbeat-SUSPECT) are used
        only when no healthy host fits.

    Returns None when no single host has ``degree`` free units."""
    if len(free) < degree:
        return None
    by_host: Dict[int, List[int]] = {}
    for u in free:
        by_host.setdefault(u // host_size, []).append(u)
    fitting = [h for h, us in by_host.items() if len(us) >= degree]
    if not fitting:
        return None
    wide = degree >= host_size

    def rank(h: int):
        r = float(ratio_of_class(class_of_host(h)))
        suspect = bool(avoid_host(h)) if avoid_host is not None else False
        return (suspect, r if wide else -r, len(by_host[h]), h)

    h = min(fitting, key=rank)
    return tuple(sorted(by_host[h])[:degree])


def assign_units(
    intervals: Sequence[Tuple[float, float, int]],
    g: int,
    host_size: Optional[int] = None,
) -> List[Tuple[int, ...]]:
    """Static unit assignment: replay ``(start, end, degree)`` intervals
    through a ``g``-unit allocator (releases before acquires at equal
    timestamps, lowest-numbered free units first) and return each interval's
    unit tuple. Deterministic; raises if the intervals oversubscribe ``g`` —
    the same feasibility contract as ``OnlineSchedule.validate``. With
    ``host_size`` the allocator additionally keeps every interval's units on
    a single host (see :func:`pick_host_units`) and raises if a planned
    interval cannot be placed host-disjointly."""
    events = []  # (time, kind, idx)  kind 0=release first, 1=acquire
    for i, (start, end, degree) in enumerate(intervals):
        events.append((start, 1, i))
        events.append((end, 0, i))
    free = set(range(g))
    held: Dict[int, Tuple[int, ...]] = {}
    out: List[Optional[Tuple[int, ...]]] = [None] * len(intervals)
    if host_size is None:
        order = sorted(events, key=lambda e: (e[0], e[1]))
    else:
        # at equal (time, kind), place wider intervals first: power-of-2
        # degrees then pack hosts without fragmentation (first-fit-
        # decreasing). Only with hosts — the single-host allocator keeps
        # its historical interval order, byte-for-byte.
        order = sorted(
            events, key=lambda e: (e[0], e[1], -intervals[e[2]][2], e[2])
        )
    for t, kind, i in order:
        if kind == 0:
            free |= set(held.pop(i, ()))
        else:
            degree = intervals[i][2]
            if len(free) < degree:
                raise RuntimeError(
                    f"intervals oversubscribe {g} units at t={t:.2f}"
                )
            units = pick_host_units(sorted(free), degree, host_size)
            if units is None:
                raise RuntimeError(
                    f"no single host of {host_size} units can hold a "
                    f"degree-{degree} interval at t={t:.2f} "
                    f"({len(free)}/{g} units free but fragmented)"
                )
            free -= set(units)
            held[i] = units
            out[i] = units
    return out  # type: ignore[return-value]
