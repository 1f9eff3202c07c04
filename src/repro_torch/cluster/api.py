"""The runner contract: what it means to execute planned segments (the port
of ``repro/cluster/api.py``).

Everything that drives runners (``ExecutionEngine``, launch scripts) types
against :class:`Runner`; :class:`~repro_torch.cluster.runner.ClusterRunner`
(thread-per-slice, one host) is the port's implementation so far. The
protocol is ``runtime_checkable``, so ``isinstance(x, Runner)`` checks the
surface (methods and attributes exist); the tests exercise the semantics.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Protocol, Sequence, runtime_checkable


@runtime_checkable
class Runner(Protocol):
    """Executes planned :class:`~repro_torch.sched.engine.JobSegment`s.

    ``executor``
        The segment executor (``SliceExecutor``-shaped: ``run_segment`` +
        ``pack_template``).
    ``device_pool``
        The :class:`~repro_torch.cluster.pool.DevicePool` backing execution.
    ``concurrent``
        Whether segments on disjoint slices overlap in wall time
        (thread-per-slice) or run serially.
    ``run(...)``
        Execute a batch of segments and return a
        :class:`~repro_torch.cluster.runner.ClusterResult`. Contract:
        segments dispatch in virtual ``(start, job_id)`` order; a segment
        blocks on its resume dependencies and then on its planned units; the
        pool drains back to its entry free count at exit;
        ``estimator.observe`` is fed measured step times; ``impl``/``remat``
        select the kernel policy for every segment (``None`` = the caller's
        context default, captured at dispatch).
    """

    executor: Any
    device_pool: Any
    concurrent: bool

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
        estimator=None,
        impl: Optional[str] = None,
        remat: Optional[str] = None,
    ):
        ...
