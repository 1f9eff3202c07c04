"""Slice execution of planned segments (the port of ``repro/cluster``):
``DevicePool`` partitions the host's devices into disjoint slices,
``SliceExecutor`` caches one packed train step per step shape (a CUDA
graph on a CUDA slice) and ``ClusterRunner`` drives planned segments onto
slices, one thread per slice. The multi-host tier is not ported yet."""
from repro_torch.cluster.api import Runner
from repro_torch.cluster.executor import NO_BUDGET, PackResult, SliceExecutor
from repro_torch.cluster.pool import (
    DevicePool,
    MeshSlice,
    assign_units,
    pick_class_units,
    pick_host_units,
)
from repro_torch.cluster.runner import (
    ClusterResult,
    ClusterRunner,
    SegmentTiming,
    peak_overlap,
    resume_deps,
)

__all__ = [
    "Runner", "NO_BUDGET", "PackResult", "SliceExecutor", "DevicePool", "MeshSlice",
    "assign_units", "pick_class_units", "pick_host_units", "ClusterResult", "ClusterRunner",
    "SegmentTiming", "peak_overlap", "resume_deps",
]
