"""Slice execution of planned segments (the port of ``repro/cluster``):
``DevicePool`` partitions the host's devices into disjoint slices,
``SliceExecutor`` caches one packed train step per step shape (a CUDA
graph on a CUDA slice) and ``ClusterRunner`` drives planned segments onto
slices, one thread per slice. ``HostDispatcher`` (``multihost.py``) runs the
same segment protocol process-per-host: one spawned worker per simulated
host, each on its own card or sharing one, with the wire protocol, worker
recovery, heartbeats and elastic join / drain; ``testing.py`` holds its
in-memory fakes."""
from repro_torch.cluster.api import Runner
from repro_torch.cluster.executor import NO_BUDGET, PackResult, SliceExecutor
from repro_torch.cluster.multihost import (
    HOST_ALIVE,
    HOST_DEAD,
    HOST_DRAINING,
    HOST_SUSPECT,
    CheckpointWrite,
    DispatchExecutor,
    HealthReply,
    HeartbeatMsg,
    HostDispatcher,
    HostUnit,
    HostWorker,
    KernelPolicy,
    MemoryPool,
    RecordMsg,
    RemoteSegmentError,
    SegmentMsg,
    TraceCtx,
    TransportError,
    WorkerDied,
)
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
    "assign_units", "pick_class_units", "pick_host_units", "HOST_ALIVE", "HOST_DEAD",
    "HOST_DRAINING", "HOST_SUSPECT", "HeartbeatMsg", "HealthReply", "ClusterResult",
    "ClusterRunner", "SegmentTiming", "peak_overlap", "resume_deps", "CheckpointWrite",
    "KernelPolicy", "RecordMsg", "SegmentMsg", "TraceCtx", "DispatchExecutor", "HostDispatcher",
    "HostUnit", "HostWorker", "MemoryPool", "RemoteSegmentError", "TransportError", "WorkerDied",
]
