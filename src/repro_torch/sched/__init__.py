"""Planning: the cost model, the knapsack/DTM packer, the job planner, the
profiled estimator and the execution engine, static, online and adaptive
(the port of ``repro/sched``)."""
from repro_torch.sched.cost_model import (
    A10_24G,
    A100_40G,
    H100,
    PRESETS,
    REFERENCE_MEMORY,
    TPU_V5E,
    CostEstimator,
    CostModel,
    HardwareSpec,
)
from repro_torch.sched.dtm import DTMResult, JobPlan, dtm
from repro_torch.sched.engine import (
    MIGRATION_MARGIN,
    Arrival,
    ExecutionEngine,
    JobRecord,
    JobSegment,
    OnlineSchedule,
    ResourceMonitor,
    poisson_trace,
    replay_measured,
)
from repro_torch.sched.knapsack import brute_force, solve_pack
from repro_torch.sched.planner import (
    Schedule,
    ScheduledJob,
    max_gpu_schedule,
    min_gpu_schedule,
    plan,
    replan,
    sequential_plora_schedule,
)
from repro_torch.sched.profile import ObservationStore, ProfiledCostModel, obs_key

__all__ = [
    "A10_24G", "A100_40G", "H100", "PRESETS", "REFERENCE_MEMORY", "TPU_V5E", "CostEstimator", "CostModel",
    "HardwareSpec", "DTMResult", "JobPlan", "dtm", "MIGRATION_MARGIN", "Arrival",
    "ExecutionEngine", "JobRecord", "JobSegment", "OnlineSchedule", "ResourceMonitor",
    "poisson_trace", "replay_measured", "brute_force", "solve_pack", "Schedule", "ScheduledJob",
    "max_gpu_schedule", "min_gpu_schedule", "plan", "replan", "sequential_plora_schedule",
    "ObservationStore", "ProfiledCostModel", "obs_key",
]
