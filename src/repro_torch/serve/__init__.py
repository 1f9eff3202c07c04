from repro_torch.serve.decode import generate, make_prefill, make_serve_step, pad_caches
from repro_torch.serve.engine import (
    AdapterSlotCache,
    ServeEngine,
    ServeExecutor,
    ServeRequest,
    ServeResult,
    ServeStats,
    poisson_requests,
    write_row_caches,
)

__all__ = [
    "generate",
    "make_prefill",
    "make_serve_step",
    "pad_caches",
    "AdapterSlotCache",
    "ServeEngine",
    "ServeExecutor",
    "ServeRequest",
    "ServeResult",
    "ServeStats",
    "poisson_requests",
    "write_row_caches",
]
