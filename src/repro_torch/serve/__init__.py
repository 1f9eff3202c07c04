from repro_torch.serve.decode import (
    align_prefill_chunk,
    generate,
    make_prefill,
    make_serve_step,
    pad_caches,
    prefill_chunked,
)
from repro_torch.serve.engine import (
    AdapterSlotCache,
    ServeEngine,
    ServeExecutor,
    ServeRequest,
    ServeResult,
    ServeStats,
    draw_seed,
    poisson_requests,
    sample_tokens,
    write_row_caches,
)

__all__ = [
    "align_prefill_chunk",
    "generate",
    "make_prefill",
    "make_serve_step",
    "pad_caches",
    "prefill_chunked",
    "AdapterSlotCache",
    "ServeEngine",
    "ServeExecutor",
    "ServeRequest",
    "ServeResult",
    "ServeStats",
    "draw_seed",
    "poisson_requests",
    "sample_tokens",
    "write_row_caches",
]
