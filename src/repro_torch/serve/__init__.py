"""repro_torch.serve — continuous-batching serving over a paged KV cache.

- ``kv_cache``  paged KV cache: fixed-size pages, per-request page
                tables, refcounted alloc/free, swap-to-host preemption.
- ``scheduler`` continuous batching: ``fifo`` and SLA-aware (priority +
                TTFT deadline, with preemption) admission.
- ``engine``    the model-coupled serving loop with decode supersteps.

The prefix cache, replica dispatch, fleet and wall-clock layers of
``repro.serve`` come with later slices (ROADMAP Queue 1 items 7 and 8).
"""
from repro_torch.serve.kv_cache import (PageAllocator, PagedCacheConfig,
                                        PagedKVCache, SwapState,
                                        pages_needed)
from repro_torch.serve.scheduler import Request, RequestState, Scheduler
from repro_torch.serve.engine import ServeEngine, SnapshotInFlightError

__all__ = [
    "PageAllocator", "PagedCacheConfig", "PagedKVCache", "SwapState",
    "pages_needed", "Request", "RequestState", "Scheduler", "ServeEngine",
    "SnapshotInFlightError",
]
