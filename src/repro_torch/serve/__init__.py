"""repro_torch.serve — continuous-batching serving over a paged KV cache
(counterpart of ``repro.serve``).

- ``kv_cache``  paged KV cache: fixed-size pages, per-request page
                tables, refcounted alloc/share/release, swap-to-host
                preemption.
- ``prefix``    content-hashed shared-KV prefix cache: chain hashes of
                page-aligned prompt chunks, COW forks, LRU eviction of
                refcount-0 cached pages.
- ``scheduler`` continuous batching: ``fifo`` and SLA-aware (priority +
                TTFT deadline, with preemption) admission.
- ``engine``    the model-coupled serving loop with decode supersteps.
- ``dispatch``  redundancy-aware replica dispatch: first-(n-r) replies,
                Byzantine replicas, per-position majority vote.
- ``fleet``     fleet health and recovery: phi-accrual failure
                detection, a per-replica health state machine,
                deadline-hedged dispatch with elastic quorum degrade to
                the vote floor, checkpoint rejoin with probation.
- ``realtime``  the fleet control plane on real threads and timers
                behind the Clock seam (``RealClock``; ``FakeClock`` for
                deterministic threaded tests).
"""
from repro_torch.serve.kv_cache import (PageAllocator, PagedCacheConfig,
                                        PagedKVCache, SwapState,
                                        pages_needed)
from repro_torch.serve.prefix import PrefixIndex, PrefixPlan, chunk_hashes
from repro_torch.serve.scheduler import Request, RequestState, Scheduler
from repro_torch.serve.engine import ServeEngine, SnapshotInFlightError
from repro_torch.serve.dispatch import (DispatchConfig, DispatchResult,
                                        NoQuorumError, RedundantDispatcher)
from repro_torch.serve.fleet import (FleetConfig, FleetController,
                                     HedgedDispatcher, PhiAccrualDetector,
                                     jitter_stream, next_frontend_instance,
                                     vote_floor)
from repro_torch.serve.realtime import (Clock, EngineReplica, FakeClock,
                                        RealClock, RealtimeFleet,
                                        ReplicaKilled, StubReplica, Ticket)

__all__ = [
    "PageAllocator", "PagedCacheConfig", "PagedKVCache", "SwapState",
    "pages_needed", "PrefixIndex", "PrefixPlan", "chunk_hashes",
    "Request", "RequestState", "Scheduler", "ServeEngine",
    "SnapshotInFlightError", "DispatchConfig", "DispatchResult",
    "NoQuorumError", "RedundantDispatcher", "FleetConfig",
    "FleetController", "HedgedDispatcher", "PhiAccrualDetector",
    "jitter_stream", "next_frontend_instance", "vote_floor",
    "Clock", "EngineReplica", "FakeClock", "RealClock", "RealtimeFleet",
    "ReplicaKilled", "StubReplica", "Ticket",
]
