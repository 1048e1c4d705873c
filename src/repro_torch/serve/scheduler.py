"""Continuous-batching scheduler (DESIGN.md §9, §13).

Requests flow waiting → active(slot) → finished. Admission is gated on
two resources: a free *slot* (row of the fixed decode batch) and enough
free *pages* for the request's whole lifetime
(ceil((prompt + max_new) / page_size) — conservative reservation, so a
running request can never stall mid-decode on an empty pool). Slots are
reused across requests of different lengths: retiring a 10-token request
frees its slot for a 500-token one and vice versa.

Two admission policies sit behind one seam (DESIGN.md §13):

- ``fifo`` (default, the conformance reference): strict arrival order
  with deliberate head-of-line blocking — no starvation of big requests,
  and byte-identical behavior to the pre-policy scheduler.
- ``sla``: requests carry a priority class and an optional TTFT deadline;
  admission picks the best-scored waiting request first (score =
  priority desc, then deadline slack asc, then arrival), skips over ones
  that don't fit right now, and the engine may *preempt* a running
  victim (swap its KV to host) when a strictly higher-priority request
  is starving in the queue. Preemption requires strict priority
  dominance, so two requests can never thrash swapping each other.

Over-long requests (page need exceeds the table width) are recorded in
``rejected`` with a reason instead of raising — a mid-stream submit must
never kill the serving loop; dispatch/sim log the rejection and continue.

The scheduler is pure bookkeeping — it never touches the model or device
memory. The engine asks it *what* to admit/retire/preempt and performs
the prefill/eviction/swap against the paged cache.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import spans
from repro_torch.serve.kv_cache import PagedCacheConfig, SwapState, pages_needed

POLICIES = ("fifo", "sla")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (s0,) int32 token ids
    max_new_tokens: int
    priority: int = 0                   # higher = more important (sla)
    deadline: Optional[float] = None    # TTFT deadline, scheduler-clock
                                        # units from arrival (sla)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens


@dataclasses.dataclass
class RequestState:
    req: Request
    slot: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    pending: Optional[int] = None       # produced but not yet in the cache
    arrival: float = 0.0                # scheduler clock at submit
    t_submit_ns: int = 0                # span clock (spans.now_ns) at submit
    ttft: Optional[float] = None        # seconds submit -> 1st token, on
                                        # the same clock
    swap: Optional[SwapState] = None    # host KV image while preempted
    preemptions: int = 0

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.req.max_new_tokens


class Scheduler:
    def __init__(self, ccfg: PagedCacheConfig, policy: str = "fifo"):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}, want {POLICIES}")
        self.ccfg = ccfg
        self.policy = policy
        self.waiting: Deque[RequestState] = deque()
        self.active: Dict[int, RequestState] = {}       # slot -> state
        self.finished: Dict[int, RequestState] = {}     # rid -> state
        self.aborted: Dict[int, RequestState] = {}      # rid -> state
        self.rejected: List[Tuple[Request, str]] = []
        self._free_slots: List[int] = list(range(ccfg.num_slots - 1, -1, -1))
        self.clock = 0.0                # advanced by the engine, 1 per step
        # occupancy telemetry for the slot-pressure tests
        self.peak_active = 0
        self.total_admitted = 0
        self.total_preempted = 0

    # -- queue ops --------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Enqueue; returns False (and records the reason in ``rejected``)
        for a request that could never be admitted — raising here would
        kill the whole serving loop over one bad request."""
        need = pages_needed(req.total_len, self.ccfg.page_size)
        if need > self.ccfg.max_pages_per_seq:
            self.rejected.append((req, (
                f"{req.total_len} tokens need {need} pages > table width "
                f"{self.ccfg.max_pages_per_seq}")))
            return False
        if need > self.ccfg.num_pages - 1:
            self.rejected.append((req, (
                f"{req.total_len} tokens need {need} pages > pool of "
                f"{self.ccfg.num_pages - 1}")))
            return False
        self.waiting.append(RequestState(req=req, arrival=self.clock,
                                         t_submit_ns=spans.now_ns()))
        return True

    def _score(self, st: RequestState):
        """SLA order: priority class first (higher wins), then least
        deadline slack (clock units left before the TTFT deadline — may
        be negative when already blown), then arrival, then rid."""
        req = st.req
        slack = (req.deadline - (self.clock - st.arrival)
                 if req.deadline is not None else float("inf"))
        return (-req.priority, slack, st.arrival, req.rid)

    def admissions(self, free_pages: int,
                   need_pages: Optional[Callable[[RequestState], int]] = None,
                   ) -> List[RequestState]:
        """Claim slots for admissible waiting requests, policy-ordered.

        ``need_pages`` lets the engine refine the page bill (a prefix-
        cache hit only needs its uncached pages); default is the full
        conservative reservation. fifo keeps head-of-line blocking; sla
        skips requests that don't fit *right now* so a small urgent
        request isn't stuck behind a big one (the preemption layer
        rescues the skipped ones).
        """
        if need_pages is None:
            need_pages = lambda st: pages_needed(st.req.total_len,
                                                 self.ccfg.page_size)
        out: List[RequestState] = []
        budget = free_pages
        if self.policy == "fifo":
            while self.waiting and self._free_slots:
                need = need_pages(self.waiting[0])
                if need > budget:
                    break
                st = self.waiting.popleft()
                self._activate(st)
                budget -= need
                out.append(st)
        else:
            for st in sorted(self.waiting, key=self._score):
                if not self._free_slots:
                    break
                need = need_pages(st)
                if need > budget:
                    continue
                self.waiting.remove(st)
                self._activate(st)
                budget -= need
                out.append(st)
        self.peak_active = max(self.peak_active, len(self.active))
        return out

    def _activate(self, st: RequestState) -> None:
        st.slot = self._free_slots.pop()
        self.active[st.slot] = st
        self.total_admitted += 1

    def requeue(self, st: RequestState) -> None:
        """Undo an admission the engine could not honor (page plan went
        stale between gate and allocation): slot back to the pool, state
        back to the queue front."""
        del self.active[st.slot]
        self._free_slots.append(st.slot)
        st.slot = -1
        self.waiting.appendleft(st)
        self.total_admitted -= 1

    # -- preemption (sla) -------------------------------------------------
    def preemption_victim(self) -> Optional[int]:
        """Slot to preempt so the best waiting request can run, or None.

        Only under ``sla``, and only for *strict* priority dominance:
        the best-scored waiting request must outrank the worst-scored
        active one. Equal priorities never preempt (no deadline-driven
        thrash: a preempted request's slack only shrinks, so it would
        immediately fight back).
        """
        if self.policy != "sla" or not self.waiting or not self.active:
            return None
        cand = min(self.waiting, key=self._score)
        victim_slot = max(self.active, key=lambda s: self._score(self.active[s]))
        if cand.req.priority > self.active[victim_slot].req.priority:
            return victim_slot
        return None

    def preempt(self, slot: int) -> RequestState:
        """Move an active request back to the queue (engine has already
        swapped its KV out; ``st.swap`` carries the host image)."""
        st = self.active.pop(slot)
        self._free_slots.append(slot)
        st.slot = -1
        st.preemptions += 1
        self.total_preempted += 1
        self.waiting.appendleft(st)
        return st

    # -- fault surface (DESIGN.md §15) ------------------------------------
    def abort(self, slot: int) -> RequestState:
        """Kill an active request without completing it: the slot returns
        to the pool and the state lands in ``aborted`` (never
        ``finished``) with its partial ``generated`` stream intact for
        post-mortems. The replica-crash primitive of the e2e harness —
        in-flight tokens are *lost*, not answered."""
        st = self.active.pop(slot)
        self._free_slots.append(slot)
        st.slot = -1
        self.aborted[st.req.rid] = st
        return st

    def drop_waiting(self) -> List[RequestState]:
        """Discard the whole waiting queue (a crashed replica loses its
        queue along with its in-flight work); returns the dropped states,
        also recorded in ``aborted``."""
        dropped = list(self.waiting)
        self.waiting.clear()
        for st in dropped:
            self.aborted[st.req.rid] = st
        return dropped

    # -- decode bookkeeping ----------------------------------------------
    def superstep_k(self, cap: int) -> int:
        """Budget-bounded superstep length: the largest K <= cap such
        that no active slot can overrun its token budget inside a K-long
        device-resident decode scan (budgets are known at admission, so
        the bound is exact — no speculative over-generation, and the
        min-budget slot finishes exactly at the superstep boundary where
        the host can retire it and admit a successor)."""
        if cap < 1:
            raise ValueError(f"need superstep cap >= 1, got {cap}")
        rem = [st.req.max_new_tokens - len(st.generated)
               for st in self.active.values()]
        rem = [r for r in rem if r > 0]
        if not rem:
            return 0                 # nothing to decode this superstep
        return min(cap, min(rem))

    def retire(self, slot: int) -> RequestState:
        st = self.active.pop(slot)
        self._free_slots.append(slot)
        self.finished[st.req.rid] = st
        return st

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.active
