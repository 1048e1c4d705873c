"""Paged KV cache for serving (counterpart of ``repro.serve.kv_cache``).

KV lives in fixed-size physical pages and every admitted request gets a
page table, so memory scales with the tokens actually resident. Layout
per pattern position, the reference's (so ``ServeEngine.snapshot()``
images carry its keys and shapes): ``{"mixer": {"k_pages", "v_pages"}:
(n_periods, N, PS, n_kv, hd), "ffn": {}}``.

Physical page 0 is the *null page*: idle slots' page tables point at it,
so their masked decode writes land somewhere harmless. The allocator
hands out pages 1..N-1. Logical page p of the sequence in slot s lives in
physical page ``page_table[s, p]``, shared by every layer.

The pools are device tensors written in place (admission scatters,
decode appends): ``update`` only rebinds the tree. Only dense decoders
are paged here; the prefix cache (content-hashed shared pages, COW
forks) comes with ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve as resolve_device
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import check_supported

PAGED_SUFFIX = "_pages"


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    num_slots: int = 4            # concurrent decode batch size
    page_size: int = 16           # tokens per page
    num_pages: int = 64           # physical pages incl. the null page 0
    max_pages_per_seq: int = 16   # page-table width

    @property
    def max_seq_len(self) -> int:
        return self.page_size * self.max_pages_per_seq


def pages_needed(total_len: int, page_size: int) -> int:
    return -(-total_len // page_size)


class PageAllocator:
    """Free-list allocator over physical pages 1..num_pages-1 (page 0 is
    the reserved null page). A page is never handed out twice, never
    freed twice, never freed while free.

    Pages are refcounted as in the reference: ``alloc`` hands a page out
    at refcount 1, ``share`` adds holders, ``release`` drops one (a page
    at refcount 0 stays used until ``free``, which refuses while other
    holders remain). Without the prefix cache every page lives at
    refcount 1.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least one allocatable page + null")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._used: set = set()
        self._ref: Dict[int, int] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._used)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        self._used.update(pages)
        for p in pages:
            self._ref[p] = 1
        return pages

    def share(self, pages: Sequence[int]) -> None:
        """Add one holder per page (a cached refcount-0 page revives)."""
        for p in pages:
            if p not in self._used:
                raise ValueError(f"cannot share unallocated page {p}")
            self._ref[p] += 1

    def release(self, pages: Sequence[int]) -> List[int]:
        """Drop one holder per page; returns the pages that reached
        refcount 0 (still used: the caller parks or frees them)."""
        zero: List[int] = []
        for p in pages:
            if p not in self._used:
                raise ValueError(f"cannot release unallocated page {p}")
            if self._ref[p] <= 0:
                raise ValueError(f"release of unreferenced page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                zero.append(p)
        return zero

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p not in self._used:
                raise ValueError(f"double free / foreign page {p}")
            if self._ref[p] > 1:
                raise ValueError(
                    f"page {p} still shared (refcount {self._ref[p]})")
            self._used.remove(p)
            del self._ref[p]
            self._free.append(p)

    def check_invariants(self) -> bool:
        """Raise AssertionError if the books disagree; True otherwise."""
        seen = set(self._free)
        checks = [
            (len(seen) == len(self._free), "duplicate free pages"),
            (not (seen & self._used), "page both free and used"),
            (0 not in seen and 0 not in self._used, "null page leaked"),
            (len(seen) + len(self._used) == self.num_pages - 1,
             "pages lost"),
            (set(self._ref) == self._used, "refcounts out of sync"),
            (all(c >= 0 for c in self._ref.values()), "negative refcount"),
        ]
        for ok, what in checks:
            if not ok:
                raise AssertionError(what)
        return True


@dataclasses.dataclass
class SwapState:
    """Host image of a preempted request's pages: per (pattern position,
    paged leaf name), the ``(n_periods, n_pages, PS, ...)`` slice of the
    pool covering its content-bearing logical pages
    (``pages_needed(kv_len)``), as CPU tensors in the pool's dtype. A
    swapped-out request owns no device pages."""
    kv_len: int
    n_pages: int
    leaf_pages: Dict[Any, torch.Tensor]


def _paged_block(cfg: ArchConfig, ccfg: PagedCacheConfig, dt, device):
    shape = (cfg.n_periods, ccfg.num_pages, ccfg.page_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dt, device=device),
            "v_pages": torch.zeros(shape, dtype=dt, device=device)}


class PagedKVCache:
    """Owns the device pools + the host-side allocator and page table.

    The engine passes ``.cache`` / ``.page_table_dev`` / ``.kv_lens_dev``
    to the decode step; admission and eviction update the host books and
    scatter pages on the device.
    """

    def __init__(self, cfg: ArchConfig, ccfg: PagedCacheConfig,
                 enable_prefix: bool = False, device="cuda"):
        if enable_prefix:
            raise NotImplementedError(
                "the prefix cache comes with ROADMAP Queue 1 item 7")
        check_supported(cfg)
        self.cfg = cfg
        self.ccfg = ccfg
        self.device = resolve_device(device)
        self.alloc = PageAllocator(ccfg.num_pages)
        self.swapped_pages = 0
        s = ccfg.num_slots
        self.page_table = np.zeros((s, ccfg.max_pages_per_seq), np.int32)
        self.kv_lens = np.zeros((s,), np.int32)
        self._slot_pages: Dict[int, List[int]] = {}
        # device mirrors of the host tables, refreshed only when an
        # admission or eviction dirties them (decode-only steps advance
        # the lengths on the device instead of re-uploading)
        self._tables_dirty = True
        self._tbl_dev: Optional[torch.Tensor] = None
        self._lens_dev: Optional[torch.Tensor] = None
        self._active_dev: Optional[torch.Tensor] = None
        self.table_uploads = 0
        dt = torch_dtype(cfg.compute_dtype)
        self.cache = tuple({"mixer": _paged_block(cfg, ccfg, dt, self.device),
                            "ffn": {}} for _ in cfg.layer_pattern)

    # -- device views ----------------------------------------------------
    def _refresh_device_tables(self) -> None:
        self._tbl_dev = torch.tensor(self.page_table, device=self.device)
        self._lens_dev = torch.tensor(self.kv_lens, device=self.device)
        active = np.zeros((self.ccfg.num_slots,), np.int32)
        for s in self._slot_pages:
            active[s] = 1
        self._active_dev = torch.tensor(active, device=self.device)
        self._tables_dirty = False
        self.table_uploads += 1

    @property
    def page_table_dev(self) -> torch.Tensor:
        if self._tables_dirty:
            self._refresh_device_tables()
        return self._tbl_dev

    @property
    def kv_lens_dev(self) -> torch.Tensor:
        if self._tables_dirty:
            self._refresh_device_tables()
        return self._lens_dev

    def update(self, new_cache) -> None:
        self.cache = new_cache

    # -- admission / eviction --------------------------------------------
    @property
    def available_pages(self) -> int:
        return self.alloc.n_free

    def _claim_slot(self, slot: int, total_len: int, n_priv: int
                    ) -> List[int]:
        """Allocate the slot's pages and write its table row."""
        ccfg = self.ccfg
        need = pages_needed(total_len, ccfg.page_size)
        if need > ccfg.max_pages_per_seq:
            raise ValueError(
                f"request of {total_len} tokens needs {need} pages > "
                f"table width {ccfg.max_pages_per_seq}")
        if slot in self._slot_pages:
            raise ValueError(f"slot {slot} already occupied")
        pages = self.alloc.alloc(n_priv)
        self._slot_pages[slot] = pages
        row = np.zeros((ccfg.max_pages_per_seq,), np.int32)
        row[:need] = pages
        self.page_table[slot] = row
        self._tables_dirty = True
        return pages

    def admit(self, slot: int, prefill_cache, prompt_len: int,
              total_len: int) -> None:
        """Move one request's prefill cache (batch axis of size 1) into
        slot ``slot``, reserving pages for the whole ``total_len``
        (prompt + max new tokens), so decode never blocks mid-flight."""
        ps = self.ccfg.page_size
        pages = self._claim_slot(slot, total_len,
                                 pages_needed(total_len, ps))
        self.kv_lens[slot] = prompt_len
        n_full = prompt_len // ps
        full_idx = torch.tensor(pages[:n_full], device=self.device)
        for pos, blk in enumerate(self.cache):
            for name, pool in blk["mixer"].items():
                dense = prefill_cache[pos]["mixer"][name[:-len(PAGED_SUFFIX)]]
                # dense: (P, 1, s0, ...). One indexed write covers every
                # complete page; the ragged tail gets its own partial
                # page write. The causal-invisible right pad is never read.
                if n_full:
                    chunk = dense[:, 0, :n_full * ps]
                    pool[:, full_idx] = chunk.reshape(
                        chunk.shape[0], n_full, ps, *chunk.shape[2:]
                    ).to(pool.dtype)
                if prompt_len % ps:
                    pool[:, pages[n_full], :prompt_len % ps] = dense[
                        :, 0, n_full * ps:prompt_len].to(pool.dtype)

    def evict(self, slot: int) -> None:
        """Free the slot's pages and point its table at the null page."""
        pages = self._slot_pages.pop(slot, None)
        if pages is None:
            raise ValueError(f"slot {slot} not occupied")
        self.alloc.free(pages)
        self.page_table[slot] = 0
        self.kv_lens[slot] = 0
        self._tables_dirty = True

    def swap_out(self, slot: int) -> SwapState:
        """Preempt: copy the slot's content-bearing pages to the host, then
        free every device page; its table row points at the null page."""
        pages = self._slot_pages.get(slot)
        if pages is None:
            raise ValueError(f"slot {slot} not occupied")
        kv_len = int(self.kv_lens[slot])
        n_pages = pages_needed(max(kv_len, 1), self.ccfg.page_size)
        idx = torch.tensor(pages[:n_pages], device=self.device)
        leaf_pages = {(pos, name): pool[:, idx].cpu()
                      for pos, blk in enumerate(self.cache)
                      for name, pool in blk["mixer"].items()}
        self.alloc.free(pages)
        del self._slot_pages[slot]
        self.page_table[slot] = 0
        self.kv_lens[slot] = 0
        self._tables_dirty = True
        self.swapped_pages += n_pages
        return SwapState(kv_len, n_pages, leaf_pages)

    def swap_in(self, slot: int, swap: SwapState, prompt,
                total_len: int) -> int:
        """Resume a preempted request into ``slot``: fresh pages for its
        whole reservation, the host image uploaded into the first
        ``swap.n_pages``. Returns the number of re-shared pages (0 without
        the prefix cache). MemoryError leaves no partial state."""
        need = pages_needed(total_len, self.ccfg.page_size)
        if slot in self._slot_pages:
            raise ValueError(f"slot {slot} already occupied")
        if need > self.alloc.n_free:
            raise MemoryError(f"page pool exhausted: want {need}, have "
                              f"{self.alloc.n_free}")
        pages = self._claim_slot(slot, total_len, need)
        self.kv_lens[slot] = swap.kv_len
        up_idx = torch.tensor(pages[:swap.n_pages], device=self.device)
        for pos, blk in enumerate(self.cache):
            for name, pool in blk["mixer"].items():
                pool[:, up_idx] = swap.leaf_pages[(pos, name)].to(
                    self.device, pool.dtype)
        return 0

    def commit_token(self, slots: Sequence[int]) -> None:
        """Account the token the decode step just wrote for each slot. On
        the steady path (no occupancy change since the last refresh) the
        device lengths advance by one add of the occupancy mask."""
        for s in slots:
            self.kv_lens[s] += 1
        if not self._tables_dirty and self._lens_dev is not None:
            if set(slots) == set(self._slot_pages):
                self._lens_dev = self._lens_dev + self._active_dev
            else:
                self._tables_dirty = True

    def commit_tokens(self, slots: Sequence[int], k: int,
                      lens_dev: Optional[torch.Tensor] = None) -> None:
        """Superstep commit: ``k`` tokens landed for each slot. The length
        bumps happened in the device loop; ``lens_dev`` is its final
        carry, adopted as the device mirror when occupancy is unchanged."""
        for s in slots:
            self.kv_lens[s] += k
        if (lens_dev is not None and not self._tables_dirty
                and set(slots) == set(self._slot_pages)):
            self._lens_dev = lens_dev
        else:
            self._tables_dirty = True

    # -- debug / test helpers --------------------------------------------
    def gather_dense(self, slot: int, pos: int, name: str) -> torch.Tensor:
        """Contiguous (P, kv_len, ...) copy of one slot's paged leaf."""
        ps = self.ccfg.page_size
        ln = int(self.kv_lens[slot])
        pool = self.cache[pos]["mixer"][name]
        tbl = self.page_table[slot][:pages_needed(max(ln, 1), ps)]
        out = pool[:, torch.tensor(tbl, device=self.device)]
        return out.reshape(pool.shape[0], -1, *pool.shape[3:])[:, :ln]
