"""Content-hashed shared-KV prefix cache (counterpart of
``repro.serve.prefix``, DESIGN.md §13; numpy and ``hashlib``, copied so
hash strings, plans and eviction order are the reference's).

Millions of users share system prompts and few-shot preambles: the
request stream itself carries redundancy, and exploiting it is the
serving twin of the paper's redundancy-in-cost-functions insight — don't
recompute work another request already paid for, the same way Algorithm 1
doesn't wait on gradients the quorum already covers.

The index maps *content* to *physical pages*:

- The prompt is cut into page-aligned chunks and chain-hashed
  (``h_i = sha256(h_{i-1} || tokens_i)``), so a chunk hash commits to the
  entire token prefix before it — two requests map to the same page iff
  their token streams agree up to and including that chunk. Full
  ``page_size`` chunks are the unit of sharing; the ragged tail chunk is
  hashed too (domain-separated) so *identical* prompts share their last
  partial page as well.
- An admitted request walks its chunk hashes through the index: the
  longest indexed prefix is served by *sharing* the already-resident
  pages (refcount bump, zero prefill work) and only the uncached suffix
  is prefilled. After prefill, the request's own blocks are registered
  (first writer wins) so the next request can hit them.
- Pages are refcounted in :class:`~repro_torch.serve.kv_cache.PageAllocator`.
  When the last holder releases an *indexed* page it parks in an LRU of
  resident-but-unreferenced pages instead of being freed: its KV stays
  warm for future hits, and pool pressure reclaims LRU-oldest first
  (``reclaim``). Unindexed pages free immediately, exactly as before.
- Copy-on-write: sharing is only sound while nobody writes. Decode
  appends at ``kv_len``, and the admission plan keeps every logical page
  at index ``>= cached_len // page_size`` private — with one deliberate
  exception: on a *full-prompt* hit the engine re-feeds the final prompt
  token through the decode path to recover the first output token, which
  writes at position ``prompt_len - 1`` inside the last shared page. The
  plan marks that page ``cow`` and admission forks it (copy all layers'
  pools to a fresh page, swap the table entry, drop the share) before
  any write happens, so no holder ever observes another's mutation.

``prefix_cache="off"`` (the default) never constructs this index and the
engine routes the original admission path verbatim — the conformance
reference, same contract as ``agg_backend="host"`` and ``superstep_k=1``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.kv_cache import PageAllocator, pages_needed


def chunk_hashes(prompt, page_size: int) -> Tuple[List[str], Optional[str]]:
    """Chain hashes of the prompt's page-aligned chunks.

    Returns ``(full, tail)``: one hash per complete ``page_size`` chunk,
    plus the (domain-separated) hash of the ragged tail chunk or ``None``
    if the prompt length is a page multiple. Each hash commits to every
    token before it, so equal hashes imply equal token prefixes (modulo
    sha256 collisions).
    """
    toks = np.ascontiguousarray(np.asarray(prompt, np.int32))
    n_full = toks.size // page_size
    full: List[str] = []
    h = "root"
    for i in range(n_full):
        m = hashlib.sha256()
        m.update(h.encode())
        m.update(toks[i * page_size:(i + 1) * page_size].tobytes())
        h = m.hexdigest()
        full.append(h)
    tail = None
    if toks.size % page_size:
        m = hashlib.sha256()
        m.update(h.encode())
        m.update(b"tail")                      # partial chunk, own domain
        m.update(toks[n_full * page_size:].tobytes())
        tail = m.hexdigest()
    return full, tail


@dataclasses.dataclass(frozen=True)
class PrefixPlan:
    """Admission plan for one prompt against the current index.

    - ``cached_len``: prompt tokens served from resident pages. Capped at
      ``prompt_len - 1`` on a full hit so the engine always has at least
      one token to feed through the decode path (its logits supply the
      first generated token, exactly like cold prefill's last position).
    - ``shared``: physical pages to share, in logical order. On a full
      hit the last entry is the page containing position
      ``prompt_len - 1`` and ``cow`` is set: admission must fork it
      before the re-feed writes into it.
    - ``need_pages``: private pages admission must allocate (the COW copy
      included) — the scheduler gates on this instead of the full
      ``pages_needed(total_len)``.
    """
    cached_len: int
    shared: Tuple[int, ...] = ()
    cow: bool = False
    need_pages: int = 0


class PrefixIndex:
    """hash -> resident physical page, plus the LRU of unreferenced ones.

    Owns no device memory — pages live in :class:`PagedKVCache` pools and
    the allocator tracks refcounts; this class only decides *which* page
    backs *which* content and when a cold page is reclaimed.
    """

    def __init__(self, alloc: PageAllocator, page_size: int):
        self.alloc = alloc
        self.page_size = page_size
        self._page_of: Dict[str, int] = {}       # chunk hash -> phys page
        self._hash_of: Dict[int, str] = {}       # phys page  -> chunk hash
        # ref-0 indexed pages, oldest release first (reclaim order)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.hits = 0                            # shared-page acquisitions
        self.registered = 0
        self.evictions = 0

    # -- introspection ---------------------------------------------------
    @property
    def n_indexed(self) -> int:
        return len(self._page_of)

    @property
    def reclaimable(self) -> int:
        """Ref-0 resident pages the pool can take back under pressure."""
        return len(self._lru)

    def lookup(self, h: str) -> Optional[int]:
        return self._page_of.get(h)

    def headroom(self, pinned: Sequence[int] = ()) -> int:
        """Allocatable pages if everything reclaimable except ``pinned``
        were evicted — the admission-feasibility bound."""
        pinned_lru = sum(1 for p in pinned if p in self._lru)
        return self.alloc.n_free + len(self._lru) - pinned_lru

    # -- planning / sharing ----------------------------------------------
    def plan(self, prompt, total_len: int) -> PrefixPlan:
        """Longest-indexed-prefix match of ``prompt``; pure (no refs)."""
        ps = self.page_size
        prompt = np.asarray(prompt, np.int32)
        total_pages = pages_needed(total_len, ps)
        full, tail = chunk_hashes(prompt, ps)
        shared: List[int] = []
        for h in full:
            p = self._page_of.get(h)
            if p is None:
                break
            shared.append(p)
        cow = False
        cached_len = len(shared) * ps
        if len(shared) == len(full):             # every full block resident
            if tail is not None and tail in self._page_of:
                shared.append(self._page_of[tail])
                cow = True
                cached_len = int(prompt.size) - 1
            elif tail is None and shared:
                # prompt is exactly N full blocks, all resident: the
                # re-feed of the last token writes into the final block
                cow = True
                cached_len = int(prompt.size) - 1
        if cached_len <= 0:
            return PrefixPlan(0, (), False, total_pages)
        return PrefixPlan(cached_len, tuple(shared), cow,
                          total_pages - len(shared) + (1 if cow else 0))

    def acquire(self, shared: Sequence[int]) -> None:
        """Pin the plan's shared pages: +1 ref each; ref-0 pages leave the
        LRU (they are live again and must not be reclaimed)."""
        for p in shared:
            if self.alloc.refcount(p) == 0:
                self._lru.pop(p)
            self.alloc.share([p])
        self.hits += len(shared)

    def register(self, prompt, pages: Sequence[int]) -> int:
        """Index a request's resident prompt blocks (full chunks + ragged
        tail), hash -> ``pages[i]``. First writer wins: hashes already
        indexed (a shared block, or a COW copy of one) are skipped, as is
        any page already backing different content. Returns new entries.
        """
        full, tail = chunk_hashes(prompt, self.page_size)
        chunks = full + ([tail] if tail is not None else [])
        new = 0
        for i, h in enumerate(chunks):
            if h in self._page_of:
                continue
            p = pages[i]
            if p in self._hash_of:
                continue
            self._page_of[h] = p
            self._hash_of[p] = h
            new += 1
        self.registered += new
        return new

    # -- release / reclaim ------------------------------------------------
    def release(self, pages: Sequence[int]) -> List[int]:
        """Drop one ref per page. Pages reaching ref 0 park in the LRU if
        indexed (content stays warm) and free immediately otherwise.
        Returns the pages actually freed."""
        freed: List[int] = []
        for p in pages:
            if self.alloc.release([p]):          # reached refcount 0
                if p in self._hash_of:
                    self._lru[p] = None          # newest at the end
                else:
                    self.alloc.free([p])
                    freed.append(p)
        return freed

    def reclaim(self, n: int) -> int:
        """Evict up to ``n`` ref-0 cached pages, oldest release first;
        never touches a referenced page. Returns pages reclaimed."""
        got = 0
        while got < n and self._lru:
            p, _ = self._lru.popitem(last=False)
            h = self._hash_of.pop(p)
            del self._page_of[h]
            self.alloc.free([p])
            self.evictions += 1
            got += 1
        return got

    def clear(self) -> None:
        """Drop the whole index: reclaim every parked page and unindex
        pages still referenced by live holders (they keep their refs and
        free through the normal release path). Benchmark/test reset."""
        self.reclaim(len(self._lru))
        for p, h in list(self._hash_of.items()):
            del self._hash_of[p]
            del self._page_of[h]

    # -- invariants --------------------------------------------------------
    def check_invariants(self) -> bool:
        assert len(self._page_of) == len(self._hash_of), "index not 1:1"
        assert set(self._hash_of) == set(self._page_of.values())
        for p in self._lru:
            assert p in self._hash_of, "LRU page not indexed"
            assert self.alloc.refcount(p) == 0, "referenced page in LRU"
        for p in self._hash_of:
            assert p in self.alloc._used, "indexed page not resident"
            if self.alloc.refcount(p) == 0:
                assert p in self._lru, "ref-0 indexed page unreclaimable"
        self.alloc.check_invariants()
        return True
