"""Model-coupled serving loop: continuous batching over the paged cache
(counterpart of ``repro.serve.engine``).

Every step the engine (1) admits waiting requests into free slots
(batched prefill per page-padded prompt-length group; the first generated
token comes from the prefill logits), (2) runs a **decode superstep**: K
decode iterations issued back to back on the device, whose carry holds
the pending tokens, the per-slot lengths and the remaining budgets
(greedy argmax, in-place KV appends, length bumps and done-masking all
stay on the device), then (3) copies the K x B emitted tokens to the host
in ONE transfer, commits them and retires finished requests.

The scheduler picks ``K = min(superstep_cap, min remaining budgets)``, so
no slot overruns its budget inside the loop and the host is consulted
only at superstep boundaries (``stats["host_syncs"]`` counts what the
reference counts: one per prefill group, one per superstep).
``superstep_k=1`` is the original host-driven per-token loop and the
conformance reference. Where the reference jits and donates the cache,
the port writes the pools in place; ``snapshot()`` copies them.

Greedy (argmax) decoding. Dense GQA decoders only; the prefix cache and
serving meshes come with later slices (ROADMAP Queue 1 items 7 and 9).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve as resolve_device
from repro_torch.models.layers import unembed
from repro_torch.models.model import apply_model
from repro_torch.serve.kv_cache import PagedCacheConfig, PagedKVCache
from repro_torch.serve.scheduler import Request, RequestState, Scheduler


class SnapshotInFlightError(RuntimeError):
    """``ServeEngine.snapshot()`` called while requests are in flight.

    Snapshots are idle-only: an image taken mid-decode would hold pages
    of requests the scheduler still owns. Callers drain or ``crash()``
    first; the refused call changes nothing. ``n_active`` / ``n_waiting``
    give the in-flight population."""

    def __init__(self, n_active: int, n_waiting: int):
        super().__init__(
            f"snapshot requires a drained engine ({n_active} active, "
            f"{n_waiting} waiting) — crash() or drain first")
        self.n_active = int(n_active)
        self.n_waiting = int(n_waiting)


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU numpy copy of ``t``; bf16 (which numpy lacks) widens to f32,
    exactly."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


class ServeEngine:
    def __init__(self, params, cfg: ArchConfig,
                 ccfg: Optional[PagedCacheConfig] = None,
                 superstep_k: int = 8, prefix_cache: str = "off",
                 policy: str = "fifo", mesh=None, rules=None,
                 device="cuda"):
        if superstep_k < 1:
            raise ValueError(f"need superstep_k >= 1, got {superstep_k}")
        if prefix_cache not in ("off", "on"):
            raise ValueError(f"prefix_cache must be off|on, "
                             f"got {prefix_cache!r}")
        if prefix_cache == "on":
            raise NotImplementedError(
                "the prefix cache comes with ROADMAP Queue 1 item 7")
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                "serving meshes (tensor-parallel decode) come with ROADMAP "
                "Queue 1 item 9")
        self.device = resolve_device(device)
        if params["embed"]["tok"].device != self.device:
            raise ValueError(f"params are on {params['embed']['tok'].device},"
                             f" the engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.superstep_k = int(superstep_k)
        self.prefix_cache = prefix_cache
        self.ccfg = ccfg or PagedCacheConfig()
        self.kv = PagedKVCache(cfg, self.ccfg, device=self.device)
        self.sched = Scheduler(self.ccfg, policy=policy)
        # the reference's counters, names and meaning alike (the prefix
        # cache's stay 0 until it is ported)
        self.stats = {"prefill_calls": 0, "decode_steps": 0,
                      "supersteps": 0, "host_syncs": 0,
                      "admitted": 0, "retired": 0, "aborted": 0,
                      "table_uploads": 0,
                      "cache_hit_tokens": 0, "cache_miss_tokens": 0,
                      "suffix_steps": 0, "preemptions": 0, "resumed": 0,
                      "swapped_pages": 0, "cow_forks": 0,
                      "prefix_evictions": 0}
        self._next_rid = 0

    # -- the device programs ---------------------------------------------
    @torch.no_grad()
    def _prefill(self, tokens: torch.Tensor, last: torch.Tensor):
        """First tokens (B,) at positions ``last`` and the dense prefill
        cache. Only the rows at ``last`` are unembedded: the same argmax
        as the reference's over full logits, without a (B, S, vocab)
        tensor."""
        x, _, cache = apply_model(self.params, tokens, self.cfg,
                                  mode="prefill", logits_chunk=1)
        rows = torch.arange(tokens.shape[0], device=self.device)
        logits = unembed(self.params["embed"], x[rows, last], self.cfg)
        return logits.argmax(-1).to(torch.int32), cache

    @torch.no_grad()
    def _decode(self, tokens, lens, tbl):
        logits, _, _ = apply_model(self.params, tokens, self.cfg,
                                   mode="decode", cache=self.kv.cache,
                                   cache_index=lens, page_table=tbl)
        return logits[:, -1].argmax(-1).to(torch.int32)

    @torch.no_grad()
    def _superstep(self, pending, lens, tbl, remaining, k: int):
        """K decode iterations on the device, no host sync inside.

        Carry: pending tokens (B,), lengths (B,), remaining budgets (B,).
        Each iteration feeds the pending token at position ``lens``,
        argmaxes, and advances the lengths of the slots with budget left;
        the others hold their token and length (idle slots keep writing
        masked garbage into the null page). Returns the (K, B) tokens, on
        the device, and the final lengths."""
        toks = []
        for _ in range(k):
            active = (remaining > 0).to(torch.int32)
            nxt = self._decode(pending[:, None], lens, tbl)
            pending = torch.where(active == 1, nxt, pending)
            lens = lens + active
            remaining = remaining - active
            toks.append(pending)
        return torch.stack(toks), lens

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, priority: int = 0,
               deadline: Optional[float] = None) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("need max_new_tokens >= 1")
        rid = self._next_rid
        self._next_rid += 1
        # an over-capacity request lands in sched.rejected (with reason)
        self.sched.submit(Request(rid=rid, prompt=prompt,
                                  max_new_tokens=max_new_tokens,
                                  priority=priority, deadline=deadline))
        return rid

    @property
    def rejected(self):
        """(Request, reason) pairs refused at submit (over-capacity)."""
        return self.sched.rejected

    # ------------------------------------------------------------------
    def _admit(self) -> None:
        admitted = self.sched.admissions(self.kv.available_pages)
        if not admitted:
            if not self.sched.active and self.sched.waiting:
                raise RuntimeError(
                    "head request can never be admitted (page pool too "
                    "small even when idle)")
            return
        fresh = [st for st in admitted if st.swap is None]
        for st in admitted:
            if st.swap is not None:
                self._resume(st)
        self.stats["admitted"] += len(fresh)
        if fresh:
            self._admit_grouped(fresh)
        self.stats["table_uploads"] = self.kv.table_uploads

    def _admit_grouped(self, admitted: List[RequestState]) -> None:
        """Batched prefill per page-padded prompt-length group: right
        padding is invisible to causal attention, and ``admit`` copies
        only the first s0 tokens of each prompt into the pages."""
        ps = self.ccfg.page_size
        groups: Dict[int, List[RequestState]] = {}
        for st in admitted:
            groups.setdefault(-(-st.req.prompt_len // ps) * ps, []).append(st)
        for bucket, group in sorted(groups.items()):
            prompts = np.zeros((len(group), bucket), np.int32)
            for i, st in enumerate(group):
                prompts[i, :st.req.prompt_len] = st.req.prompt
            last = np.asarray([st.req.prompt_len - 1 for st in group])
            first, cache = self._prefill(
                torch.tensor(prompts, device=self.device),
                torch.tensor(last, device=self.device))
            self.stats["prefill_calls"] += 1
            first = first.cpu().numpy()
            self.stats["host_syncs"] += 1
            for i, st in enumerate(group):
                one = ({"mixer": {k: v[:, i:i + 1]
                                  for k, v in cache[0]["mixer"].items()},
                        "ffn": {}},)
                self.kv.admit(st.slot, one, st.req.prompt_len,
                              st.req.total_len)
                self._first_token(st, int(first[i]))

    def _first_token(self, st: RequestState, tok: int) -> None:
        st.pending = tok
        st.generated.append(tok)
        if st.ttft is None:
            st.ttft = time.monotonic() - st.t_submit
        if st.done:             # max_new_tokens == 1: no decode needed
            self._retire(st.slot)

    def _resume(self, st: RequestState) -> None:
        """Swap a preempted request back in; its pending token and stream
        survived on the host, so decode continues where it stopped."""
        try:
            self.kv.swap_in(st.slot, st.swap, st.req.prompt,
                            st.req.total_len)
        except MemoryError:
            self.sched.requeue(st)
            return
        st.swap = None
        self.stats["resumed"] += 1

    def _preempt(self) -> None:
        """SLA rescue: while a strictly higher-priority request starves in
        the queue, swap the worst-scored active request's KV to the host
        and hand its slot over (one victim per round, bounded)."""
        guard = len(self.sched.active)
        while guard > 0:
            slot = self.sched.preemption_victim()
            if slot is None:
                return
            st = self.sched.active[slot]
            st.swap = self.kv.swap_out(slot)
            self.sched.preempt(slot)
            self.stats["preemptions"] += 1
            self._admit()
            guard -= 1

    def _retire(self, slot: int) -> None:
        self.kv.evict(slot)
        self.sched.retire(slot)
        self.stats["retired"] += 1

    # -- fault surface ---------------------------------------------------
    def abort(self, slot: int) -> RequestState:
        """Kill one in-flight request: its pages are freed and its state
        lands in ``sched.aborted``; co-resident slots decode on as if it
        had never been there."""
        st = self.sched.active[slot]
        self.kv.evict(slot)
        self.sched.abort(slot)
        self.stats["aborted"] += 1
        return st

    def crash(self) -> List[int]:
        """Whole-replica crash: every active request is aborted and the
        waiting queue dropped; weights and the empty pool survive. Returns
        the rids whose work was lost."""
        lost = [self.abort(slot).req.rid for slot in list(self.sched.active)]
        dropped = self.sched.drop_waiting()
        self.stats["aborted"] += len(dropped)
        return lost + [st.req.rid for st in dropped]

    # -- checkpoint-based restart ----------------------------------------
    def snapshot(self) -> Dict[str, np.ndarray]:
        """Host image of the idle engine's data plane, the reference's
        flat keys: every KV pool leaf (``kv/{pos}/{part}/{name}``, bf16
        widened to f32), the page table, lengths and the rid counter."""
        if not self.sched.idle:
            raise SnapshotInFlightError(len(self.sched.active),
                                        len(self.sched.waiting))
        flat: Dict[str, np.ndarray] = {
            "page_table": self.kv.page_table.copy(),
            "kv_lens": self.kv.kv_lens.copy(),
            "next_rid": np.asarray(self._next_rid, np.int64),
        }
        for pos, blk in enumerate(self.kv.cache):
            for part in ("mixer", "ffn"):
                for name, leaf in blk[part].items():
                    flat[f"kv/{pos}/{part}/{name}"] = _host_array(leaf)
        return flat

    def restart(self, image: Optional[Dict[str, np.ndarray]] = None
                ) -> None:
        """Process-restart twin: a fresh scheduler and paged cache and,
        with ``image``, the KV pools reloaded from a :meth:`snapshot`. The
        rid counter stays monotone across the restart."""
        self.kv = PagedKVCache(self.cfg, self.ccfg, device=self.device)
        self.sched = Scheduler(self.ccfg, policy=self.sched.policy)
        if image is not None:
            for pos, blk in enumerate(self.kv.cache):
                for part in ("mixer", "ffn"):
                    for name, leaf in blk[part].items():
                        leaf.copy_(torch.as_tensor(
                            image[f"kv/{pos}/{part}/{name}"]))
            self.kv.page_table = np.asarray(image["page_table"],
                                            np.int32).copy()
            self.kv.kv_lens = np.asarray(image["kv_lens"], np.int32).copy()
            self.kv._tables_dirty = True
            self._next_rid = max(self._next_rid, int(image["next_rid"]))
        self.stats["restarts"] = self.stats.get("restarts", 0) + 1

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One serving step: admit -> preempt (sla) -> decode superstep ->
        commit/retire."""
        self.sched.clock += 1.0
        self._admit()
        self._preempt()
        self.stats["swapped_pages"] = self.kv.swapped_pages
        if not self.sched.active:
            return
        if self.superstep_k == 1:
            self._step_single()
            return
        k = self.sched.superstep_k(self.superstep_k)
        if k == 0:      # pragma: no cover - active slots always have budget
            return
        toks = np.zeros((self.ccfg.num_slots,), np.int32)
        remaining = np.zeros((self.ccfg.num_slots,), np.int32)
        for slot, st in self.sched.active.items():
            toks[slot] = st.pending
            remaining[slot] = st.req.max_new_tokens - len(st.generated)
        out, new_lens = self._superstep(
            torch.tensor(toks, device=self.device), self.kv.kv_lens_dev,
            self.kv.page_table_dev,
            torch.tensor(remaining, device=self.device), k)
        self.stats["decode_steps"] += k
        self.stats["supersteps"] += 1
        active = list(self.sched.active)
        self.kv.commit_tokens(active, k, new_lens)
        out = out.cpu().numpy()          # (K, B): the one boundary sync
        self.stats["host_syncs"] += 1
        self.stats["table_uploads"] = self.kv.table_uploads
        for slot in active:
            st = self.sched.active[slot]
            st.generated.extend(int(t) for t in out[:, slot])
            st.pending = int(out[-1, slot])
            if st.done:
                self._retire(slot)

    def _step_single(self) -> None:
        """The original one-token host loop (superstep_k=1 conformance)."""
        toks = np.zeros((self.ccfg.num_slots, 1), np.int32)
        for slot, st in self.sched.active.items():
            toks[slot, 0] = st.pending
        nxt = self._decode(torch.tensor(toks, device=self.device),
                           self.kv.kv_lens_dev, self.kv.page_table_dev)
        self.stats["decode_steps"] += 1
        self.stats["supersteps"] += 1
        active = list(self.sched.active)
        self.kv.commit_token(active)     # each slot's pending token landed
        nxt = nxt.cpu().numpy()
        self.stats["host_syncs"] += 1
        self.stats["table_uploads"] = self.kv.table_uploads
        for slot in active:
            st = self.sched.active[slot]
            st.pending = int(nxt[slot])
            st.generated.append(st.pending)
            if st.done:
                self._retire(slot)

    # ------------------------------------------------------------------
    def run(self, max_steps: int = 100_000) -> Dict[int, np.ndarray]:
        """Drive to completion; returns rid -> generated tokens."""
        steps = 0
        while not self.sched.idle:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("serving loop did not drain")
        return {rid: np.asarray(st.generated, np.int32)
                for rid, st in self.sched.finished.items()}

