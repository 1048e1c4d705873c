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
the port writes the pools and the recurrent slot states in place, so the
superstep carries every slot's state as the reference's scan does;
``snapshot()`` copies them.

Greedy (argmax) decoding, every decoder-only arch of the registry. MoE
runs *drop-free* (``infer_cfg`` raises the capacity factor to
num_experts / top_k, so capacity >= tokens per group): a request's
tokens must not depend on its batch-mates. Attention-only archs pad
prompts to a page multiple per prefill group; a recurrent (Mamba/RWKV)
state would absorb the pad, so those archs group by exact length.

``prefix_cache="on"`` (attention-only archs) shares resident prompt
pages between requests: a hit prefills only its uncached suffix, one
token per call of the decode program, whose last logits give the first
generated token; ``"off"`` keeps the grouped admission path.

``mesh=`` (a ``launch.mesh.Mesh`` over the ranks of a process group,
``rules=`` optional: only its ``tp_axes`` are read) serves
tensor-parallel: every rank builds this engine on the same replicated
parameters and drives it with the same calls; its GQA pools hold its
KV-head block, decided once from the mesh's own tp extent
(``dist.sharding.kv_head_block``), and the paged decode runs through
``tp_paged_decode`` on that block, so the streams and ``stats`` equal
the one-rank engine's.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve as resolve_device
from repro_torch.dist.sharding import MeshRules, kv_head_block, serve_tp
from repro_torch.models.layers import unembed
from repro_torch.models.model import apply_model
from repro_torch.serve.kv_cache import (PagedCacheConfig, PagedKVCache,
                                        pages_needed)
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


def _batch_row(tree, i: int):
    """Row i of the batch axis (axis 1, after n_periods) of every leaf of
    a prefill cache tree, kept as a batch of one: views."""
    if isinstance(tree, dict):
        return {k: _batch_row(v, i) for k, v in tree.items()}
    return tree[:, i:i + 1]


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
        if prefix_cache == "on" and any(k != "attn"
                                        for k in cfg.layer_pattern):
            # only attention KV is paged; a recurrent layer's state is not
            # content-addressable per token chunk
            raise ValueError(
                "prefix_cache requires an attention-only layer pattern")
        # serving TP: every rank of ``mesh`` runs this engine on the same
        # replicated parameters and the same host logic; its GQA pools
        # hold its KV-head block, and only the paged attention splits
        # (models/attention.py), so every matmul outside it keeps the
        # one-rank engine's reduction order and the streams match it
        if rules is not None and mesh is None:
            raise ValueError(
                "rules= provided without mesh= — pass the mesh the rules "
                "describe, or drop rules for the replicated engine")
        self.device = resolve_device(device)
        if params["embed"]["tok"].device != self.device:
            raise ValueError(f"params are on {params['embed']['tok'].device},"
                             f" the engine on {self.device}")
        self.mesh = mesh
        if mesh is not None and rules is None:
            rules = MeshRules(
                fsdp_axes=(),
                axis_sizes={a: mesh.shape[a] for a in mesh.axis_names})
        self.rules = rules
        self._kv_block = None
        if mesh is not None:
            if mesh.device != self.device:
                raise ValueError(f"mesh on {mesh.device}, the engine on "
                                 f"{self.device}")
            if cfg.attention != "mla":
                self._kv_block = kv_head_block(mesh, rules.tp_axes,
                                               cfg.n_kv_heads, cfg.n_heads)
        self.params = params
        self.cfg = cfg
        self.superstep_k = int(superstep_k)
        self.prefix_cache = prefix_cache
        if cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=float(cfg.moe.num_experts)
                    / cfg.moe.top_k))
        self.infer_cfg = cfg
        self._pad_buckets = all(k == "attn" for k in cfg.layer_pattern)
        self.ccfg = ccfg or PagedCacheConfig()
        self.kv = PagedKVCache(cfg, self.ccfg,
                               enable_prefix=(prefix_cache == "on"),
                               device=self.device, kv_block=self._kv_block)
        self.sched = Scheduler(self.ccfg, policy=policy)
        # the reference's counters, names and meaning alike
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
        x, _, cache = apply_model(self.params, tokens, self.infer_cfg,
                                  mode="prefill", logits_chunk=1)
        rows = torch.arange(tokens.shape[0], device=self.device)
        logits = unembed(self.params["embed"], x[rows, last],
                         self.infer_cfg)
        return logits.argmax(-1).to(torch.int32), cache

    @torch.no_grad()
    def _decode(self, tokens, lens, tbl):
        ctx = (serve_tp(self.mesh, self.rules.tp_axes, self._kv_block)
               if self.mesh is not None else contextlib.nullcontext())
        with ctx:
            logits, _, _ = apply_model(self.params, tokens, self.infer_cfg,
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
    def _need_pages(self, st: RequestState) -> int:
        """Page bill for the admission gate: a prefix hit pays only for
        its uncached pages (plus a COW copy); swaps and cold requests pay
        the whole reservation."""
        if st.swap is None and self.kv.prefix is not None:
            return self.kv.prefix.plan(st.req.prompt,
                                       st.req.total_len).need_pages
        return pages_needed(st.req.total_len, self.ccfg.page_size)

    def _admit(self) -> None:
        with spans.span("serve.admit"):
            admitted = self.sched.admissions(self.kv.available_pages,
                                             need_pages=self._need_pages)
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
                if self.kv.prefix is None:
                    self._admit_grouped(fresh)
                else:
                    for st in fresh:
                        self._admit_prefix(st)
            self.stats["table_uploads"] = self.kv.table_uploads

    @staticmethod
    def _queued(st: RequestState, t_ns: int) -> None:
        """The request's wait (span ``serve.queued``): from its submit to
        the start of its own admission, its group's prefill or its prefix
        admission, so that with that admission it makes up its TTFT."""
        spans.emit("serve.queued", st.t_submit_ns, t_ns, rid=st.req.rid)

    def _admit_grouped(self, admitted: List[RequestState]) -> None:
        """Batched prefill per prompt-length group, page-padded for
        attention-only archs (right padding is invisible to causal
        attention, and ``admit`` copies only the first s0 tokens of each
        prompt into the pages), exact for recurrent ones."""
        ps = self.ccfg.page_size
        groups: Dict[int, List[RequestState]] = {}
        for st in admitted:
            s0 = st.req.prompt_len
            bucket = -(-s0 // ps) * ps if self._pad_buckets else s0
            groups.setdefault(bucket, []).append(st)
        for bucket, group in sorted(groups.items()):
            t_adm = spans.now_ns()
            for st in group:
                self._queued(st, t_adm)
            prompts = np.zeros((len(group), bucket), np.int32)
            for i, st in enumerate(group):
                prompts[i, :st.req.prompt_len] = st.req.prompt
            last = np.asarray([st.req.prompt_len - 1 for st in group])
            with spans.span("serve.prefill",
                            tokens=int(last.sum()) + len(group)):
                first, cache = self._prefill(
                    torch.tensor(prompts, device=self.device),
                    torch.tensor(last, device=self.device))
                self.stats["prefill_calls"] += 1
                with spans.span("serve.sync"):
                    first = first.cpu().numpy()
                self.stats["host_syncs"] += 1
                for i, st in enumerate(group):
                    one = tuple(_batch_row(blk, i) for blk in cache)
                    self.kv.admit(st.slot, one, st.req.prompt_len,
                                  st.req.total_len)
                    self._first_token(st, int(first[i]))

    def _admit_prefix(self, st: RequestState) -> None:
        """Prefix-cache admission: share the resident prompt prefix, feed
        only the uncached suffix, then index this request's blocks for
        the next arrival. A cold miss prefills alone. A plan gone stale
        since the gate (pages reclaimed meanwhile) requeues."""
        req = st.req
        t_adm = spans.now_ns()
        plan = self.kv.prefix.plan(req.prompt, req.total_len)
        if plan.cached_len == 0:
            ps = self.ccfg.page_size
            if pages_needed(req.total_len, ps) > self.kv.available_pages:
                self.sched.requeue(st)
                return
            self._queued(st, t_adm)
            s0 = req.prompt_len
            bucket = -(-s0 // ps) * ps if self._pad_buckets else s0
            prompt = np.zeros((1, bucket), np.int32)
            prompt[0, :s0] = req.prompt
            with spans.span("serve.prefill", rid=req.rid, tokens=s0):
                first, cache = self._prefill(
                    torch.tensor(prompt, device=self.device),
                    torch.tensor([s0 - 1], device=self.device))
                self.stats["prefill_calls"] += 1
                with spans.span("serve.sync"):
                    first = int(first.cpu()[0])
                self.stats["host_syncs"] += 1
                self.kv.admit(st.slot, cache, s0, req.total_len)
            self.kv.register_prompt(st.slot, req.prompt)
            self.stats["cache_miss_tokens"] += s0
            self._first_token(st, first)
            return
        try:
            self.kv.admit_shared(st.slot, plan, req.total_len)
        except MemoryError:
            self.sched.requeue(st)
            return
        self._queued(st, t_adm)
        self.stats["cache_hit_tokens"] += plan.cached_len
        self.stats["cache_miss_tokens"] += req.prompt_len - plan.cached_len
        first = self._feed_suffix(st.slot, req.prompt[plan.cached_len:])
        self.kv.register_prompt(st.slot, req.prompt)
        self._first_token(st, first)

    def _feed_suffix(self, slot: int, suffix) -> int:
        """Feed the uncached suffix through the decode program, one token
        per call at position ``kv_lens[slot]``, with the page table masked
        to this slot (the others point at the null page with length 0, so
        co-resident requests are untouched). The last token's logits give
        the first generated token, where cold prefill reads them."""
        with spans.span("serve.suffix", rid=self.sched.active[slot].req.rid,
                        tokens=len(suffix)):
            b = self.ccfg.num_slots
            tbl = np.zeros_like(self.kv.page_table)
            tbl[slot] = self.kv.page_table[slot]
            tbl_dev = torch.tensor(tbl, device=self.device)
            nxt = None
            for t in np.asarray(suffix, np.int32):
                toks = np.zeros((b, 1), np.int32)
                toks[slot, 0] = int(t)
                lens = np.zeros((b,), np.int32)
                lens[slot] = self.kv.kv_lens[slot]
                nxt = self._decode(torch.tensor(toks, device=self.device),
                                   torch.tensor(lens, device=self.device),
                                   tbl_dev)
                self.kv.note_host_len(slot, int(self.kv.kv_lens[slot]) + 1)
                self.stats["suffix_steps"] += 1
            self.stats["host_syncs"] += 1
            with spans.span("serve.sync"):
                return int(nxt.cpu()[slot])

    def _first_token(self, st: RequestState, tok: int) -> None:
        st.pending = tok
        st.generated.append(tok)
        if st.ttft is None:
            st.ttft = (spans.now_ns() - st.t_submit_ns) * 1e-9
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

    def reset_prefix_cache(self) -> None:
        """Drop every index entry and reclaim the parked pages (a cold
        cache on warm weights)."""
        if self.kv.prefix is not None:
            self.kv.prefix.clear()

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
        rid counter stays monotone across the restart; a prefix cache
        restarts cold (its index is not part of the image)."""
        self.kv = PagedKVCache(self.infer_cfg, self.ccfg,
                               enable_prefix=(self.prefix_cache == "on"),
                               device=self.device, kv_block=self._kv_block)
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
        with spans.span("serve.step"):
            self.sched.clock += 1.0
            self._admit()
            self._preempt()
            self.stats["cow_forks"] = self.kv.cow_forks
            self.stats["swapped_pages"] = self.kv.swapped_pages
            if self.kv.prefix is not None:
                self.stats["prefix_evictions"] = self.kv.prefix.evictions
            if not self.sched.active:
                return
            if self.superstep_k == 1:
                self._step_single()
            else:
                self._step_super()

    def _step_super(self) -> None:
        """One superstep of k decodes, k the least budget left (capped)."""
        k = self.sched.superstep_k(self.superstep_k)
        if k == 0:      # pragma: no cover - active slots always have budget
            return
        with spans.span("serve.superstep", k=k):
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
            with spans.span("serve.commit"):
                self.kv.commit_tokens(active, k, new_lens)
            with spans.span("serve.sync"):
                out = out.cpu().numpy()      # (K, B): the one boundary sync
            self.stats["host_syncs"] += 1
            self.stats["table_uploads"] = self.kv.table_uploads
            with spans.span("serve.commit"):
                for slot in active:
                    st = self.sched.active[slot]
                    st.generated.extend(int(t) for t in out[:, slot])
                    st.pending = int(out[-1, slot])
                    if st.done:
                        self._retire(slot)

    def _step_single(self) -> None:
        """The original one-token host loop (superstep_k=1 conformance)."""
        with spans.span("serve.superstep", k=1):
            toks = np.zeros((self.ccfg.num_slots, 1), np.int32)
            for slot, st in self.sched.active.items():
                toks[slot, 0] = st.pending
            nxt = self._decode(torch.tensor(toks, device=self.device),
                               self.kv.kv_lens_dev, self.kv.page_table_dev)
            self.stats["decode_steps"] += 1
            self.stats["supersteps"] += 1
            active = list(self.sched.active)
            with spans.span("serve.commit"):
                self.kv.commit_token(active)    # each pending token landed
            with spans.span("serve.sync"):
                nxt = nxt.cpu().numpy()
            self.stats["host_syncs"] += 1
            self.stats["table_uploads"] = self.kv.table_uploads
            with spans.span("serve.commit"):
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

