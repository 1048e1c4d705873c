"""Closed-loop serving through the port's ``ServeEngine``.

Each of ``clients`` clients sends a request, waits for its whole reply,
and sends the next one at once (no think time). A front end forwards the
clients' requests to the engine before each ``step()``. Request j of the
seed is ``tokens.Requests``'.

Set-up sends each client's first request with a budget drawn from 1 to
its output length (the same draws for every seed), so slots retire out
of phase, and steps until every
first request has its first token. The window then steps until a step ends past
``--seconds``. A time is taken on the host clock when ``step()`` returns:
a request's first token reaches its client then, and its time to first
token runs from the client's send. Once the window has closed, a sample
of the finished requests drawn from the seed, with the longest among
them, is read by the plain reference (``reference.model.served_gaps``).
"""
from __future__ import annotations

import gc
import json
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

import flops
import judge
import tokens
import weights
from devtrace import TRACE_SECONDS, Tracer, log
from program import arch_config
from reference.model import Matmul, precision, served_gaps


@dataclass
class Req:
    client: int
    prompt: np.ndarray
    budget: int
    t_send: float
    rid: int = -1
    state: object = None
    seen: int = 0
    t_first: Optional[float] = None


class Loop:
    """The clients, the front end and the engine."""

    def __init__(self, eng, traffic: Dict, reqs: "tokens.Requests",
                 arch: Dict):
        self.eng, self.tr, self.reqs, self.arch = eng, traffic, reqs, arch
        self.front: deque = deque()
        self.live: Dict[int, Req] = {}        # rid -> request in the engine
        self.done: List[Req] = []
        self.next_j = 0
        self.n_finished = 0
        self.rng = tokens.rng(0, 7)          # first budgets: every seed alike
        self.window = None                     # counters of the window
        self.log_steps = False
        self.steps_log: List = []

    def send(self, client: int, first: bool = False) -> None:
        prompt, budget = self.reqs.get(self.next_j)
        if first:
            budget = int(self.rng.integers(1, budget + 1))
        self.front.append(Req(client, prompt, budget, time.perf_counter()))
        self.next_j += 1

    def _forward(self) -> None:
        while self.front:
            q = self.front.popleft()
            q.rid = self.eng.submit(q.prompt, q.budget)
            self.live[q.rid] = q
            if self.window is not None:
                self.window["sent"] += 1

    def step(self) -> None:
        self._forward()
        dec0 = self.eng.stats["decode_steps"]
        self.eng.step()
        now = time.perf_counter()
        k = self.eng.stats["decode_steps"] - dec0
        sched = self.eng.sched
        states = list(sched.active.values())
        fin = list(sched.finished.values())[self.n_finished:]
        self.n_finished += len(fin)
        w = self.window
        slots = []
        for st in states + fin:
            q = self.live.get(st.req.rid)
            if q is None:
                continue
            q.state = st
            gen = len(st.generated)
            new = gen - q.seen
            if new <= 0:
                continue
            prefilled = q.t_first is None
            if prefilled:
                q.t_first = now
            n_dec = new - 1 if prefilled else new
            ctx0 = len(q.prompt) + gen - n_dec     # context of the 1st decode
            if n_dec:
                slots.append((n_dec, ctx0))
            if w is not None:
                w["tokens"] += new
                if prefilled:
                    w["ttft"].append(now - q.t_send)
                    w["flops"] += flops.prefill_flops(self.arch, len(q.prompt))
                if n_dec:
                    w["flops"] += flops.decode_flops(
                        self.arch, n_dec, n_dec * ctx0 + n_dec * (n_dec - 1) / 2)
            q.seen = gen
        if self.log_steps:
            self.steps_log.append((k, slots))
        for st in fin:
            q = self.live.pop(st.req.rid, None)
            if q is not None:
                self.done.append(q)
                self.send(q.client)


def _pages(traffic: Dict) -> int:
    top = traffic["prompt_len"]["max"] + traffic["output_len"]["max"]
    return -(-top // traffic["page_size"])


def build(cell, seed: int, device):
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kv_cache import PagedCacheConfig
    tr = cell.traffic
    arch = arch_config(cell.config)
    params = weights.make_params(arch, seed, device)
    per_seq = _pages(tr)
    ccfg = PagedCacheConfig(num_slots=tr["slots"], page_size=tr["page_size"],
                            num_pages=tr["slots"] * per_seq + 1,
                            max_pages_per_seq=per_seq)
    eng = ServeEngine(params, arch, ccfg, superstep_k=tr["superstep_k"],
                      device=device)
    stream = tokens.stream(seed, tr["prompt_len"]["max"], arch.vocab_size)
    loop = Loop(eng, tr, tokens.Requests(seed, tr, stream),
                cell.config["arch"])
    return params, eng, loop


def sample(done: List[Req], seed: int, n: int) -> List[Req]:
    """``n`` finished requests drawn from the seed, the longest first."""
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: len(done[i].prompt) + done[i].budget)
    rest = [i for i in range(len(done)) if i != longest]
    pick = tokens.rng(seed, 8).permutation(rest)[:max(n - 1, 0)]
    return [done[longest]] + [done[int(i)] for i in pick]


def check(params, config: Dict, picked: List[Req], batch: int,
          control: Optional[str] = None) -> List[float]:
    """The gap of every served token of the picked requests
    (``served_gaps``), read in batches of ``batch`` requests."""
    seqs = [(q.prompt, list(q.state.generated)) for q in picked]
    mm = Matmul(precision(config))
    ctl = Matmul(control) if control else None
    gaps = []
    for i in range(0, len(seqs), batch):
        for g in served_gaps(params, config, seqs[i:i + batch], mm, ctl):
            gaps += g
    return gaps


def gap_numbers(gaps: List[float]) -> Dict[str, float]:
    """The widest gap over the served tokens read."""
    return {"gap_max": float(max(gaps)) if gaps else float("inf")}


def quarters(marks) -> List[float]:
    """Tokens a second in each quarter of the window, from the (seconds,
    tokens so far) at each step's end: whether a slow run is slow
    throughout or in bursts."""
    out, t_prev, n_prev = [], 0.0, 0
    end = marks[-1][0] if marks else 0.0
    for q in (1, 2, 3, 4):
        t, n = next(m for m in marks if m[0] >= q * end / 4)
        out.append(round((n - n_prev) / max(t - t_prev, 1e-9), 2))
        t_prev, n_prev = t, n
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def warm(loop: Loop) -> None:
    """Every client's first request, its budget cut, until each has its
    first token."""
    firsts = []
    for c in range(loop.tr["clients"]):
        loop.send(c, first=True)
        firsts.append(loop.front[-1])
    while any(q.t_first is None for q in firsts):
        loop.step()


def window(loop: Loop, seconds: float, tracer: Optional[Tracer]) -> Dict:
    eng = loop.eng
    w = loop.window = {"tokens": 0, "ttft": [], "flops": 0.0, "sent": 0,
                       "marks": []}
    at_open = len(loop.live) + len(loop.front)
    syncs0 = eng.stats["host_syncs"]
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if tracer and not (tracer.active or tracer.done) and now >= seconds / 3:
            tracer.start()
            loop.log_steps, t_tr = True, now
        loop.step()
        now = time.perf_counter() - t0
        w["marks"].append((now, w["tokens"]))
        if tracer and tracer.active and now - t_tr >= TRACE_SECONDS:
            tracer.stop()
            loop.log_steps = False
        if now >= seconds:
            break
    w["elapsed"] = time.perf_counter() - t0
    if tracer and tracer.active:
        tracer.stop()
        loop.log_steps = False
    w["host_syncs"] = eng.stats["host_syncs"] - syncs0
    w["attempted"] = at_open + w["sent"]
    loop.window = None
    return w


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda") -> Dict:
    tr, chk = cell.traffic, cell.check
    cuda = torch.device(device).type == "cuda"
    params, eng, loop = build(cell, seed, device)
    log("built the engine")
    warm(loop)
    tracer = Tracer() if trace else None
    if tracer:
        tracer.warm()
    _sync(device)
    setup_s = time.monotonic() - t_start
    log(f"set-up done ({loop.next_j} requests sent); the window opens")
    w = window(loop, seconds, tracer)
    log(f"the window closed: {w['elapsed']:.3f} s, {w['tokens']} tokens; "
        f"tokens/s by quarter of the window {quarters(w['marks'])}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = len(eng.rejected) + len(eng.sched.aborted)
    if tracer:
        tracer.reduce()
    picked = sample(loop.done, seed, chk["check_requests"])
    short = [q for q in picked if len(q.state.generated) != q.budget]
    del eng, loop.eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    log("the program's state is freed; the reference reads the sample")
    gaps = check(params, cell.config, picked, chk["ref_batch"])
    nums = gap_numbers(gaps)
    log(f"gaps over {len(gaps)} served tokens: " + json.dumps(nums))
    where = f"{len(picked)} requests, {len(gaps)} tokens"
    numbers = {k: (v, where) for k, v in nums.items()}
    numbers["short_replies"] = (float(len(short)), "sampled replies under budget")
    correct, compared = judge.decide(numbers, dict(chk["limits"],
                                                   short_replies=0))
    e2e = {"output_tokens_per_s": w["tokens"] / w["elapsed"],
           "setup_s": setup_s}
    if w["ttft"]:
        e2e["ttft_p95_ms"] = float(np.percentile(w["ttft"], 95)) * 1e3
    return {
        "correct": correct and failed == 0, "compared": compared,
        "attempted": w["attempted"], "failed": failed,
        "memory_peak_bytes": peak, "e2e": e2e,
        "ctx": {"kind": "serve", "tokens": w["tokens"],
                "window_s": w["elapsed"] - (tracer.overhead_s if tracer else 0),
                "flops": w["flops"], "host_syncs": w["host_syncs"],
                "tracer": tracer, "steps_log": loop.steps_log,
                "arch": cell.config["arch"]},
    }
