"""Paper-bound conformance checks (DESIGN.md §10).

Every check returns ``None`` when the invariant holds, else a human-
readable violation string; the scenario runners collect them into the
report so a test can assert ``report.violations == []`` and a failure
names the step and the broken claim.

- **T-set invariants** (§3.2): the per-agent ledger partitioned by
  iterate timestamp must be disjoint, of total size <= n, with every age
  in [0, tau] — checked at *every* stale-mode step via
  ``core.staleness.partition_T``.
- **Liveness**: whenever >= n - r agents were alive across a step, the
  server must have used >= n - r uploads and finished the round in
  finite virtual time (Algorithm 1 / rule (15) never block).
- **Theorem-2 envelope**: with the constant step eta_bar/2 the error
  plateaus inside a ball whose radius is linear in r and the certified
  eps — computed exactly from ``core.redundancy`` on the scenario's
  quadratic costs (D = 2 r mu eps / (alpha gamma) from
  ``theoretical_bound``, plus the empirical Theta(eps) plateau constant
  the theory tests pin at 10).

Torch port of ``repro.sim.conformance``: the same checks over the port's
``core.redundancy`` and ``core.staleness`` (numpy, as in the reference).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.redundancy import (QuadraticCosts, certify_r_eps,
                                         theoretical_bound)
from repro_torch.core.staleness import (check_invariants, partition_T,
                                        t_set_size)
from repro_torch.serve.dispatch import honest_majority

# Theta(eps) plateau constant of Theorem 2(a), pinned empirically by
# tests/test_theory.py::test_theorem2_linear_rate_constant_step
PLATEAU_C = 10.0


@dataclasses.dataclass(frozen=True)
class Envelope:
    r: int
    eps: float
    alpha: float
    gamma: float
    bound: float                  # Theorem-1/2 ball radius D

    def radius(self, slack: float = 1.5) -> float:
        return slack * max(self.bound, PLATEAU_C * self.eps) + 1e-6


def certify_envelope(costs: QuadraticCosts, r: int,
                     samples: int = 600) -> Envelope:
    """Exact (r, eps) certification + Theorem bound for the scenario's
    quadratic costs; the error-vs-(r, eps) envelope the run must meet."""
    eps = certify_r_eps(costs, r, samples=samples)
    alpha, bound, gamma = theoretical_bound(costs, r, eps,
                                            samples=min(samples, 200))
    return Envelope(r=r, eps=eps, alpha=alpha, gamma=gamma, bound=bound)


def check_envelope(dist_final: float, env: Envelope,
                   slack: float = 1.5) -> Optional[str]:
    if env.alpha <= 0:
        return (f"envelope vacuous: alpha={env.alpha:.3f} <= 0 "
                f"(r={env.r} too aggressive for these costs)")
    radius = env.radius(slack)
    if dist_final > radius:
        return (f"Theorem-2 envelope violated: ||x-x*||={dist_final:.4g} > "
                f"{radius:.4g} (r={env.r}, eps={env.eps:.4g}, "
                f"D={env.bound:.4g}, slack={slack})")
    return None


def check_aggregation_ages(max_age: float, tau: int, t: int) -> Optional[str]:
    """Rule (15), engine-coupled and falsifiable: ``max_age`` is the
    oldest gradient the engine *actually aggregated* this step
    (``History.max_age``, recorded from the received mask itself), so an
    off-by-one in the engine's staleness filter fails here even though a
    re-derived partition would still look consistent."""
    if max_age > tau + 1e-9:
        return (f"t={t}: aggregated a gradient of age {max_age:.3f} > "
                f"tau={tau} (rule (15) violated)")
    return None


def check_t_sets(ledger_ts: np.ndarray, t: int, tau: int,
                 n: int) -> Optional[str]:
    """§3.2 invariants of the T^{t;t-i} partition at iteration t.

    NB: this is a *structural* check of the partition helper over the
    live ledger (its properties also hold by construction — the
    hypothesis suite in tests/test_property_staleness.py probes them
    adversarially); the engine-coupled staleness gate is
    :func:`check_aggregation_ages` + :func:`check_liveness`."""
    parts = partition_T(ledger_ts, t, tau)
    if not check_invariants(parts):
        return f"t={t}: T-sets not disjoint: {parts}"
    size = t_set_size(parts)
    if size > n:
        return f"t={t}: |T^t|={size} > n={n}"
    for age, agents in parts.items():
        if agents and not 0 <= age <= tau:
            return f"t={t}: age {age} outside [0, {tau}]"
    return None


def check_staleness_bound(mean_age: float, tau: int,
                          t: int) -> Optional[str]:
    if mean_age > tau + 1e-9:
        return f"t={t}: mean staleness {mean_age:.3f} > tau={tau}"
    return None


def check_liveness(t: int, n: int, r: int, alive_min: int, n_rx: int,
                   round_time: float, dropped: int = 0) -> Optional[str]:
    """Server never blocks (nor starves S^t) with >= n-r live agents.
    ``alive_min`` is the minimum live count observed across the step, so
    a window opening mid-step doesn't raise a false violation; ``dropped``
    is the transport's message-drop count for the step — an alive agent
    whose upload the network ate is correctly excluded from S^t, so the
    promise only covers agents whose messages could arrive."""
    if alive_min - dropped < n - r:
        return None               # degraded regime: liveness not promised
    if not np.isfinite(round_time):
        return f"t={t}: round blocked (infinite round time)"
    if n_rx < n - r:
        return (f"t={t}: only {n_rx} uploads used with {alive_min} live "
                f"agents and {dropped} drops (need n-r={n - r})")
    return None


def check_vote(tokens: np.ndarray, honest: np.ndarray,
               used: Tuple[int, ...], byz_ids: Tuple[int, ...],
               req_idx: int) -> Optional[str]:
    """Majority vote must return the honest stream whenever the used set
    kept an honest majority (serving twin of eq. (18)); the predicate is
    ``serve.dispatch.honest_majority`` — the same one dispatch uses to
    set ``quorum_honest`` — so the two sides can never disagree."""
    n_byz = len(set(used) & set(byz_ids))
    if not honest_majority(len(used), n_byz):
        return None               # quorum lost its honest majority
    if not np.array_equal(tokens, honest):
        return (f"request {req_idx}: vote diverged from honest stream "
                f"(used={used}, byz={byz_ids})")
    return None


def check_request_liveness(req_idx: int, n: int, r: int, deliverable: int,
                           n_used: int, latency: float) -> Optional[str]:
    """Serving twin of :func:`check_liveness` at request granularity
    (e2e harness): whenever >= n-r replica copies were deliverable
    (replica alive for the whole decode, reply not dropped), the
    dispatcher must have answered from >= n-r of them in finite virtual
    time. Fewer deliverable copies is the degraded regime — elastic
    quorum shrink is the *expected* behavior there, not a violation."""
    if deliverable < n - r:
        return None               # degraded regime: liveness not promised
    if not np.isfinite(latency):
        return (f"request {req_idx}: unanswered (infinite latency) with "
                f"{deliverable} deliverable replicas")
    if n_used < n - r:
        return (f"request {req_idx}: answered from only {n_used} replicas "
                f"with {deliverable} deliverable (need n-r={n - r})")
    return None


def check_vote_floor(req_idx: int, n_used: int, n_byz: int) -> Optional[str]:
    """Fleet-controller soundness floor (DESIGN.md §16): the elastic
    quorum may shrink under churn, but a vote consumed from fewer than
    ``2f+1`` replies could be outvoted if all ``f`` Byzantine replicas
    made the used set — the controller must park or retry the request
    instead. The floor formula is ``serve.fleet.vote_floor``; inlined
    here (2f+1) to keep conformance import-light."""
    floor = 2 * int(n_byz) + 1
    if n_used < floor:
        return (f"request {req_idx}: vote consumed from {n_used} replies, "
                f"below the {floor}-reply soundness floor (f={n_byz})")
    return None


def check_no_permanent_loss(req_idx: int, n_delivered: int, n_live: int,
                            n: int, r: int) -> Optional[str]:
    """Fleet-recovery liveness (DESIGN.md §16): as long as >= n-r
    replicas are live at the end of the run, no request may be
    *permanently* lost — detection must have re-fanned it out to live
    replicas and at least one copy delivered. With fewer survivors the
    promise is void (total outage is genuinely unservable)."""
    if n_live < n - r:
        return None               # degraded fleet: loss not promised away
    if n_delivered == 0:
        return (f"request {req_idx}: permanently lost with {n_live} live "
                f"replicas (need only n-r={n - r} to guarantee delivery)")
    return None


def check_replica_agreement(streams, honest_ids, req_idx: int,
                            ) -> Optional[str]:
    """Honest replicas are deterministic copies of one greedy model, so
    every delivered honest stream of a request must be token-identical —
    across *real* engines this is the batch-composition-invariance claim
    of DESIGN.md §9/§12 measured end to end (each replica decodes the
    request against different co-resident batchmates and different page
    tables)."""
    hs = [np.asarray(streams[j]) for j in honest_ids if j in streams]
    for a in hs[1:]:
        if not np.array_equal(hs[0], a):
            return (f"request {req_idx}: honest replicas disagree "
                    f"(ids={sorted(honest_ids)}) — engine determinism or "
                    f"batch-composition invariance broken")
    return None


def summarize(violations: List[str], limit: int = 5) -> str:
    head = violations[:limit]
    more = len(violations) - len(head)
    return "; ".join(head) + (f"; … +{more} more" if more > 0 else "")
