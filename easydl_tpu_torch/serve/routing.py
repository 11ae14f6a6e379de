"""Pure routing policy for the serve fleet router — no clocks, no RNG.

The decision half of :mod:`easydl_tpu_torch.serve.router`, split out
under the pure-policy discipline (easylint rule-5 scope): every choice
the router makes — which replica takes a request, whether/where a hedge
goes, when the hedge timer should fire, whether an unhealthy replica
re-enters rotation — is a pure function of explicitly-passed
observations, so the whole policy is table-testable without a fleet and
its verdicts are byte-stable under replay.

Dispatch is least-loaded with consistent-hash session affinity:

- a request WITH a session id goes to its rendezvous-hash (HRW) owner
  among the healthy replicas — the same session always lands on the same
  replica while it lives (its hot-id cache stays warm, and the A/B
  arms see a stable population), and when a replica dies only ITS
  sessions move (highest-remaining-hash, no global reshuffle);
- a request without one goes to the least-loaded replica: fewest
  router-observed outstanding requests, then the lowest replica-reported
  rolling load (the qps/p99 gauges each ``InferResponse`` piggybacks).

Hedging is the straggler discipline applied to the read path: a
request still unanswered after a p95-derived delay fires ONE duplicate
at the next-best replica, first answer wins. The budget is the safety
half — hedges are capped to a fraction of recent traffic so a uniformly
slow (overloaded) fleet cannot double its own load.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class ReplicaView:
    """One replica as the router observes it at decision time."""

    name: str
    #: router-side in-flight requests (the strongest load signal — it
    #: includes everything the rolling gauges haven't seen yet)
    outstanding: int = 0
    #: replica-reported rolling gauges (InferResponse piggyback; 0 until
    #: the first answer)
    qps_recent: float = 0.0
    p99_recent_s: float = 0.0
    #: False while ejected (dead / persistently shedding, in hold-down)
    healthy: bool = True


def session_weight(session_id: str, replica: str, salt: str = "") -> int:
    """Rendezvous (HRW) weight of ``replica`` for ``session_id`` — the
    replica with the highest weight owns the session. Stable hash
    (blake2b), so every router instance agrees forever."""
    h = hashlib.blake2b(f"{session_id}|{replica}|{salt}".encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big")


def route_decision(replicas: Sequence[ReplicaView], session_id: str = "",
                   exclude: Tuple[str, ...] = (),
                   salt: str = "") -> Optional[str]:
    """Pick the replica for one request; None when no healthy candidate.

    ``exclude`` removes replicas from consideration (the hedge path
    excludes the primary — a hedge to the same slow replica is pure
    load). A session request whose HRW owner is excluded falls through
    to least-loaded: affinity is a cache optimisation, availability is
    not negotiable."""
    candidates = [r for r in replicas
                  if r.healthy and r.name not in exclude]
    if not candidates:
        return None
    if session_id:
        owner = max(candidates,
                    key=lambda r: session_weight(session_id, r.name, salt))
        return owner.name
    best = min(candidates,
               key=lambda r: (r.outstanding, r.qps_recent,
                              r.p99_recent_s, r.name))
    return best.name


def hedge_delay_s(latency_p95_s: float, min_delay_s: float,
                  max_delay_s: float) -> float:
    """When the hedge timer fires, from the rolling p95: hedging at the
    tail (not the median) keeps the duplicate rate near the budget even
    before the budget check — clamped so a cold window (p95 0) cannot
    hedge instantly and a sick window cannot defer hedges forever."""
    return min(max(latency_p95_s, min_delay_s), max_delay_s)


def hedge_decision(replicas: Sequence[ReplicaView], primary: str,
                   hedges_recent: int, requests_recent: int,
                   budget: float, session_id: str = "",
                   salt: str = "") -> Optional[str]:
    """Where the hedge goes, or None (budget spent / nowhere to send).

    The budget is a FRACTION of recent routed requests: a fleet whose
    every request is slow would hedge every request — doubling the load
    that made it slow — so past ``budget * requests_recent`` recent
    hedges the answer is None and the request simply waits. The hedge
    target is least-loaded-excluding-primary: session affinity is
    deliberately dropped (the owner IS the slow replica)."""
    if budget <= 0 or requests_recent <= 0:
        return None
    if hedges_recent >= budget * requests_recent:
        return None
    del session_id, salt  # affinity never picks a hedge target
    return route_decision(replicas, session_id="",
                          exclude=(primary,))


def probe_due(now_s: float, ejected_at_s: float, holddown_s: float) -> bool:
    """May an ejected replica be re-probed yet? (Hold-down: an ejected
    replica re-enters rotation only through a successful probe after the
    window — the serving twin of the straggler re-admission damping.)"""
    return now_s - ejected_at_s >= holddown_s
