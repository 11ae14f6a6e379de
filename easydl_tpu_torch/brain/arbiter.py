"""Global chip arbiter: ONE pure decision function allocating a fixed chip
supply across N concurrent ElasticJobs by priority (ROADMAP item 5).

Until this module, every Brain policy scoped to ONE job (autoscale its
workers, pick its mesh shape); the chip supply itself was nobody's
decision — N jobs on one substrate would each believe they own the
machine. The arbiter is the missing global half: given every job's claim
(priority, min/max chips, current demand and holding) and the total chip
supply, it computes the target allocation and the bounded set of chip
MOVES that walk the fleet toward it.

Design rules (each one is a drill/sim invariant, not prose):

- **priorities honored** — targets come from a two-pass priority
  water-fill: every job's ``min_chips`` floor first (highest priority
  first when even the floors don't fit), then remaining supply by
  strictly descending priority up to each job's clamped demand. A
  lower-priority job never holds above-floor chips while a higher-
  priority job's demand is unmet.
- **no starvation** — ``min_chips`` is a hard floor: preemption never
  takes a job below it, no matter how hungry a higher-priority job is.
  (A claim declaring ``min_chips=0`` has opted out of the floor — the
  simulator's starvation negative control exploits exactly that.)
- **preemption is strictly upward** — a chip is taken from a donor only
  for a receiver of strictly higher priority; equal-priority jobs can
  never preempt each other (two peers would otherwise ping-pong a chip
  through every demand wobble).
- **hold-down / no-thrash** — both parties of a preemption are frozen
  (neither donates nor receives — not even from the free pool) for
  ``holddown_s``; since every possible A→B→A ping-pong pair has a
  preemption leg, the bounce is structurally impossible inside one
  window, while free-pool grants (which take nothing from anyone) stay
  unthrottled so fleet bootstrap is instant. Preemptions are further
  capped per decision (``max_preemptions_per_decision``) so one scale-up
  burst never drains half the fleet in a single tick — each preempted
  chip pays a real drain, and drains should be paced.

Pure and virtual-clock-pure (easylint rule 5 — this file is in the
simulator's PURE_PATHS set): the caller supplies ``now`` and the
hold-down state; same inputs ⇒ byte-identical decision
(:func:`decision_bytes`). That identity is the drill's offline-replay
acceptance gate: every live decision is logged with its FULL inputs, and
:func:`replay_decision_log` re-derives each verdict through this very
function and byte-compares (chaos/invariants.py ``arbiter_replay``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence

__all__ = [
    "ArbiterConfig",
    "GlobalChipArbiter",
    "JobClaim",
    "arbiter_decision",
    "claim_from_dict",
    "decision_bytes",
    "replay_decision_log",
    "target_allocations",
]


@dataclass(frozen=True)
class JobClaim:
    """One job's standing in the arbitration — the CR's scheduling block
    (priority, min/max replicas) plus its live demand and holding."""

    name: str
    #: larger = more important (matches k8s PriorityClass semantics)
    priority: int = 0
    #: hard floor — the no-starvation guarantee; preemption never goes
    #: below it. 0 opts the job out of the floor.
    min_chips: int = 0
    #: cap on what the job may hold (>= min_chips)
    max_chips: int = 1
    #: chips the job wants right now (its plan / autoscaler ask)
    demand: int = 0
    #: chips it currently holds
    allocated: int = 0

    def clamped_demand(self) -> int:
        """Demand folded into the [min_chips, max_chips] envelope."""
        hi = max(self.max_chips, self.min_chips)
        return max(self.min_chips, min(self.demand, hi))

    def to_dict(self) -> Dict[str, int]:
        return {
            "name": self.name, "priority": self.priority,
            "min_chips": self.min_chips, "max_chips": self.max_chips,
            "demand": self.demand, "allocated": self.allocated,
        }


def claim_from_dict(d: Mapping[str, Any]) -> JobClaim:
    return JobClaim(
        name=str(d["name"]), priority=int(d.get("priority", 0)),
        min_chips=int(d.get("min_chips", 0)),
        max_chips=int(d.get("max_chips", 1)),
        demand=int(d.get("demand", 0)),
        allocated=int(d.get("allocated", 0)),
    )


@dataclass(frozen=True)
class ArbiterConfig:
    """Damping knobs. The defaults suit a real fleet where a preempted
    chip pays a multi-second drain; drills/sims shrink them."""

    #: both parties of a preemption are frozen (no further gains OR
    #: losses) for this long — the anti-ping-pong window
    holddown_s: float = 30.0
    #: preemptions (not free-pool grants) per decision
    max_preemptions_per_decision: int = 1

    def to_dict(self) -> Dict[str, Any]:
        return {
            "holddown_s": self.holddown_s,
            "max_preemptions_per_decision":
                self.max_preemptions_per_decision,
        }


def _order(claims: Sequence[JobClaim]) -> List[JobClaim]:
    """Deterministic arbitration order: priority descending, then name —
    byte-identical decisions require a total order over claims."""
    return sorted(claims, key=lambda c: (-c.priority, c.name))


def target_allocations(claims: Sequence[JobClaim],
                       total_chips: int) -> Dict[str, int]:
    """The pure water-fill: floors first (priority order, so an
    infeasible floor set starves the LOWEST priority floors), then
    remaining supply by priority up to each job's clamped demand."""
    alloc: Dict[str, int] = {c.name: 0 for c in claims}
    left = max(0, int(total_chips))
    for c in _order(claims):
        take = min(max(0, c.min_chips), left)
        alloc[c.name] = take
        left -= take
    for c in _order(claims):
        want = c.clamped_demand()
        extra = min(max(0, want - alloc[c.name]), left)
        alloc[c.name] += extra
        left -= extra
    return alloc


def arbiter_decision(claims: Sequence[JobClaim], total_chips: int,
                     now: float,
                     last_move_at: Optional[Mapping[str, float]] = None,
                     config: Optional[ArbiterConfig] = None
                     ) -> Dict[str, Any]:
    """One arbitration round → the canonical decision document.

    Returns::

        {"target": {job: chips},          # the water-fill ideal
         "allocations": {job: chips},     # holdings AFTER the moves
         "grants": [{"to", "chips"}],     # free-pool chips handed out
         "preemptions": [{"from", "to", "chips", "from_priority",
                          "to_priority"}],
         "reclaims": [{"from", "chips"}], # overcommit shed (see below)
         "held": [job, ...],              # frozen by hold-down this round
         "feasible": bool,                # sum of floors fit the supply
         "total_chips", "free_chips", "now"}

    ``grants`` + ``preemptions`` are the moves the caller actuates; a
    preemption means "drain one chip's worth of the donor through the
    preempt-notice path, then hand it to the receiver". The function
    never mutates its inputs — hold-down bookkeeping belongs to the
    caller (:class:`GlobalChipArbiter` for the common case)."""
    cfg = config or ArbiterConfig()
    moves_at = dict(last_move_at or {})
    claims = list(claims)
    by_name = {c.name: c for c in claims}
    target = target_allocations(claims, total_chips)
    feasible = sum(max(0, c.min_chips) for c in claims) <= int(total_chips)
    held = sorted(
        name for name, t in moves_at.items()
        if name in by_name and now - float(t) < cfg.holddown_s
    )
    frozen = set(held)
    free = int(total_chips) - sum(max(0, c.allocated) for c in claims)

    # Working copy of holdings the moves below mutate.
    have = {c.name: max(0, c.allocated) for c in claims}

    grants: List[Dict[str, Any]] = []
    for c in _order(claims):
        if free <= 0:
            break
        if c.name in frozen:
            continue
        need = target[c.name] - have[c.name]
        if need <= 0:
            continue
        take = min(need, free)
        have[c.name] += take
        free -= take
        grants.append({"to": c.name, "chips": take})

    preemptions: List[Dict[str, Any]] = []
    budget = max(0, cfg.max_preemptions_per_decision)
    # Receivers: still under target after the free grants, richest
    # priority first. Donors: above target, POOREST priority first —
    # and strictly below the receiver's priority, never below min.
    receivers = [c for c in _order(claims)
                 if c.name not in frozen and have[c.name] < target[c.name]]
    donors = [c for c in reversed(_order(claims))
              if c.name not in frozen]
    for r in receivers:
        while have[r.name] < target[r.name] and budget > 0:
            donor = next(
                (d for d in donors
                 if d.priority < r.priority
                 and have[d.name] > max(target[d.name], d.min_chips)),
                None,
            )
            if donor is None:
                break
            have[donor.name] -= 1
            have[r.name] += 1
            budget -= 1
            preemptions.append({
                "from": donor.name, "from_priority": donor.priority,
                "to": r.name, "to_priority": r.priority, "chips": 1,
            })
        if budget <= 0:
            break

    # Supply correction: when the fleet transiently holds MORE than the
    # supply (a preemption's receiver leveled up before its donor
    # finished draining — the normal actuation order: grant fast, drain
    # slowly), shed the excess from above-target holdings, poorest
    # priority first. Not paced and hold-down-exempt: each such chip's
    # move was already paced when its preemption was DECIDED — this stage
    # only completes it, and leaving a supply violation open for a whole
    # hold-down window would be worse than the thrash the window guards.
    reclaims: List[Dict[str, Any]] = []
    excess = sum(have.values()) - int(total_chips)
    if excess > 0:
        for c in reversed(_order(claims)):
            while excess > 0 and have[c.name] > target[c.name]:
                have[c.name] -= 1
                excess -= 1
                reclaims.append({"from": c.name, "chips": 1})

    return {
        "now": round(float(now), 6),
        "total_chips": int(total_chips),
        "free_chips": int(total_chips) - sum(have.values()),
        "feasible": feasible,
        "target": {name: int(n) for name, n in sorted(target.items())},
        #: holdings AFTER this round's moves actuate — what the operator
        #: levels pod replicas to and the fleet walks agents toward
        "allocations": {name: int(n) for name, n in sorted(have.items())},
        "grants": grants,
        "preemptions": preemptions,
        "reclaims": reclaims,
        "held": held,
    }


def decision_bytes(decision: Mapping[str, Any]) -> bytes:
    """Canonical serialization — the byte identity the offline replay
    gate (and the determinism tests) are stated over."""
    return json.dumps(decision, sort_keys=True,
                      separators=(",", ":")).encode()


class GlobalChipArbiter:
    """Stateful wrapper owning the hold-down bookkeeping — shared
    VERBATIM between the live fleet (controller/fleet.py, the operator's
    chip-budget leveling) and the offline simulator (sim/multijob.py),
    so the two can never drift. Virtual-clock-pure: every entry point
    takes ``now``."""

    def __init__(self, config: Optional[ArbiterConfig] = None):
        self.config = config or ArbiterConfig()
        #: job -> time of its last chip gain/loss (the hold-down anchor)
        self.last_move_at: Dict[str, float] = {}
        #: decision log records ({"inputs": ..., "verdict": ...}) in
        #: decision order — what the drill writes and the replay re-derives
        self.log: List[Dict[str, Any]] = []

    def decide(self, claims: Sequence[JobClaim], total_chips: int,
               now: float) -> Dict[str, Any]:
        """Arbitrate once; stamps hold-down on both preemption parties and
        appends the full (inputs, verdict) record to :attr:`log`. The
        inputs snapshot is taken BEFORE the stamp — replaying it through
        :func:`arbiter_decision` must reproduce the verdict bytes. The
        decision is computed from the SAME 6-decimal-rounded clock the
        log records (and the stamps store), so the replay is
        self-consistent by construction — deciding on unrounded values
        could flip a hold-down comparison sitting within 1e-6 s of the
        window edge and fail the byte gate on a correct run."""
        now = round(float(now), 6)
        inputs = {
            "claims": [c.to_dict() for c in _order(claims)],
            "total_chips": int(total_chips),
            "now": now,
            "last_move_at": {k: float(v)
                             for k, v in sorted(self.last_move_at.items())},
            "config": self.config.to_dict(),
        }
        decision = arbiter_decision(claims, total_chips, now,
                                    self.last_move_at, self.config)
        # Hold-down anchors on PREEMPTIONS only: a free-pool grant took
        # nothing from anyone (freezing its recipient would stall fleet
        # bootstrap for a whole window), while every possible ping-pong
        # pair has a preemption leg — stamping both of its parties blocks
        # the bounce. Frozen jobs are still excluded from grants, so a
        # just-preempted donor can't refill from the free pool either.
        for p in decision["preemptions"]:
            self.last_move_at[str(p["from"])] = now
            self.last_move_at[str(p["to"])] = now
        self.log.append({"inputs": inputs, "verdict": decision})
        return decision


def replay_decision_log(records: Sequence[Mapping[str, Any]]
                        ) -> Dict[str, Any]:
    """Re-derive every logged verdict from its own recorded inputs
    through the pure function and byte-compare — the offline half of the
    multi-tenant drill's acceptance gate. Returns::

        {"decisions": N, "identical": bool, "mismatches": [...]}
    """
    mismatches: List[Dict[str, Any]] = []
    for i, rec in enumerate(records):
        inputs = dict(rec.get("inputs") or {})
        want = rec.get("verdict")
        cfg_doc = dict(inputs.get("config") or {})
        got = arbiter_decision(
            [claim_from_dict(c) for c in inputs.get("claims", [])],
            int(inputs.get("total_chips", 0)),
            float(inputs.get("now", 0.0)),
            {str(k): float(v)
             for k, v in dict(inputs.get("last_move_at") or {}).items()},
            ArbiterConfig(
                holddown_s=float(cfg_doc.get("holddown_s", 30.0)),
                max_preemptions_per_decision=int(
                    cfg_doc.get("max_preemptions_per_decision", 1)),
            ),
        )
        if want is None or decision_bytes(got) != decision_bytes(want):
            mismatches.append({
                "index": i, "recorded": want, "replayed": got,
            })
    return {
        "decisions": len(records),
        "identical": not mismatches and len(records) > 0,
        "mismatches": mismatches[:5],
    }
