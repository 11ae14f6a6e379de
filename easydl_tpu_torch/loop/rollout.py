"""Pure rollout policy: session→arm assignment and canary pacing.

PURE on purpose (easylint rule-5 scope, like brain/mesh_policy.py): no
wall clock, no global RNG, no IO — every decision is a function of its
arguments, so the simulator replays the REAL policy byte-identically
and the negative control (a config that promotes on too-few
observations) is CAUGHT offline before any live rollout trusts it.

Two halves:

- :func:`assign_arm` — session-consistent A/B assignment:
  ``hash(session_id)`` → [0,1) → canary iff below the canary fraction.
  The same session always lands on the same arm (no mid-session model
  flapping), assignment is stateless (any replica computes it
  identically), and rotating the salt reshuffles the population.
- :func:`rollout_decision` / :class:`RolloutPacer` — the canary pacing
  decision: HOLD until the canary has enough observations AND soak time
  AND is not regressing vs control; PROMOTE when all gates pass;
  ROLLBACK immediately on a hard regression. The pacer is the stateful
  wrapper the serving tier feeds per-request outcomes into.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Optional

CONTROL = "control"
CANARY = "canary"

HOLD = "hold"
PROMOTE = "promote"
ROLLBACK = "rollback"


def assign_arm(session_id: str, canary_fraction: float,
               salt: str = "") -> str:
    """Stable session→arm split. Pure: same (session, fraction, salt) →
    same arm on every replica, every process, every replay."""
    if canary_fraction <= 0.0:
        return CONTROL
    if canary_fraction >= 1.0:
        return CANARY
    h = hashlib.blake2b(f"{salt}:{session_id}".encode(),
                        digest_size=8).digest()
    x = int.from_bytes(h, "little") / float(1 << 64)
    return CANARY if x < canary_fraction else CONTROL


@dataclass(frozen=True)
class RolloutPacingConfig:
    """Gates between "a new version exists" and "every session gets it"."""

    #: canary-arm requests observed before a promote may fire — the gate
    #: the negative-control simulation deliberately mis-tunes
    min_observations: int = 200
    #: canary age (seconds since start_canary) before a promote may fire
    min_soak_s: float = 30.0
    #: control-arm baseline required before the regression comparison is
    #: meaningful; below it the comparison is skipped (small fleets)
    min_control_observations: int = 20
    #: canary error-rate may exceed control's by at most this much for a
    #: promote (soft gate: HOLD while regressing)
    max_regression: float = 0.02
    #: past this excess error rate the canary is rolled back outright
    rollback_regression: float = 0.10


@dataclass
class ArmStats:
    observations: int = 0
    errors: int = 0

    @property
    def error_rate(self) -> float:
        return self.errors / self.observations if self.observations else 0.0


def rollout_decision(now: float, canary_version: Optional[int],
                     canary_started_t: float, canary: ArmStats,
                     control: ArmStats,
                     config: RolloutPacingConfig) -> Dict[str, object]:
    """One pacing decision. Returns ``{"decision", "reason", ...evidence}``
    — plain data, simulator- and WAL-stampable."""
    ev = {
        "canary_version": canary_version,
        "canary_observations": canary.observations,
        "canary_error_rate": round(canary.error_rate, 6),
        "control_observations": control.observations,
        "control_error_rate": round(control.error_rate, 6),
        "soak_s": round(max(0.0, now - canary_started_t), 6),
    }
    if canary_version is None:
        return dict(ev, decision=HOLD, reason="no-canary")
    regression = canary.error_rate - control.error_rate
    ev["regression"] = round(regression, 6)
    baseline_ok = control.observations >= config.min_control_observations
    if baseline_ok and canary.observations >= config.min_observations \
            and regression > config.rollback_regression:
        return dict(ev, decision=ROLLBACK, reason="hard-regression")
    if canary.observations < config.min_observations:
        return dict(ev, decision=HOLD, reason="under-observed")
    if now - canary_started_t < config.min_soak_s:
        return dict(ev, decision=HOLD, reason="soaking")
    if baseline_ok and regression > config.max_regression:
        return dict(ev, decision=HOLD, reason="regressing")
    return dict(ev, decision=PROMOTE, reason="gates-passed")


@dataclass
class RolloutPacer:
    """Stateful wrapper: per-arm outcome windows + the pure decision.

    The serving tier calls :meth:`observe` per completed request and
    :meth:`decide` on its pacing cadence; the simulator drives both from
    a recorded observation stream on a virtual clock. State resets when
    a new canary starts — stale evidence must never bless a different
    version."""

    config: RolloutPacingConfig = field(default_factory=RolloutPacingConfig)
    canary_version: Optional[int] = None
    canary_started_t: float = 0.0
    arms: Dict[str, ArmStats] = field(default_factory=lambda: {
        CONTROL: ArmStats(), CANARY: ArmStats()})

    def start_canary(self, version: int, now: float) -> None:
        self.canary_version = int(version)
        self.canary_started_t = float(now)
        self.arms = {CONTROL: ArmStats(), CANARY: ArmStats()}

    def end_canary(self) -> None:
        self.canary_version = None
        self.arms = {CONTROL: ArmStats(), CANARY: ArmStats()}

    def observe(self, arm: str, ok: bool, n: int = 1) -> None:
        st = self.arms.setdefault(arm, ArmStats())
        st.observations += int(n)
        if not ok:
            st.errors += int(n)

    def decide(self, now: float) -> Dict[str, object]:
        return rollout_decision(
            now, self.canary_version, self.canary_started_t,
            self.arms.get(CANARY, ArmStats()),
            self.arms.get(CONTROL, ArmStats()), self.config)
