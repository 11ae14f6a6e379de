"""TenantFleet: live actuation of the global chip arbiter over N
ElasticJob masters sharing one agent pool (ROADMAP item 5).

The operator-level integration (controller/operator.py ``chip_budget``)
levels POD replicas; this module is the in-process twin the multi-tenant
chaos drill runs — the same :class:`~easydl_tpu_torch.brain.arbiter.
GlobalChipArbiter` decisions actuated over real :class:`Master`/
:class:`Agent` objects, with the property the drill asserts: **a
preempted chip always drains before it is killed.**

Actuation of one preemption (the only non-trivial move):

1. pick the donor job's victim agent — its current MEMBER, i.e. the host
   whose chip the arbiter is reclaiming (cloud semantics: you lose a
   specific VM, and your standby takes over);
2. deliver the preempt notice (:meth:`Agent.notify_preemption` — the very
   hook a GCE maintenance notice / SIGTERM lands on), which makes the
   victim's master run the PLANNED preempt drain: quiesce at a step
   boundary, checkpoint, reshape the survivors;
3. only after the worker provably exited (or the escalation timeout — a
   recorded failure, never a silent one) stop the agent and record the
   "kill" mark;
4. hand the freed chip to the receiver: a fresh agent registered to the
   winner's master (it joins as member or standby per that master's own
   rendezvous).

Free-pool grants skip 1-3. The fleet keeps the arbiter's full decision
log plus drill-relative allocation samples and per-move drain marks —
exactly the evidence shape ``sim/multijob.check_tenants`` judges and
``brain.arbiter.replay_decision_log`` byte-verifies offline.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from easydl_tpu_torch.brain.arbiter import (
    ArbiterConfig,
    GlobalChipArbiter,
    JobClaim,
)
from easydl_tpu_torch.obs.errors import count_swallowed
from easydl_tpu_torch.utils.logging import get_logger

log = get_logger("controller", "fleet")


@dataclass
class TenantJob:
    """One ElasticJob's standing in the fleet."""

    name: str
    master: Any  # elastic.master.Master
    workdir: str
    priority: int = 0
    min_chips: int = 0
    max_chips: int = 1
    demand: int = 0
    #: agent_id -> live Agent (the job's chips)
    agents: Dict[str, Any] = field(default_factory=dict)
    spawned: int = 0
    #: [[t_rel, demand], ...] — the demand timeline the offline checks
    #: replay (scale-ups land here via TenantFleet.set_demand)
    demand_history: List[List[float]] = field(default_factory=list)


@dataclass
class _PendingDrain:
    """A preemption mid-flight: notice delivered, waiting for the drain."""

    donor: str
    agent_id: str
    to_job: str  # "" = reclaim to the free pool
    t_notice: float = 0.0
    deadline: float = 0.0


class TenantFleet:
    """Single-threaded control loop state machine: call :meth:`tick`
    periodically (the drill runs it on a 0.25s cadence). Not thread-safe
    by design — one ticker owns it, like the operator's reconcile loop."""

    def __init__(self, total_chips: int,
                 agent_factory: Callable[[str, Any, "TenantJob"], Any],
                 config: Optional[ArbiterConfig] = None,
                 drain_timeout_s: float = 30.0,
                 epoch: Optional[float] = None):
        #: agent_factory(agent_id, master, job) -> STARTED Agent
        self.total_chips = int(total_chips)
        self.agent_factory = agent_factory
        self.arbiter = GlobalChipArbiter(config)
        self.drain_timeout_s = drain_timeout_s
        self.jobs: Dict[str, TenantJob] = {}
        self._pending: List[_PendingDrain] = []
        #: evidence (drill-relative seconds against ``epoch``)
        self.epoch = time.monotonic() if epoch is None else epoch
        self.allocation_samples: List[Dict[str, Any]] = []
        self.moves: List[Dict[str, Any]] = []
        self.preempt_drains: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- plumbing
    def _rel(self, t: float) -> float:
        return round(t - self.epoch, 6)

    def add_job(self, job: TenantJob) -> None:
        if job.name in self.jobs:
            raise ValueError(f"job {job.name!r} already in the fleet")
        job.demand_history = [[0.0, int(job.demand)]]
        self.jobs[job.name] = job

    def set_demand(self, name: str, chips: int) -> None:
        log.info("fleet: job %s demand -> %d", name, chips)
        job = self.jobs[name]
        job.demand = int(chips)
        job.demand_history.append(
            [self._rel(time.monotonic()), int(chips)])

    def allocations(self) -> Dict[str, int]:
        return {name: len(j.agents) for name, j in sorted(self.jobs.items())}

    def _spawn_agent(self, job: TenantJob) -> str:
        job.spawned += 1
        aid = f"{job.name}-a{job.spawned}"
        job.agents[aid] = self.agent_factory(aid, job.master, job)
        log.info("fleet: spawned agent %s for job %s (now %d chips)",
                 aid, job.name, len(job.agents))
        return aid

    def _victim_agent(self, job: TenantJob) -> Optional[str]:
        """The MEMBER first (the chip being reclaimed is its host — the
        drain path is the point); deterministic standby fallback when the
        job has no member (mid-reshape). Agents already mid-drain are
        excluded: two preemptions from one donor in a single decision
        (max_preemptions >= 2) must take two DIFFERENT hosts — re-picking
        the pending victim would queue a second drain for one agent,
        record a drain that never happened, and grant a phantom chip."""
        draining = {d.agent_id for d in self._pending if d.donor == job.name}
        try:
            members = list(job.master.status().get("members", []))
        except Exception as e:
            count_swallowed("fleet.victim_status", e)
            members = []
        for m in members:
            if m in job.agents and m not in draining:
                return m
        candidates = sorted(set(job.agents) - draining)
        return candidates[0] if candidates else None

    def _drained(self, job: TenantJob, aid: str) -> bool:
        """True once the victim's worker has provably exited AND its
        master no longer counts it a member — drain complete."""
        agent = job.agents.get(aid)
        if agent is None:
            return True
        if agent.worker_pid is not None:
            return False
        try:
            return aid not in job.master.status().get("members", [])
        except Exception as e:
            count_swallowed("fleet.drain_status", e)
            return False

    # ------------------------------------------------------------- the tick
    def tick(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Advance pending drains; when none are in flight, run one
        arbitration round and actuate it. Returns the decision made this
        tick (None while drains are pending or nothing changed)."""
        now = time.monotonic() if now is None else now
        self._advance_drains(now)
        if self._pending:
            # Chips mid-drain are owned by NOBODY the claims can see;
            # deciding now would let the free-pool math re-grant them.
            # Drains are seconds; arbitration is paced anyway.
            self._sample(now)
            return None
        decision = self.arbiter.decide(self._claims(), self.total_chips, now)
        for g in decision["grants"]:
            job = self.jobs[str(g["to"])]
            for _ in range(int(g["chips"])):
                self._spawn_agent(job)
            self.moves.append({"t": self._rel(now), "from": "",
                               "to": job.name, "chips": int(g["chips"])})
        for p in decision["preemptions"]:
            self._begin_drain(str(p["from"]), str(p["to"]), now)
        for r in decision.get("reclaims", []):
            # Overcommit shed — cannot arise under this fleet's
            # drain-then-grant ordering, handled for completeness.
            self._begin_drain(str(r["from"]), "", now)
        self._sample(now)
        return decision

    def _claims(self) -> List[JobClaim]:
        return [
            JobClaim(
                name=j.name, priority=j.priority, min_chips=j.min_chips,
                max_chips=j.max_chips, demand=j.demand,
                allocated=len(j.agents),
            )
            for j in self.jobs.values()
        ]

    def _begin_drain(self, donor: str, to_job: str, now: float) -> None:
        job = self.jobs[donor]
        aid = self._victim_agent(job)
        if aid is None:
            log.warning("fleet: preemption from %s found no agent", donor)
            return
        agent = job.agents[aid]
        agent.notify_preemption()
        self._pending.append(_PendingDrain(
            donor=donor, agent_id=aid, to_job=to_job, t_notice=now,
            deadline=now + self.drain_timeout_s,
        ))
        log.info("fleet: preempt notice -> %s/%s (chip destined for %s)",
                 donor, aid, to_job or "<free>")

    def _advance_drains(self, now: float) -> None:
        still: List[_PendingDrain] = []
        for d in self._pending:
            job = self.jobs[d.donor]
            drained = self._drained(job, d.agent_id)
            escalated = not drained and now >= d.deadline
            if not drained and not escalated:
                still.append(d)
                continue
            agent = job.agents.pop(d.agent_id, None)
            worker_alive = (agent is not None
                            and agent.worker_pid is not None)
            if agent is not None:
                agent.stop()  # the "kill": after the drain, by contract
            mark = {
                "job": d.donor, "agent": d.agent_id,
                "to_job": d.to_job,
                "t_notice": self._rel(d.t_notice),
                "t_stop": self._rel(now),
                "worker_alive_at_stop": bool(worker_alive),
                "escalated": bool(escalated),
            }
            self.preempt_drains.append(mark)
            self.moves.append({"t": self._rel(now), "from": d.donor,
                               "to": d.to_job, "chips": 1})
            log.info("fleet: drain of %s/%s complete (escalated=%s); "
                     "chip -> %s", d.donor, d.agent_id, escalated,
                     d.to_job or "<free>")
            if d.to_job:
                self._spawn_agent(self.jobs[d.to_job])
        self._pending = still

    def _sample(self, now: float) -> None:
        alloc = self.allocations()
        if (self.allocation_samples
                and self.allocation_samples[-1]["allocations"] == alloc
                and now - self.epoch
                - self.allocation_samples[-1]["t"] < 1.0):
            return  # bound growth: only changes + a 1 Hz heartbeat
        self.allocation_samples.append(
            {"t": self._rel(now), "allocations": alloc})

    # ------------------------------------------------------------- teardown
    def stop(self) -> None:
        for j in self.jobs.values():
            for agent in j.agents.values():
                try:
                    agent.stop()
                except Exception:
                    log.exception("fleet: agent stop failed")
            j.agents.clear()

    # --------------------------------------------------------- evidence doc
    def evidence(self) -> Dict[str, Any]:
        """The check-ready document: profile + decision log + samples +
        moves + drain marks (``sim/multijob.check_tenants`` judges it; the
        decision log byte-replays through the pure arbiter)."""
        return {
            "profile": {
                "total_chips": self.total_chips,
                "config": self.arbiter.config.to_dict(),
                "jobs": [
                    {"name": j.name, "priority": j.priority,
                     "min_chips": j.min_chips, "max_chips": j.max_chips,
                     "demand": [list(d) for d in j.demand_history]}
                    for j in sorted(self.jobs.values(),
                                    key=lambda j: j.name)
                ],
            },
            "decision_log": list(self.arbiter.log),
            "moves": list(self.moves),
            "allocation_samples": list(self.allocation_samples),
            "preempt_drains": list(self.preempt_drains),
            "final_allocations": self.allocations(),
        }


def run_fleet_loop(fleet: TenantFleet, stop: threading.Event,
                   interval_s: float = 0.25) -> threading.Thread:
    """Background ticker (the drill's control loop)."""
    def loop():
        while not stop.is_set():
            try:
                fleet.tick()
            except Exception:
                log.exception("fleet tick failed")
            stop.wait(interval_s)

    t = threading.Thread(target=loop, daemon=True, name="tenant-fleet")
    t.start()
    return t
