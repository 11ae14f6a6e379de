"""The elastic operator: watches job/plan resources, reconciles pods.

Control flow mirrors the reference's figure steps 1-6
(docs/design/elastic-training-operator.md:20-22,47-55):

1. user submits an ElasticJob (``CrStore.submit_job``);
2-3. controller sees the create event and launches the **trainer pod only**
   (:47-48 "the controller only creates a trainer Pod");
4. the trainer (or an advanced user, :50-55) applies a JobResource
   (``CrStore.apply_plan``);
5-6. controller reconciles worker/PS/evaluator pods against the plan —
   create/delete/replace decisions come from the native reconcile core
   (easydl_tpu_torch/controller/reconciler.py).

The CrStore stands in for the k8s API server as the event bus (SURVEY.md
"Cross-cutting" note); the PodApi stands in for kubelet. Both are interfaces
so the same controller logic drives the in-memory fake (tests, simulation)
or a real cluster.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from easydl_tpu_torch.api.job_spec import JobSpec, ResourceSpec, SchedulingSpec
from easydl_tpu_torch.api.resource_plan import ResourcePlan
from easydl_tpu_torch.brain.arbiter import (
    ArbiterConfig,
    GlobalChipArbiter,
    JobClaim,
)
from easydl_tpu_torch.controller.pod_api import Pod, PodApi
from easydl_tpu_torch.controller.reconciler import (
    _trailing_index,
    reconcile,
    resource_sig,
)
from easydl_tpu_torch.obs import get_registry, start_exporter
from easydl_tpu_torch.utils.logging import get_logger

log = get_logger("controller", "operator")


class StalePlanError(ValueError):
    """A plan write with version <= the currently applied one."""


#: ElasticJob phases a job can never leave (k8s Job semantics). The trainer
#: pod is the in-job authority on completion — it exits 0 once the master
#: reports the job done — so the operator latches the job terminal on trainer
#: exit and stops reconciling pods into existence
#: (docs/design/elastic-training-operator.md:47-55: the operator owns the pod
#: lifecycle, which includes ENDING it; README.md:12).
TERMINAL_PHASES = ("Succeeded", "Failed")


class CrStore:
    """In-memory custom-resource store with a watch queue — the event bus the
    reference routes all control flow through."""

    def __init__(self):
        self._jobs: Dict[str, JobSpec] = {}
        self._plans: Dict[str, ResourcePlan] = {}
        self._statuses: Dict[str, dict] = {}
        self._status_dirty: Set[str] = set()  # sink write failed; retry
        self._status_sinks: List[Callable[[str, dict], None]] = []
        self._lock = threading.Lock()
        self._events: "queue.Queue[tuple]" = queue.Queue()
        # Status sinks (the k8s /status PATCH) run on a dedicated dispatch
        # thread, NOT inline in set_status: set_status is called from the
        # reconcile loop, and a slow API server must stall the write-back,
        # never reconciliation itself. Pending writes coalesce per job —
        # only the latest status document is worth PATCHing.
        self._sink_cond = threading.Condition(self._lock)
        self._sink_pending: Dict[str, dict] = {}
        self._sink_inflight = 0
        self._sink_thread: Optional[threading.Thread] = None
        self._closed = False

    def submit_job(self, job: JobSpec) -> None:
        job.validate()
        with self._lock:
            if job.name in self._jobs:
                raise ValueError(f"job {job.name!r} already exists")
            self._jobs[job.name] = job
        self._events.put(("job_added", job.name))

    def delete_job(self, name: str) -> None:
        with self._lock:
            self._jobs.pop(name, None)
            self._plans.pop(name, None)
            self._statuses.pop(name, None)
            self._status_dirty.discard(name)
            self._sink_pending.pop(name, None)
            # Wake flush_status waiters: the pending set may just have
            # drained to empty.
            self._sink_cond.notify_all()
        self._events.put(("job_deleted", name))

    def apply_plan(self, plan: ResourcePlan) -> None:
        """Create-or-update keyed by the plan's job binding; stale versions
        (≤ current) are rejected so late writers can't roll the plan back."""
        plan.validate()
        with self._lock:
            if plan.job_name not in self._jobs:
                raise KeyError(f"no such job {plan.job_name!r}")
            cur = self._plans.get(plan.job_name)
            if cur is not None and plan.version <= cur.version:
                raise StalePlanError(
                    f"stale plan version {plan.version} <= {cur.version}"
                )
            self._plans[plan.job_name] = plan
        self._events.put(("plan_applied", plan.job_name))

    def set_status(self, job_name: str, status: Optional[dict]) -> bool:
        """Record ElasticJob.status. Terminal phases latch: once a job is
        Succeeded/Failed, a later write can never move it back to a live
        phase (or flip it to the other terminal one) — only refresh details
        under the same phase (e.g. role counts after completion GC). Returns
        True when the stored status changed; registered sinks (the k8s
        status write-back) fire on change — asynchronously, on the sink
        dispatch thread, so a slow API server can't stall the reconcile
        loop — and a sink failure marks the status dirty so the next
        identical write retries the sink (the operator's periodic resync
        re-issues statuses, so retry happens within one resync period)."""
        if not status:
            return False
        with self._lock:
            cur = self._statuses.get(job_name)
            if (cur is not None and cur.get("phase") in TERMINAL_PHASES
                    and status.get("phase") != cur.get("phase")):
                return False
            changed = cur != status
            if not changed and job_name not in self._status_dirty:
                return False
            self._statuses[job_name] = dict(status)
            self._status_dirty.discard(job_name)
            if self._status_sinks:
                self._sink_pending[job_name] = dict(status)
                self._sink_cond.notify_all()
        return changed

    def _sink_loop(self) -> None:
        while True:
            with self._lock:
                while not self._sink_pending and not self._closed:
                    self._sink_cond.wait()
                if self._closed and not self._sink_pending:
                    return
                job_name = next(iter(self._sink_pending))
                status = self._sink_pending.pop(job_name)
                sinks = list(self._status_sinks)
                self._sink_inflight += 1
            ok = True
            for fn in sinks:
                try:
                    fn(job_name, dict(status))
                except Exception:
                    ok = False
                    log.exception("status sink failed for %s", job_name)
            with self._lock:
                # Re-mark dirty only while the job still exists: a sink
                # failing against a just-deleted job (404 on the deleted CR)
                # must not leak a permanent dirty entry.
                if not ok and job_name in self._statuses:
                    self._status_dirty.add(job_name)
                self._sink_inflight -= 1
                self._sink_cond.notify_all()

    def flush_status(self, timeout: float = 10.0) -> bool:
        """Block until every pending status write has been dispatched (or
        ``timeout`` elapses). Returns True when drained — tests and orderly
        shutdown use this; the reconcile loop never needs to."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._sink_pending or self._sink_inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._sink_cond.wait(timeout=remaining)
        return True

    def close(self) -> None:
        """Stop the sink dispatcher after draining pending writes."""
        with self._lock:
            self._closed = True
            self._sink_cond.notify_all()
        t = self._sink_thread
        if t is not None:
            t.join(timeout=10.0)

    def job_status(self, job_name: str) -> Optional[dict]:
        with self._lock:
            s = self._statuses.get(job_name)
            return dict(s) if s is not None else None

    def add_status_sink(self, fn: Callable[[str, dict], None]) -> None:
        """fn(job_name, status) is called on every status change — the k8s
        deployment hooks the API-server write-back here. Calls happen on
        the sink dispatch thread (started lazily on the first sink), never
        inline in set_status."""
        with self._lock:
            self._status_sinks.append(fn)
            if self._sink_thread is None:
                self._sink_thread = threading.Thread(
                    target=self._sink_loop, daemon=True, name="status-sinks"
                )
                self._sink_thread.start()

    def job(self, name: str) -> Optional[JobSpec]:
        with self._lock:
            return self._jobs.get(name)

    def plan(self, job_name: str) -> Optional[ResourcePlan]:
        with self._lock:
            return self._plans.get(job_name)

    def jobs(self) -> List[str]:
        with self._lock:
            return sorted(self._jobs)

    def next_event(self, timeout: Optional[float] = None):
        try:
            return self._events.get(timeout=timeout)
        except queue.Empty:
            return None

    def poke(self, job_name: str) -> None:
        """External nudge (pod event, resync timer) → reconcile this job."""
        self._events.put(("poke", job_name))


@dataclass
class JobStatus:
    job: str
    trainer_created: bool = False
    pods: Dict[str, int] = field(default_factory=dict)  # role -> live count
    last_ops: List[str] = field(default_factory=list)
    phase: str = ""  # Pending | Running | Succeeded | Failed


class ElasticJobController:
    """The reconcile loop. Run :meth:`step` manually (tests/simulation) or
    :meth:`start` a background thread that drains store events."""

    def __init__(self, store: CrStore, pod_api: PodApi,
                 force_python_core: bool = False,
                 restart_backoff_base: float = 0.5,
                 restart_backoff_max: float = 30.0,
                 restart_backoff_reset: float = 60.0,
                 trainer_backoff_limit: Optional[int] = None,
                 gc_on_completion: bool = True,
                 evaluator_gc_grace_s: float = 300.0,
                 chip_budget: Optional[int] = None,
                 arbiter_config: Optional[ArbiterConfig] = None):
        self.store = store
        self.pods = pod_api
        self._force_py = force_python_core
        # Multi-tenant chip arbitration: with a chip_budget,
        # worker replicas are no longer each plan's private ask — the
        # global arbiter (brain/arbiter.py) levels every job's worker
        # count against the shared supply by CR priority/min/max, and a
        # higher-priority scale-up preempts a lower-priority job's pods
        # (scale_down DELETE → SIGTERM → the agent's preempt-notice
        # drain), paced by the arbiter's hold-down. None = the classic
        # single-tenant behavior, untouched.
        self._chip_budget = chip_budget
        self._arbiter = (GlobalChipArbiter(arbiter_config)
                         if chip_budget is not None else None)
        # One arbitration per SWEEP, not per job: building claims lists
        # every job's pods, so deciding inside each per-job reconcile
        # would cost O(jobs^2) pod listings per sweep — and a single
        # decision leveling every job from one consistent snapshot is
        # also the correct semantics. Cached briefly; the level-triggered
        # resync re-decides as pod counts converge.
        # (expires_at, demand fingerprint, allocations): the fingerprint
        # — every job's applied plan version — invalidates instantly on
        # any plan change (a fresh scale-up must never wait out the TTL),
        # while the TTL bounds pod-count staleness between resyncs.
        self._arb_cache: Tuple[float, tuple, Dict[str, int]] = (0.0, (), {})
        # k8s Job backoffLimit analogue: None = restart the trainer forever
        # (reference elasticity semantics); an int latches the job Failed
        # after that many CONSECUTIVE trainer failures.
        self._trainer_backoff_limit = trainer_backoff_limit
        # Terminal jobs GC their still-live pods (a PS pod never exits on
        # its own); terminal-phase pods are retained for logs. The evaluator
        # DOES exit on its own — once it has evaluated the final committed
        # checkpoint after the DONE marker — so it gets a grace window
        # before GC: killing it at the latch instant would lose the
        # final-step evaluation it exists to produce. The window is sized
        # generously (a final large-checkpoint restore + eval can take
        # minutes): the only cost of a long grace is that a WEDGED
        # evaluator lingers that long on an already-finished job before
        # being reaped. (The operator deliberately cannot observe
        # eval.jsonl/DONE — workdir internals belong to the job, not the
        # control plane — so a timer, not a completion signal, is the
        # boundary-respecting mechanism.)
        self._gc_on_completion = gc_on_completion
        self._evaluator_gc_grace_s = evaluator_gc_grace_s
        self._terminal_since: Dict[str, float] = {}  # job -> latch monotonic
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._drift_warned: set = set()  # (job, pod, sig) already reported
        # Crash-loop backoff: hot-respawning a Failed pod every reconcile
        # pass starves a loaded machine (a lifecycle flake under load). Pod
        # failures back replacement creates off exponentially per
        # (job, role); a quiet restart_backoff_reset window forgives.
        self._bo_base = restart_backoff_base
        self._bo_max = restart_backoff_max
        self._bo_reset = restart_backoff_reset
        # (job, role) -> (consecutive failures, last failure t, next create t)
        self._backoff: Dict[Tuple[str, str], Tuple[int, float, float]] = {}
        # Telemetry: reconcile-loop health — pass counts/durations and the
        # pod-op mix. A stalled or thrashing reconciler shows up here long
        # before pods visibly misbehave.
        reg = get_registry()
        self._exporter = None
        self._m_reconciles = reg.counter(
            "easydl_controller_reconcile_total", "Reconcile passes, by job.",
            ("job",))
        self._m_reconcile_seconds = reg.histogram(
            "easydl_controller_reconcile_seconds", "Wall time of one "
            "reconcile pass.", ("job",),
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5))
        self._m_pod_ops = reg.counter(
            "easydl_controller_pod_ops_total", "Pod operations issued, by "
            "verb.", ("job", "verb"))
        self._m_jobs = reg.gauge(
            "easydl_controller_jobs", "Jobs currently in the store.")

    # -------------------------------------------------------------- backoff
    def _note_failure(self, job: str, role: str) -> None:
        now = time.monotonic()
        count, last, _ = self._backoff.get((job, role), (0, 0.0, 0.0))
        count = 1 if now - last > self._bo_reset else count + 1
        # First failure recovers instantly (post-preemption recovery time is
        # a headline metric); only a crash LOOP backs off.
        delay = (
            0.0 if count == 1
            else min(self._bo_max, self._bo_base * (2 ** (count - 2)))
        )
        self._backoff[(job, role)] = (count, now, now + delay)
        if count > 1:
            log.warning(
                "%s/%s: %d consecutive pod failures; backing off creates %.1fs",
                job, role, count, delay,
            )

    def _create_deferred(self, job: str, role: str) -> bool:
        """True while replacement creates for this role should wait (the
        level-triggered resync retries them once the backoff expires)."""
        entry = self._backoff.get((job, role))
        return entry is not None and time.monotonic() < entry[2]

    # ---------------------------------------------------- chip arbitration
    def _arbitrated_workers(self, job_name: str) -> Optional[int]:
        """One global arbitration round over every live job's claim;
        returns ``job_name``'s post-move worker allocation (None when the
        job has no claim — e.g. no plan yet). Every job's claim is built
        from its CR scheduling block + its plan's worker ask + its LIVE
        pod count, so the same decision levels every tenant consistently
        no matter which job's event triggered this pass."""
        fingerprint = tuple(sorted(
            (jn, getattr(self.store.plan(jn), "version", -1))
            for jn in self.store.jobs()
        ))
        expires, key, cached = self._arb_cache
        if time.monotonic() < expires and key == fingerprint:
            return cached.get(job_name)
        claims = []
        for jn in self.store.jobs():
            job = self.store.job(jn)
            plan = self.store.plan(jn)
            if job is None or plan is None or "worker" not in plan.roles:
                continue
            status = self.store.job_status(jn) or {}
            if status.get("phase") in TERMINAL_PHASES:
                continue  # a finished job holds no chips
            sched = job.scheduling or SchedulingSpec()
            demand = plan.replicas("worker")
            allocated = sum(
                1 for p in self.pods.list_pods(jn)
                if p.role == "worker" and p.phase in ("Pending", "Running")
            )
            claims.append(JobClaim(
                name=jn, priority=sched.priority,
                min_chips=sched.min_replicas,
                # maxReplicas 0 = uncapped: the envelope must not clamp
                # the ask below what the plan demands
                max_chips=(sched.max_replicas
                           or max(demand, sched.min_replicas)),
                demand=demand, allocated=allocated,
            ))
        if not any(c.name == job_name for c in claims):
            return None
        decision = self._arbiter.decide(claims, self._chip_budget,
                                        time.monotonic())
        # The operator is long-lived; the decision log is for forensics,
        # not unbounded growth.
        del self._arbiter.log[:-256]
        allocations = {str(k): int(v)
                       for k, v in decision["allocations"].items()}
        self._arb_cache = (time.monotonic() + 0.5, fingerprint, allocations)
        return allocations.get(job_name)

    # ------------------------------------------------------------- reconcile
    def reconcile_job(self, job_name: str) -> JobStatus:
        """One level-triggered pass for one job; idempotent."""
        t0 = time.perf_counter()
        status = self._reconcile_job(job_name)
        self._m_reconciles.inc(job=job_name)
        self._m_reconcile_seconds.observe(time.perf_counter() - t0,
                                          job=job_name)
        for op in status.last_ops:
            verb = op.split(" ", 1)[0]
            if verb in ("CREATE", "DELETE"):
                self._m_pod_ops.inc(job=job_name, verb=verb)
        self._m_jobs.set(len(self.store.jobs()))
        return status

    def _reconcile_job(self, job_name: str) -> JobStatus:
        status = JobStatus(job=job_name)
        job = self.store.job(job_name)
        observed = self.pods.list_pods(job_name)
        if job is None:
            # Job deleted: tear down whatever remains.
            for p in observed:
                self.pods.delete_pod(p.name)
                status.last_ops.append(f"DELETE {p.name} (job gone)")
            self._drift_warned = {
                w for w in self._drift_warned if w[0] != job_name
            }
            self._backoff = {
                k: v for k, v in self._backoff.items() if k[0] != job_name
            }
            self._terminal_since.pop(job_name, None)
            return status

        # Terminal latch: the trainer exits 0 exactly when the master reports
        # the job complete, so a Succeeded trainer pod ends the job — for
        # good. A previously latched status (in-memory, or re-learned from
        # ElasticJob.status after an operator restart) keeps the latch even
        # if the trainer pod record is later GC'd externally.
        prior = self.store.job_status(job_name) or {}
        phase = prior.get("phase", "")
        message = ""
        if phase not in TERMINAL_PHASES:
            if any(p.role == "trainer" and p.phase == "Succeeded"
                   for p in observed):
                phase = "Succeeded"
                message = "trainer completed"

        # Figure step 3: trainer pod first, before any plan exists. The
        # trainer is operator-owned: a Failed trainer is retired and replaced
        # under a fresh name (names are never reused), independent of any plan.
        trainer_pods = [p for p in observed if p.role == "trainer"]
        if phase not in TERMINAL_PHASES:
            for p in trainer_pods:
                if p.phase == "Failed":
                    self.pods.delete_pod(p.name)
                    status.last_ops.append(f"DELETE {p.name} (failed)")
                    self._note_failure(job_name, "trainer")
            # The deletions above may not be reflected in `observed` (it
            # predates them when the recreate is backoff-deferred); strip the
            # handled Failed trainers so the plan reconcile below doesn't
            # re-DELETE them and double-count the failure toward the limit.
            observed = [
                p for p in observed
                if not (p.role == "trainer" and p.phase == "Failed")
            ]
            limit = self._trainer_backoff_limit
            if limit is not None:
                fails = self._backoff.get((job_name, "trainer"), (0, 0, 0))[0]
                if fails > limit:
                    phase = "Failed"
                    message = (f"trainer exceeded restart limit "
                               f"({fails} consecutive failures > {limit})")

        if phase in TERMINAL_PHASES:
            # The job is over: create nothing, level nothing. Still-live pods
            # will never finish on their own (a parameter server serves until
            # told to stop) — GC them; terminal pods are retained for logs.
            # Exception: a Running evaluator is finishing its final-step
            # evaluation and exits 0 by itself — give it a grace window.
            gc_deleted = False
            now = time.monotonic()
            latch_t = self._terminal_since.setdefault(job_name, now)
            if self._gc_on_completion:
                for p in observed:
                    if p.phase in ("Pending", "Running"):
                        if (p.role == "evaluator"
                                and now - latch_t < self._evaluator_gc_grace_s):
                            continue
                        self.pods.delete_pod(p.name)
                        gc_deleted = True
                        status.last_ops.append(
                            f"DELETE {p.name} (job {phase.lower()})"
                        )
            self._write_status(
                job_name, phase, message,
                self.pods.list_pods(job_name) if gc_deleted else observed,
            )
            status.phase = phase
            if status.last_ops:
                log.info("reconciled %s (%s): %s", job_name, phase,
                         "; ".join(status.last_ops))
            return status

        if self._create_deferred(job_name, "trainer"):
            pass  # crash-looping trainer: let the backoff window elapse
        elif not any(p.phase in ("Pending", "Running") for p in trainer_pods):
            indices = [_trailing_index(p.name) for p in trainer_pods]
            name = f"{job_name}-trainer-{max(indices, default=-1) + 1}"
            self.pods.create_pod(
                Pod(
                    name=name, job=job_name, role="trainer",
                    # ElasticJob carries no resources (README.md:19-23); the
                    # trainer pod starts with defaults and can be vertically
                    # scaled later via resource_updation.
                    resource=ResourceSpec(),
                    command=job.role_command("trainer"),
                    image=job.role_image("trainer"),
                )
            )
            status.last_ops.append(f"CREATE {name}")
            status.trainer_created = True
            observed = self.pods.list_pods(job_name)

        plan = self.store.plan(job_name)
        if plan is not None:
            # Trainer pods are operator-owned (created above); the plan
            # governs them only via resource_updation, never replica
            # levelling, so strip any trainer role block before diffing (the
            # core itself exempts "trainer" from absent-role scale-down).
            plan_for_diff = plan
            if "trainer" in plan.roles:
                roles = {r: rp for r, rp in plan.roles.items() if r != "trainer"}
                plan_for_diff = ResourcePlan(
                    name=plan.name, job_name=plan.job_name, roles=roles,
                    resource_updation=plan.resource_updation, version=plan.version,
                )
            if self._arbiter is not None and "worker" in plan_for_diff.roles:
                workers = self._arbitrated_workers(job_name)
                if workers is not None \
                        and workers != plan_for_diff.replicas("worker"):
                    log.info(
                        "%s: chip arbitration levels workers %d -> %d "
                        "(budget %s)", job_name,
                        plan_for_diff.replicas("worker"), workers,
                        self._chip_budget,
                    )
                    plan_for_diff = plan_for_diff.with_role("worker", workers)
            ops, sigs = reconcile(
                job_name, plan_for_diff, observed, force_python=self._force_py
            )
            self._warn_resource_drift(job_name, plan_for_diff, observed)
            role_of = {p.name: p.role for p in observed}
            for op in ops:
                if op.verb == "CREATE":
                    if self._create_deferred(job_name, op.role):
                        continue  # crash-loop backoff; resync retries
                    self.pods.create_pod(
                        Pod(
                            name=op.name, job=job_name, role=op.role,
                            resource=sigs.get(op.resource_sig, ResourceSpec()),
                            replaces=op.replaces,
                            command=job.role_command(op.role),
                            image=job.role_image(op.role),
                        )
                    )
                else:
                    self.pods.delete_pod(op.name)
                    if op.reason == "failed":
                        self._note_failure(job_name, role_of.get(op.name, ""))
                status.last_ops.append(f"{op.verb} {op.name}"
                                       + (f" ({op.reason})" if op.reason else ""))

        final = self.pods.list_pods(job_name)
        for p in final:
            if p.phase in ("Pending", "Running"):
                status.pods[p.role] = status.pods.get(p.role, 0) + 1
        status.phase = (
            "Running"
            if any(p.role == "trainer" and p.phase == "Running" for p in final)
            else "Pending"
        )
        self._write_status(job_name, status.phase, "", final)
        if status.last_ops:
            log.info("reconciled %s: %s", job_name, "; ".join(status.last_ops))
        return status

    def _write_status(self, job_name: str, phase: str, message: str,
                      pods: List[Pod]) -> None:
        """Build the ElasticJob.status document from the caller's pod list
        and store it (CrStore latches terminal phases and fans out to sinks —
        the k8s deployment PATCHes the /status subresource from there)."""
        roles: Dict[str, Dict[str, int]] = {}
        for p in pods:
            rc = roles.setdefault(
                p.role, {"active": 0, "succeeded": 0, "failed": 0}
            )
            if p.phase in ("Pending", "Running"):
                rc["active"] += 1
            elif p.phase == "Succeeded":
                rc["succeeded"] += 1
            elif p.phase == "Failed":
                rc["failed"] += 1
        doc: dict = {"phase": phase, "roles": roles}
        prior = self.store.job_status(job_name) or {}
        msg = message or prior.get("message", "")
        if msg:
            doc["message"] = msg
        if phase in TERMINAL_PHASES:
            doc["completionTime"] = prior.get("completionTime") or time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            )
        self.store.set_status(job_name, doc)

    def _warn_resource_drift(self, job_name: str, plan: ResourcePlan,
                             observed) -> None:
        """Existing pods are never resized by a role-resource edit (reference
        semantics: vertical scaling is explicit resource_updation,
        docs/design/elastic-training-operator.md:86-101) — surface the drift
        so the user knows to issue one."""
        warned = self._drift_warned
        for role, rp in plan.roles.items():
            want_sig = resource_sig(rp.resource)
            for p in observed:
                if (p.role == role and p.phase in ("Pending", "Running")
                        and not p.replaces
                        and resource_sig(p.resource) != want_sig
                        and (job_name, p.name, want_sig) not in warned):
                    warned.add((job_name, p.name, want_sig))
                    log.warning(
                        "%s: pod %s resources differ from plan role %r; "
                        "existing pods are not auto-resized — add a "
                        "resource_updation entry to replace it",
                        job_name, p.name, role,
                    )

    def step(self, timeout: float = 0.0) -> Optional[JobStatus]:
        """Process one store event (or return None on timeout)."""
        ev = self.store.next_event(timeout=timeout)
        if ev is None:
            return None
        kind, job_name = ev
        return self.reconcile_job(job_name)

    def reconcile_all(self) -> Dict[str, JobStatus]:
        return {j: self.reconcile_job(j) for j in self.store.jobs()}

    # ------------------------------------------------------------ background
    def start(self, resync_s: float = 2.0,
              obs_workdir: Optional[str] = None) -> None:
        self._exporter = start_exporter(
            "controller", workdir=obs_workdir,
            health_fn=lambda: {"jobs": len(self.store.jobs())},
        )

        def loop():
            while not self._stop.is_set():
                ev = self.store.next_event(timeout=resync_s)
                if ev is not None:
                    try:
                        self.reconcile_job(ev[1])
                    except Exception:  # keep the loop alive; next pass retries
                        log.exception("reconcile failed for %s", ev[1])
                else:
                    for j in self.store.jobs():
                        try:
                            self.reconcile_job(j)
                        except Exception:
                            log.exception("resync failed for %s", j)

        self._thread = threading.Thread(target=loop, daemon=True, name="operator")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None
