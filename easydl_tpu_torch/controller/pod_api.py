"""Pod lifecycle interface + the in-memory fake used by tests and the
simulated-distributed runtime.

The reference operator talks to the real k8s pod API; the framework keeps
that behind :class:`PodApi` so the reconciler is testable against an
in-memory cluster (SURVEY.md §4 item 4: "reconcile logic against an
in-memory k8s API fake") and portable to a real cluster client later.

Phases follow k8s: Pending → Running → Succeeded/Failed (+ Terminating
while a delete is in flight). :class:`InMemoryPodApi` adds the test levers:
``tick()`` advances Pending pods to Running, ``fail()`` injects a crash,
and every mutation lands on an event list the controller can watch.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from easydl_tpu_torch.api.job_spec import ResourceSpec
from easydl_tpu_torch.utils.logging import get_logger

log = get_logger("controller", "pods")

PHASES = ("Pending", "Running", "Succeeded", "Failed", "Terminating")


@dataclass
class Pod:
    name: str
    job: str
    role: str
    resource: ResourceSpec = field(default_factory=ResourceSpec)
    phase: str = "Pending"
    #: name of the pod this one replaces (resource_updation replace-then-retire,
    #: docs/design/elastic-training-operator.md:99-101); "" if none.
    replaces: str = ""
    command: str = ""
    image: str = ""
    created_at: float = field(default_factory=time.time)


class PodApi:
    """The operator's view of the cluster."""

    def create_pod(self, pod: Pod) -> None:
        raise NotImplementedError

    def delete_pod(self, name: str) -> None:
        raise NotImplementedError

    def list_pods(self, job: Optional[str] = None) -> List[Pod]:
        raise NotImplementedError

    def get_pod(self, name: str) -> Optional[Pod]:
        for p in self.list_pods():
            if p.name == name:
                return p
        return None


class InMemoryPodApi(PodApi):
    """Fake cluster: pods are records; deletes are immediate (no grace
    period) unless ``graceful`` — then they linger Terminating until tick."""

    def __init__(self, graceful: bool = False):
        self._pods: Dict[str, Pod] = {}
        self._lock = threading.RLock()
        self._graceful = graceful
        self.events: List[tuple] = []  # (verb, pod_name)
        self._watchers: List[Callable[[str, str], None]] = []

    def _emit(self, verb: str, name: str) -> None:
        self.events.append((verb, name))
        for w in list(self._watchers):
            w(verb, name)

    def watch(self, fn: Callable[[str, str], None]) -> None:
        """Register fn(verb, pod_name); called under the api lock — keep it
        cheap (the controller just pokes its reconcile queue)."""
        self._watchers.append(fn)

    # ----------------------------------------------------------------- PodApi
    def create_pod(self, pod: Pod) -> None:
        with self._lock:
            if pod.name in self._pods:
                raise ValueError(f"pod {pod.name!r} already exists")
            self._pods[pod.name] = pod
            self._emit("create", pod.name)
            log.debug("created pod %s (%s, replaces=%r)", pod.name, pod.role,
                      pod.replaces)

    def delete_pod(self, name: str) -> None:
        with self._lock:
            pod = self._pods.get(name)
            if pod is None:
                return  # idempotent, like k8s delete of a gone pod
            if self._graceful and pod.phase in ("Pending", "Running"):
                pod.phase = "Terminating"
            else:
                del self._pods[name]
            self._emit("delete", name)

    def list_pods(self, job: Optional[str] = None) -> List[Pod]:
        with self._lock:
            pods = [p for p in self._pods.values() if job is None or p.job == job]
            return sorted(pods, key=lambda p: p.name)

    # ------------------------------------------------------------ test levers
    def tick(self) -> None:
        """Advance the fake cluster: Pending → Running, Terminating → gone."""
        with self._lock:
            for name in list(self._pods):
                p = self._pods[name]
                if p.phase == "Pending":
                    p.phase = "Running"
                    self._emit("running", name)
                elif p.phase == "Terminating":
                    del self._pods[name]
                    self._emit("gone", name)

    def fail(self, name: str) -> None:
        """Inject a crash (preemption, OOM): phase → Failed."""
        with self._lock:
            if name in self._pods:
                self._pods[name].phase = "Failed"
                self._emit("failed", name)

    def set_phase(self, name: str, phase: str) -> None:
        assert phase in PHASES, phase
        with self._lock:
            if name in self._pods:
                self._pods[name].phase = phase
                self._emit(phase.lower(), name)
