"""Process-backed pod API: each "pod" is a real OS process on this machine.

The single-machine realisation of the reference's kubelet layer — the same
:class:`~easydl_tpu_torch.controller.pod_api.PodApi` interface the reconciler
drives against k8s or the in-memory fake, but ``create_pod`` actually
launches the pod's command as a subprocess. This is what makes the full
reference lifecycle (figure steps 1-6, docs/design/elastic-training-
operator.md:20-22) runnable end-to-end without a cluster: operator →
trainer process → Brain → JobResource → worker processes.

Phases map to process state: Pending until first :meth:`poll` sees the
process alive, Running while it lives, Succeeded/Failed by exit code,
deletion is SIGTERM → (grace) → SIGKILL. Command templates may reference
``{name} {role} {job} {workdir}`` and ``{ready_file}`` — a command that
uses the latter opts into readiness gating (the k8s readiness-probe
equivalent): the pod stays Pending until the process touches that file.
Replace-then-retire keys on the replacement reaching Running, so a pod
whose startup includes a data handoff (PS drain/restore) uses the ready
file to order its predecessor's retirement strictly after the handoff.
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import threading
import time
from typing import Dict, List, Optional

from easydl_tpu_torch.controller.pod_api import Pod, PodApi
from easydl_tpu_torch.utils.logging import get_logger

log = get_logger("controller", "procpods")


class _Proc:
    def __init__(self, pod: Pod, proc: subprocess.Popen, log_path: str,
                 ready_file: Optional[str] = None):
        self.pod = pod
        self.proc = proc
        self.log_path = log_path
        self.ready_file = ready_file
        self.term_sent_at: Optional[float] = None


class LocalProcessPodApi(PodApi):
    """Pods as local subprocesses; stdout/err captured per pod."""

    def __init__(self, workdir: str, env: Optional[Dict[str, str]] = None,
                 grace_s: float = 5.0):
        self.workdir = workdir
        self.extra_env = env or {}
        self.grace_s = grace_s
        self._procs: Dict[str, _Proc] = {}
        self._pending: set = set()  # names being spawned outside the lock
        self._doomed: set = set()   # pending names deleted mid-spawn
        self._closed = False        # shutdown() ran; late spawns die
        self._lock = threading.RLock()
        os.makedirs(os.path.join(workdir, "pod-logs"), exist_ok=True)

    # ----------------------------------------------------------------- PodApi
    def create_pod(self, pod: Pod) -> None:
        # The lock guards only the name-table transitions; the spawn itself
        # (ready-file unlink, log open, fork/exec) runs OUTSIDE the hold —
        # a slow exec under the table lock would stall every concurrent
        # delete/list/poll (easylint: blocking-call-under-lock). The
        # `_pending` reservation keeps the duplicate-name check airtight
        # across the unlocked window.
        with self._lock:
            if self._closed:
                raise ValueError("pod api is shut down")
            if pod.name in self._procs or pod.name in self._pending:
                raise ValueError(f"pod {pod.name!r} already exists")
            self._pending.add(pod.name)
        try:
            # Substitute ONLY the known tokens (str.format would choke on
            # literal braces in commands, e.g. JSON model-args); quote the
            # workdir so paths with spaces survive shlex.split.
            cmd = pod.command
            ready_file: Optional[str] = None
            if "{ready_file}" in cmd:
                ready_file = os.path.join(
                    self.workdir, f".ready-{pod.name}"
                )
                try:  # names are never reused, but be safe on reruns
                    os.remove(ready_file)
                except FileNotFoundError:
                    pass
            for token, value in (
                ("{name}", pod.name), ("{role}", pod.role), ("{job}", pod.job),
                ("{workdir}", shlex.quote(self.workdir)),
                ("{ready_file}", shlex.quote(ready_file or "")),
            ):
                cmd = cmd.replace(token, value)
            log_path = os.path.join(self.workdir, "pod-logs", f"{pod.name}.log")
            env = dict(os.environ)
            env.update(self.extra_env)
            env.update(
                EASYDL_POD_NAME=pod.name,
                EASYDL_POD_ROLE=pod.role,
                EASYDL_JOB=pod.job,
                EASYDL_WORKDIR=self.workdir,
                EASYDL_REPLACES=pod.replaces or "",
            )
            with open(log_path, "ab") as logf:
                proc = subprocess.Popen(
                    shlex.split(cmd),
                    stdout=logf, stderr=subprocess.STDOUT,
                    env=env, start_new_session=True,  # own pgid: clean kill
                )
            with self._lock:
                # A shutdown()/delete_pod(name) that ran during the
                # unlocked spawn window marked this name doomed: kill the
                # just-born child instead of registering it (it must not
                # outlive the teardown that thought it covered everything).
                if self._closed or pod.name in self._doomed:
                    self._doomed.discard(pod.name)
                    try:
                        os.killpg(proc.pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
                    return
                self._procs[pod.name] = _Proc(pod, proc, log_path, ready_file)
        finally:
            with self._lock:
                self._pending.discard(pod.name)
        log.info("launched pod %s (%s): pid=%d", pod.name, pod.role, proc.pid)

    def delete_pod(self, name: str) -> None:
        with self._lock:
            entry = self._procs.get(name)
            if entry is None:
                if name in self._pending:
                    # mid-spawn: create_pod will kill it on registration
                    self._doomed.add(name)
                return
            if entry.proc.poll() is None:
                if entry.term_sent_at is None:
                    try:
                        os.killpg(entry.proc.pid, signal.SIGTERM)
                    except ProcessLookupError:
                        pass
                    entry.term_sent_at = time.monotonic()
                    entry.pod.phase = "Terminating"
                    return  # graceful: poll() escalates after grace_s
                return
            del self._procs[name]

    def list_pods(self, job: Optional[str] = None) -> List[Pod]:
        self.poll()
        with self._lock:
            pods = [
                e.pod for e in self._procs.values()
                if job is None or e.pod.job == job
            ]
            return sorted(pods, key=lambda p: p.name)

    # ------------------------------------------------------------------ state
    def poll(self) -> None:
        """Refresh phases from process state; escalate overdue TERMs."""
        with self._lock:
            for name in list(self._procs):
                e = self._procs[name]
                rc = e.proc.poll()
                if rc is None:
                    if e.term_sent_at is not None:
                        if time.monotonic() - e.term_sent_at > self.grace_s:
                            try:
                                os.killpg(e.proc.pid, signal.SIGKILL)
                            except ProcessLookupError:
                                pass
                    elif e.pod.phase == "Pending":
                        # readiness-gated pods stay Pending until their
                        # ready file appears (startup handoff complete)
                        if e.ready_file is None or os.path.exists(e.ready_file):
                            e.pod.phase = "Running"
                elif e.term_sent_at is not None:
                    del self._procs[name]  # deletion completed
                else:
                    e.pod.phase = "Succeeded" if rc == 0 else "Failed"

    def tail_log(self, name: str, n: int = 30) -> str:
        with self._lock:
            e = self._procs.get(name)
        if e is None:
            return ""
        try:
            with open(e.log_path) as f:
                return "".join(f.readlines()[-n:])
        except OSError:
            return ""

    def shutdown(self) -> None:
        """Kill everything (test teardown)."""
        with self._lock:
            self._closed = True  # in-flight create_pods kill their child
            for e in self._procs.values():
                if e.proc.poll() is None:
                    try:
                        os.killpg(e.proc.pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
            self._procs.clear()
