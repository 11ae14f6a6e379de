"""LIST/WATCH of ElasticJob / JobResource custom resources.

This is the CR half of the reference's architecture: "all control flow rides
CR events on the API server" (the reference's docs/design/
elastic-training-operator.md:16-18,53-55; README.md:12). The pod half lives
in kube_pod_api.py; this module closes the loop so the operator is
deployable as a real k8s controller — submit an ElasticJob with kubectl and
the reconcile core sees it, no YAML watch directory involved.

Protocol (the standard k8s controller recipe, informer-style but minimal):

1. LIST ``/apis/elastic.easydl.org/v1alpha1/namespaces/{ns}/{plural}`` to
   seed local state and learn the collection ``resourceVersion``.
2. WATCH the same path with ``?watch=true&resourceVersion=<rv>`` — a chunked
   stream of ``{"type": ADDED|MODIFIED|DELETED|BOOKMARK|ERROR, "object":…}``
   lines. Every event advances the remembered rv, so a dropped connection
   resumes *from where it left off* rather than replaying history.
3. When the server ends the stream (its watch ``timeoutSeconds``), re-watch
   from the last rv. When the rv has expired — HTTP 410 Gone, or an ERROR
   event with code 410 — fall back to a fresh LIST (step 1). This is the
   list-then-watch resync loop every k8s client implements.

Events funnel into the same :class:`~easydl_tpu_torch.controller.operator.CrStore`
the directory-watch mode and the tests use, so the reconcile loop is
identical in all three deployments. Cross-stream ordering (a JobResource
arriving before its ElasticJob) is absorbed by parking the plan and retrying
when the job shows up — the same semantics the directory ingester has.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from easydl_tpu_torch.api.job_spec import API_GROUP, JobSpec, SpecError
from easydl_tpu_torch.api.resource_plan import ResourcePlan
from easydl_tpu_torch.controller.kube_http import KubeApiError, KubeClient
from easydl_tpu_torch.controller.operator import (
    TERMINAL_PHASES,
    CrStore,
    StalePlanError,
)
from easydl_tpu_torch.utils.logging import get_logger

log = get_logger("controller", "crwatch")

API_PREFIX = f"/apis/{API_GROUP}/v1alpha1"
JOB_PLURAL = "elasticjobs"
PLAN_PLURAL = "jobresources"


def make_status_writer(client: KubeClient) -> Callable[[str, Dict[str, Any]], None]:
    """CrStore status sink that writes ``ElasticJob.status`` back to the API
    server — a merge-PATCH on the ``/status`` subresource, so ``kubectl get
    elasticjobs`` shows the job phase (printer columns in
    manifests/crds/elasticjob.yaml). Raises on failure so CrStore marks the
    status dirty and the next reconcile pass retries the write."""

    def write(job_name: str, status: Dict[str, Any]) -> None:
        path = (f"{API_PREFIX}/namespaces/{client.namespace}/"
                f"{JOB_PLURAL}/{job_name}/status")
        client.request("PATCH", path, {"status": status},
                       content_type="application/merge-patch+json")

    return write


class KubeCrSource:
    """Mirrors ElasticJob/JobResource CRs from the API server into a CrStore.

    One watch thread per resource type; ``start()``/``stop()`` lifecycle like
    the controller itself. ``sync_once()`` does a single LIST pass — used at
    startup (so the first reconcile sees pre-existing CRs before the watch
    threads win their first event) and directly by tests.
    """

    def __init__(self, store: CrStore, client: KubeClient,
                 watch_timeout_s: float = 60.0,
                 retry_backoff_s: float = 1.0):
        self.store = store
        self.client = client
        self._watch_timeout = watch_timeout_s
        self._backoff = retry_backoff_s
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # JobResources seen before their ElasticJob: job_name -> best plan.
        self._pending_plans: Dict[str, ResourcePlan] = {}
        self._pending_lock = threading.Lock()

    # ---------------------------------------------------------------- ingest
    def _ingest_job(self, doc: Dict[str, Any], event: str) -> None:
        name = (doc.get("metadata") or {}).get("name", "")
        if event == "DELETED":
            if name:
                self.store.delete_job(name)
                with self._pending_lock:
                    self._pending_plans.pop(name, None)
                log.info("job %s deleted on API server", name)
            return
        try:
            job = JobSpec.from_crd(doc)
        except SpecError as e:
            log.error("bad ElasticJob %r from API server: %s", name, e)
            return
        if self.store.job(job.name) is None:
            self.store.submit_job(job)
            log.info("job %s synced from API server", job.name)
        else:
            # ElasticJob spec edits don't re-submit (the job identity is the
            # spec); a MODIFIED event still pokes a reconcile pass.
            self.store.poke(job.name)
        # Re-learn a previously written TERMINAL status — a restarted
        # operator must keep a finished job finished even if its pods were
        # GC'd. Only terminal phases are re-learned: ingesting live-phase
        # statuses would replay our own write-back MODIFIED events into the
        # store out of order and re-PATCH them in a feedback loop, while a
        # live phase is recomputed by the next reconcile pass anyway.
        st = doc.get("status")
        if isinstance(st, dict) and st.get("phase") in TERMINAL_PHASES:
            self.store.set_status(job.name, st)
        self._retry_pending(job.name)

    def _ingest_plan(self, doc: Dict[str, Any], event: str) -> None:
        if event == "DELETED":
            # Deleting a JobResource does not un-apply it: the reference's
            # plans only ever advance (stale-version gate); the last applied
            # plan stays in force until a newer one arrives.
            return
        name = (doc.get("metadata") or {}).get("name", "")
        try:
            plan = ResourcePlan.from_crd(doc)
        except SpecError as e:
            log.error("bad JobResource %r from API server: %s", name, e)
            return
        self._apply(plan)

    def _apply(self, plan: ResourcePlan) -> None:
        try:
            self.store.apply_plan(plan)
            log.info("plan v%d for %s synced from API server",
                     plan.version, plan.job_name)
        except StalePlanError:
            pass  # replayed event (LIST after watch already applied it)
        except KeyError:
            with self._pending_lock:
                cur = self._pending_plans.get(plan.job_name)
                if cur is None or plan.version > cur.version:
                    self._pending_plans[plan.job_name] = plan
            log.warning("plan v%d targets unknown job %r; parked until the "
                        "job appears", plan.version, plan.job_name)

    def _retry_pending(self, job_name: str) -> None:
        with self._pending_lock:
            plan = self._pending_plans.pop(job_name, None)
        if plan is not None:
            self._apply(plan)

    # ------------------------------------------------------------ list/watch
    def _path(self, plural: str) -> str:
        return f"{API_PREFIX}/namespaces/{self.client.namespace}/{plural}"

    def _list(self, plural: str,
              ingest: Callable[[Dict[str, Any], str], None]) -> str:
        doc = self.client.request("GET", self._path(plural))
        items = doc.get("items", [])
        for item in items:
            ingest(item, "ADDED")
        if plural == JOB_PLURAL:
            # A LIST is a full resync: a job absent from it was deleted while
            # we weren't watching (its DELETED event predates our watch rv),
            # so mirror the deletion here or the store keeps it forever.
            present = {(i.get("metadata") or {}).get("name") for i in items}
            for name in self.store.jobs():
                if name not in present:
                    log.info("job %s gone from API server (list resync)", name)
                    self.store.delete_job(name)
                    with self._pending_lock:
                        self._pending_plans.pop(name, None)
        return str((doc.get("metadata") or {}).get("resourceVersion", "0"))

    def sync_once(self) -> None:
        """One LIST pass over both resource types (startup seeding/tests)."""
        self._list(JOB_PLURAL, self._ingest_job)
        self._list(PLAN_PLURAL, self._ingest_plan)

    def _watch_loop(self, plural: str,
                    ingest: Callable[[Dict[str, Any], str], None]) -> None:
        rv: Optional[str] = None
        while not self._stop.is_set():
            try:
                if rv is None:
                    rv = self._list(plural, ingest)
                path = (f"{self._path(plural)}?watch=true&resourceVersion={rv}"
                        f"&timeoutSeconds={int(self._watch_timeout)}")
                for ev in self.client.stream(
                    path, read_timeout=self._watch_timeout + 30.0
                ):
                    if self._stop.is_set():
                        return
                    etype = ev.get("type", "")
                    obj = ev.get("object") or {}
                    if etype == "ERROR":
                        # Expired rv (410) or server-side trouble: full
                        # resync — after a backoff, so a persistently failing
                        # server isn't hot-looped with LIST+WATCH.
                        log.warning("watch %s error event: %s", plural, obj)
                        rv = None
                        self._stop.wait(self._backoff)
                        break
                    if etype == "BOOKMARK":
                        new_rv = (obj.get("metadata") or {}).get(
                            "resourceVersion"
                        )
                        if new_rv:
                            rv = str(new_rv)
                        continue
                    ingest(obj, etype)
                    new_rv = (obj.get("metadata") or {}).get("resourceVersion")
                    if new_rv:
                        rv = str(new_rv)
                # Stream ended normally (watch timeout): re-watch from rv.
            except KubeApiError as e:
                if e.code == 410:
                    rv = None  # history compacted past our rv: re-LIST
                else:
                    log.error("watch %s failed: %s", plural, e)
                self._stop.wait(self._backoff)
            except OSError as e:
                log.error("watch %s connection error: %s", plural, e)
                # Full resync after a connection failure: an API server that
                # restarted may have a DIFFERENT resourceVersion history
                # (etcd restore), and a watch resumed from our stale rv
                # could silently miss events without ever getting a 410.
                rv = None
                self._stop.wait(self._backoff)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "KubeCrSource":
        try:
            # Seed before the watch threads win their first event — but a
            # transient API-server blip at operator boot (rolling restart,
            # 503) must not crash the controller: the watch loops begin at
            # rv=None and re-LIST with backoff anyway.
            self.sync_once()
        except (KubeApiError, OSError) as e:
            log.warning("initial CR sync failed (watch loops will retry): %s",
                        e)
        for plural, ingest in (
            (JOB_PLURAL, self._ingest_job),
            (PLAN_PLURAL, self._ingest_plan),
        ):
            t = threading.Thread(
                target=self._watch_loop, args=(plural, ingest),
                daemon=True, name=f"crwatch-{plural}",
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()
