"""Kubernetes pod backend for the elastic operator.

The reference IS a k8s operator ("a k8s controller to manage training Pods",
the reference's README.md:12; CRDs watched via the API server,
docs/design/elastic-training-operator.md:16-18,53-55). This backend
implements :class:`~easydl_tpu_torch.controller.pod_api.PodApi` against the k8s
REST API so the same reconcile core that drives the in-memory fake and the
local-process backend drives a real cluster.

Implementation notes:
- stdlib HTTP only (urllib): the image has no ``kubernetes`` client package,
  and the pod API surface we need (POST/GET/DELETE on
  ``/api/v1/namespaces/{ns}/pods``) is small enough that a generated client
  buys nothing. In-cluster auth (service-account token + CA) is picked up
  from the conventional mount path; tests point ``base_url`` at a local
  fake API server over plain HTTP (tests/test_kube_pod_api.py).
- pods carry labels ``easydl.org/job|role|replaces`` so ``list_pods`` is one
  labelSelector GET and the reconcile core's replace-then-retire metadata
  round-trips through the cluster.
- ``TpuSpec`` maps to GKE TPU pod-slice scheduling: the
  ``google.com/tpu`` resource limit plus the
  ``cloud.google.com/gke-tpu-accelerator`` / ``gke-tpu-topology`` node
  selectors (the GKE-documented contract for TPU slices).
"""

from __future__ import annotations

import json
import urllib.parse
from typing import Any, Dict, List, Optional

from easydl_tpu_torch.api.job_spec import ResourceSpec, TpuSpec
from easydl_tpu_torch.controller.kube_http import SA_DIR, KubeApiError, KubeClient
from easydl_tpu_torch.controller.pod_api import Pod, PodApi
from easydl_tpu_torch.utils.logging import get_logger

log = get_logger("controller", "kubepods")

__all__ = [
    "KubePodApi", "KubeApiError", "pod_to_manifest", "manifest_to_pod",
    "SA_DIR", "GKE_TPU_ACCELERATOR",
]

#: accelerator family -> GKE gke-tpu-accelerator node-selector value
GKE_TPU_ACCELERATOR = {
    "v4": "tpu-v4-podslice",
    "v5e": "tpu-v5-lite-podslice",
    "v5p": "tpu-v5p-slice",
    "v6e": "tpu-v6e-slice",
}

LABEL_JOB = "easydl.org/job"
LABEL_ROLE = "easydl.org/role"
LABEL_REPLACES = "easydl.org/replaces"
ANNOTATION_RESOURCE = "easydl.org/resource"


#: default in-container mount point of the job's shared volume — the k8s
#: equivalent of the process backend's workdir (master.json, the PS
#: registry, checkpoints all live here; pods must see one shared path).
DEFAULT_WORKDIR = "/workdir"


def pod_to_manifest(pod: Pod, namespace: str,
                    workdir: str = DEFAULT_WORKDIR,
                    workdir_volume: Optional[Dict[str, Any]] = None,
                    ) -> Dict[str, Any]:
    """Our Pod record -> a k8s V1Pod manifest.

    ``workdir`` is substituted into ``{workdir}`` command tokens and exported
    as EASYDL_WORKDIR (parity with the process backend — the PS registry,
    master.json and checkpoints all live under it). ``workdir_volume`` is an
    optional k8s volume SOURCE (e.g. ``{"persistentVolumeClaim":
    {"claimName": "train-shared"}}`` or ``{"nfs": {...}}``) mounted at that
    path in every pod; without a shared volume the pods see different
    filesystems and the file-based rendezvous cannot work."""
    requests: Dict[str, str] = {}
    limits: Dict[str, str] = {}
    if pod.resource.cpu:
        requests["cpu"] = str(pod.resource.cpu)
    if pod.resource.memory:
        requests["memory"] = f"{pod.resource.memory}Mi"
    if pod.resource.disk:
        requests["ephemeral-storage"] = f"{pod.resource.disk}Mi"
    if pod.resource.gpu:
        limits["nvidia.com/gpu"] = str(pod.resource.gpu)
    node_selector: Dict[str, str] = {}
    tpu = pod.resource.tpu
    if tpu is not None and tpu.chips:
        # GKE TPU pod slice: chips-per-pod via the google.com/tpu limit;
        # slice family/topology via node selectors.
        limits["google.com/tpu"] = str(tpu.chips)
        node_selector["cloud.google.com/gke-tpu-accelerator"] = (
            GKE_TPU_ACCELERATOR.get(tpu.type, tpu.type)
        )
        if tpu.topology:
            node_selector["cloud.google.com/gke-tpu-topology"] = tpu.topology
    container: Dict[str, Any] = {
        "name": pod.role.replace("_", "-"),
        "image": pod.image or "python:3.11-slim",
        # identity env, mirroring the process backend's identity exports
        "env": [
            {"name": "EASYDL_POD_NAME", "value": pod.name},
            {"name": "EASYDL_POD_ROLE", "value": pod.role},
            {"name": "EASYDL_JOB", "value": pod.job},
            {"name": "EASYDL_REPLACES", "value": pod.replaces or ""},
            {"name": "EASYDL_WORKDIR", "value": workdir},
        ],
    }
    if pod.command:
        cmd = pod.command
        if "{workdir}" in cmd and workdir_volume is None:
            # Without a shared volume, {workdir} resolves to a path on each
            # container's OWN filesystem — master.json, the PS registry, and
            # ready files would never be visible across pods and every
            # discover()/rendezvous would hang until timeout with no hint.
            # Warn at create time, where the misconfiguration is actionable.
            log.warning(
                "pod %s: command uses {workdir} but no --workdir-volume is "
                "configured — %s will be container-local and cross-pod "
                "file rendezvous will hang", pod.name, workdir,
            )
        for token, value in (("{name}", pod.name), ("{role}", pod.role),
                             ("{job}", pod.job), ("{workdir}", workdir)):
            cmd = cmd.replace(token, value)
        if "{ready_file}" in cmd:
            # Readiness-gated command (the process backend's {ready_file}
            # convention): emit a real readinessProbe so replace-then-retire
            # orders the old pod's retirement after the handoff on k8s too —
            # without a probe, kubelet reports Ready at container start and
            # the drain window would race the retirement.
            ready_path = "/tmp/easydl-ready"
            cmd = cmd.replace("{ready_file}", ready_path)
            container["readinessProbe"] = {
                "exec": {"command": ["cat", ready_path]},
                "initialDelaySeconds": 1,
                "periodSeconds": 2,
            }
        container["command"] = ["/bin/sh", "-c", cmd]
    if requests or limits:
        container["resources"] = {}
        if requests:
            container["resources"]["requests"] = requests
        if limits:
            container["resources"]["limits"] = limits
    manifest: Dict[str, Any] = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": pod.name,
            "namespace": namespace,
            "labels": {
                LABEL_JOB: pod.job,
                LABEL_ROLE: pod.role,
                **({LABEL_REPLACES: pod.replaces} if pod.replaces else {}),
            },
            # Full resource doc as an annotation so list_pods can rebuild
            # the exact ResourceSpec (and its signature) without lossy
            # quantity parsing.
            "annotations": {
                ANNOTATION_RESOURCE: json.dumps(pod.resource.to_dict()),
            },
        },
        "spec": {
            "restartPolicy": "Never",  # the operator owns restarts
            **({"nodeSelector": node_selector} if node_selector else {}),
            "containers": [container],
        },
    }
    if workdir_volume is not None:
        container.setdefault("volumeMounts", []).append(
            {"name": "easydl-workdir", "mountPath": workdir}
        )
        if "name" in workdir_volume:
            # A full k8s volume (not a bare source) was pasted: its own name
            # would desync from the volumeMount's — ours wins.
            log.warning("workdir_volume 'name' %r ignored (mount uses "
                        "'easydl-workdir')", workdir_volume["name"])
        manifest["spec"]["volumes"] = [
            {**workdir_volume, "name": "easydl-workdir"}
        ]
    return manifest


def manifest_to_pod(doc: Dict[str, Any]) -> Pod:
    meta = doc.get("metadata", {})
    labels = meta.get("labels", {}) or {}
    annotations = meta.get("annotations", {}) or {}
    try:
        resource = ResourceSpec.from_dict(
            json.loads(annotations.get(ANNOTATION_RESOURCE, "{}"))
        )
    except (ValueError, TypeError):
        resource = ResourceSpec()
    status = doc.get("status", {}) or {}
    phase = status.get("phase", "Pending")
    # k8s keeps phase Running during graceful deletion; our reconcile core
    # models that window as Terminating (replace-then-retire relies on it).
    if meta.get("deletionTimestamp") and phase in ("Pending", "Running"):
        phase = "Terminating"
    # Running-but-not-Ready reads as Pending: replace-then-retire must not
    # retire the old pod while its replacement's readiness probe (e.g. the
    # PS handoff) is still failing.
    if phase == "Running":
        for cond in status.get("conditions") or []:
            if cond.get("type") == "Ready" and cond.get("status") != "True":
                phase = "Pending"
                break
    spec = doc.get("spec", {}) or {}
    containers = spec.get("containers") or [{}]
    command = containers[0].get("command") or []
    return Pod(
        name=meta.get("name", ""),
        job=labels.get(LABEL_JOB, ""),
        role=labels.get(LABEL_ROLE, ""),
        resource=resource,
        phase=phase,
        replaces=labels.get(LABEL_REPLACES, ""),
        command=command[-1] if command else "",
        image=containers[0].get("image", ""),
    )


class KubePodApi(PodApi):
    """PodApi over the k8s REST API (stdlib HTTP; in-cluster or explicit)."""

    def __init__(
        self,
        base_url: str = "",
        namespace: str = "",
        token: Optional[str] = None,
        ca_file: Optional[str] = None,
        timeout: float = 10.0,
        client: Optional[KubeClient] = None,
        workdir: str = DEFAULT_WORKDIR,
        workdir_volume: Optional[Dict[str, Any]] = None,
    ):
        self._client = client or KubeClient(
            base_url=base_url, namespace=namespace, token=token,
            ca_file=ca_file, timeout=timeout,
        )
        self.base_url = self._client.base_url
        self.namespace = self._client.namespace
        self.workdir = workdir
        self.workdir_volume = workdir_volume

    # ------------------------------------------------------------------ http
    def _request(self, method: str, path: str,
                 body: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        return self._client.request(method, path, body)

    # ---------------------------------------------------------------- PodApi
    def create_pod(self, pod: Pod) -> None:
        manifest = pod_to_manifest(pod, self.namespace, workdir=self.workdir,
                                   workdir_volume=self.workdir_volume)
        # A known template token surviving substitution would reach the
        # container as a literal brace string and crash-loop the pod with a
        # baffling error; fail loudly here instead. ({ready_file} is
        # substituted by the readiness-probe block; arbitrary braces — JSON
        # model args — are legitimate and pass through.)
        cmd = manifest["spec"]["containers"][0].get("command")
        if cmd:
            leftover = [t for t in ("{name}", "{role}", "{job}", "{workdir}",
                                    "{ready_file}") if t in cmd[-1]]
            if leftover:
                raise ValueError(
                    f"pod {pod.name!r}: unsubstituted command tokens "
                    f"{leftover} in {cmd[-1]!r}"
                )
        path = f"/api/v1/namespaces/{self.namespace}/pods"
        try:
            self._request("POST", path, manifest)
        except KubeApiError as e:
            if e.code == 409:  # AlreadyExists — reconcile is level-triggered
                log.warning("pod %s already exists", pod.name)
                return
            raise
        log.info("created pod %s (%s)", pod.name, pod.role)

    def delete_pod(self, name: str) -> None:
        path = f"/api/v1/namespaces/{self.namespace}/pods/{name}"
        try:
            self._request("DELETE", path)
        except KubeApiError as e:
            if e.code == 404:  # idempotent, like k8s delete of a gone pod
                return
            raise
        log.info("deleted pod %s", name)

    def list_pods(self, job: Optional[str] = None) -> List[Pod]:
        selector = f"{LABEL_JOB}={job}" if job else LABEL_JOB
        path = (
            f"/api/v1/namespaces/{self.namespace}/pods"
            f"?labelSelector={urllib.parse.quote(selector)}"
        )
        doc = self._request("GET", path)
        pods = [manifest_to_pod(item) for item in doc.get("items", [])]
        return sorted(pods, key=lambda p: p.name)
