"""The port's Kubernetes backends (``easydl_tpu_torch/controller/
kube_pod_api.py``, ``kube_cr_source.py``, ``kube_http.py``) against the JAX
package's, over ``tests/fake_kube.py`` (stdlib only, so both packages use
it):

- ``pod_to_manifest`` renders equal manifests for seeded pods of every
  role: with a ``TpuSpec`` (the GKE pod-slice limit and node selectors,
  kept as the reference has them), with ``gpu: 1`` (the ``nvidia.com/gpu``
  limit) and plain CPU; ``manifest_to_pod`` reads each package's manifests
  back alike; a planted fault (the GPU limit dropped) is caught;
- both packages' controllers over ``KubePodApi``, each against a fake
  cluster of its own, leave equal pods on their clusters through one
  script (the trainer first, a TPU and a GPU role, a failed worker,
  replace-then-retire, the job's end);
- both packages' ``KubeCrSource`` watching one fake API server deliver the
  same store events for the same CR writes (jobs, a plan parked before its
  job, a stale plan, a terminal status, a deletion), and their status
  writers PATCH equal documents; a planted fault (the port's source
  ignoring deletions) is caught.
"""

import json
import random
import time
from unittest import mock

import pytest
from fake_kube import FakeKubeApiServer

pytest.importorskip("jax")  # parity tests hold the port to the JAX package

from easydl_tpu import api as jax_api  # noqa: E402
from easydl_tpu import controller as jax_controller  # noqa: E402
from easydl_tpu.controller import kube_cr_source as jax_cr_source  # noqa: E402
from easydl_tpu.controller import kube_http as jax_kube_http  # noqa: E402
from easydl_tpu.controller import kube_pod_api as jax_kube_pod_api  # noqa: E402
from easydl_tpu_torch import api, controller  # noqa: E402
from easydl_tpu_torch.controller import kube_cr_source, kube_http, kube_pod_api  # noqa: E402

PACKAGES = {"port": (api, controller, kube_pod_api, kube_cr_source, kube_http),
            "jax": (jax_api, jax_controller, jax_kube_pod_api, jax_cr_source, jax_kube_http)}
ROLES = ("trainer", "worker", "parameter_server", "evaluator")


def resource(a, kind: str, rng):
    if kind == "tpu":
        return a.ResourceSpec(cpu=rng.choice([0, 4.0, 8]), memory=rng.choice([0, 16384]),
                              tpu=a.TpuSpec(type=rng.choice(["v4", "v5e", "v5p", "v6e", "v9"]),
                                            chips=rng.choice([1, 4, 8]),
                                            topology=rng.choice(["", "2x2", "2x2x2"])))
    if kind == "gpu":
        return a.ResourceSpec(cpu=8.0, memory=65536, gpu=1)
    return a.ResourceSpec(cpu=rng.choice([0.5, 2.0, 16]), memory=rng.choice([0, 512, 8192]),
                          disk=rng.choice([0, 10240]))


def pods(a, c, seed: int):
    rng = random.Random(seed)
    out = []
    for i in range(60):
        role = rng.choice(ROLES)
        command = rng.choice(["", "python -m easydl_tpu_torch.models.run --model bert",
                              "python -m x --name {name} --workdir {workdir} --role {role}",
                              "python -m ps --ready-file {ready_file} --job {job}"])
        out.append(c.Pod(name=f"j-{role}-{i}", job="j", role=role,
                         resource=resource(a, ("tpu", "gpu", "cpu")[i % 3], rng),
                         replaces=rng.choice(["", f"j-{role}-0"]), command=command,
                         image=rng.choice(["", "img:1"]), phase="Pending"))
    return out


def manifests(name: str, render=None) -> list:
    a, c, kpa, _, _ = PACKAGES[name]
    render = render or kpa.pod_to_manifest
    volume = {"persistentVolumeClaim": {"claimName": "shared"}}
    return [render(p, "train", workdir="/mnt/w", workdir_volume=volume if i % 2 else None)
            for i, p in enumerate(pods(a, c, 0))]


def test_pod_manifests_render_alike():
    ours, theirs = manifests("port"), manifests("jax")
    assert ours == theirs
    limits = [m["spec"]["containers"][0].get("resources", {}).get("limits", {}) for m in ours]
    assert sum("google.com/tpu" in x for x in limits) == 20
    assert sum(x == {"nvidia.com/gpu": "1"} for x in limits) == 20
    assert sum(not x for x in limits) == 20
    assert {m["spec"]["nodeSelector"]["cloud.google.com/gke-tpu-accelerator"]
            for m in ours if "nodeSelector" in m["spec"]} == {
        "tpu-v4-podslice", "tpu-v5-lite-podslice", "tpu-v5p-slice", "tpu-v6e-slice", "v9"}
    for doc in ours:  # each package reads the other's manifests back alike
        doc = {**doc, "status": {"phase": "Running"}}
        mine, yours = kube_pod_api.manifest_to_pod(doc), jax_kube_pod_api.manifest_to_pod(doc)
        assert (mine.name, mine.role, mine.phase, mine.replaces, mine.command) == (
            yours.name, yours.role, yours.phase, yours.replaces, yours.command)
        assert mine.resource.to_dict() == yours.resource.to_dict()

    def no_gpu(pod, namespace, **kw):  # the planted fault
        doc = kube_pod_api.pod_to_manifest(pod, namespace, **kw)
        doc["spec"]["containers"][0].get("resources", {}).get("limits", {}).pop(
            "nvidia.com/gpu", None)
        return doc

    faulty = manifests("port", no_gpu)
    assert sum(x != y for x, y in zip(faulty, theirs)) == 20


def drive_cluster(name: str) -> list:
    """One script of the controller over KubePodApi on a fake cluster of
    its own; the cluster's pods after each step."""
    a, c, kpa, _, _ = PACKAGES[name]
    srv = FakeKubeApiServer()
    try:
        pod_api = kpa.KubePodApi(base_url=srv.url, namespace="train", token="t")
        store = c.CrStore()
        ctl = c.ElasticJobController(store, pod_api)
        # the evaluator's command named: by default each package's role runs its own pod
        roles = {"worker": a.RoleSpec(), "parameter_server": a.RoleSpec(),
                 "evaluator": a.RoleSpec(command="python -m evaluator --workdir {workdir}")}
        store.submit_job(a.JobSpec(name="j", command="python -m easydl_tpu_torch.models.run "
                                   "--model bert", roles=roles))
        snapshots = []

        def step(act=None):
            if act is not None:
                act()
            ctl.reconcile_job("j")
            with srv.lock:
                snapshots.append(json.loads(json.dumps(srv.pods, sort_keys=True)))

        def plan(version, updations=()):
            return a.ResourcePlan(job_name="j", version=version, roles={
                "worker": a.RolePlan(2, a.ResourceSpec(gpu=1, cpu=8.0)),
                "parameter_server": a.RolePlan(1, a.ResourceSpec(
                    cpu=2, tpu=a.TpuSpec(type="v5e", chips=4, topology="2x2"))),
                "evaluator": a.RolePlan(1, a.ResourceSpec())},
                resource_updation=list(updations))

        step()
        step(lambda: store.apply_plan(plan(1)))
        step(srv.tick)
        step(lambda: srv.set_phase("j-worker-0", "Failed"))
        upd = a.ResourceUpdation(name="j-parameter_server-0", resource=a.ResourceSpec(cpu=8))
        step(lambda: store.apply_plan(plan(2, [upd])))
        step(lambda: srv.set_phase("j-parameter_server-1", "Running"))
        step(lambda: srv.set_phase("j-trainer-0", "Succeeded"))
        return snapshots
    finally:
        srv.stop()


def test_the_controllers_leave_equal_pods_on_their_clusters():
    ours, theirs = drive_cluster("port"), drive_cluster("jax")
    assert ours == theirs
    phases = [{k: v["status"]["phase"] for k, v in s.items()} for s in ours]
    assert phases[0] == {"j-trainer-0": "Pending"}
    assert phases[3]["j-worker-2"] == "Pending" and "j-worker-0" not in phases[3]
    assert phases[4]["j-parameter_server-1"] == "Pending" and "j-parameter_server-0" in phases[4]
    assert "j-parameter_server-0" not in phases[5]
    # the job's end: the live pods collected, the evaluator in its grace window
    assert phases[-1] == {"j-evaluator-0": "Running", "j-trainer-0": "Succeeded"}


# ------------------------------------------------------------ CR watch
def job_crd(a, name, status=None):
    doc = a.JobSpec(name=name, command="python -m easydl_tpu_torch.models.run --model mlp",
                    roles={"worker": a.RoleSpec()}).to_crd()
    if status:
        doc["status"] = status
    return doc


def plan_crd(a, job, version, workers, name=""):
    return a.ResourcePlan(name=name or f"{job}-plan-v{version}", job_name=job, version=version,
                          roles={"worker": a.RolePlan(replicas=workers)}).to_crd()


def settle(cond, timeout: float) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.02)
    return False


def drain(store) -> list:
    out = []
    while (ev := store.next_event(timeout=0)) is not None:
        out.append(ev)
    return out


def watch_both(srv, timeout: float = 5.0) -> dict:
    """Both packages' sources on one API server, one store each; after each
    CR write (and once it has landed in both), the events each store
    delivered and its jobs, plans and statuses."""
    stores = {n: PACKAGES[n][1].CrStore() for n in PACKAGES}
    sources = [PACKAGES[n][3].KubeCrSource(
        stores[n], PACKAGES[n][4].KubeClient(base_url=srv.url, namespace="train", token="t"),
        watch_timeout_s=2.0).start() for n in PACKAGES]
    a = api
    out = {n: [] for n in PACKAGES}
    done = "Succeeded"
    script = [
        (lambda: srv.put_cr("elasticjobs", job_crd(a, "a")), lambda s: s.job("a")),
        (lambda: srv.put_cr("jobresources", plan_crd(a, "future", 2, 8)), None),
        (lambda: srv.put_cr("elasticjobs", job_crd(a, "future")), lambda s: s.plan("future")),
        (lambda: srv.put_cr("jobresources", plan_crd(a, "a", 3, 4)),
         lambda s: getattr(s.plan("a"), "version", 0) == 3),
        (lambda: (srv.put_cr("jobresources", plan_crd(a, "a", 2, 1, name="old")),
                  srv.put_cr("jobresources", plan_crd(a, "a", 4, 2))),
         lambda s: getattr(s.plan("a"), "version", 0) == 4),
        (lambda: srv.put_cr("elasticjobs", job_crd(a, "a", {"phase": done, "roles": {}})),
         lambda s: (s.job_status("a") or {}).get("phase") == done),
        (lambda: srv.delete_cr("elasticjobs", "future"), lambda s: s.job("future") is None),
    ]
    try:
        for act, landed in script:
            act()
            for n, s in stores.items():
                ok = settle(lambda: landed(s), timeout) if landed is not None else True
                time.sleep(0.05 if landed is None else 0)
                out[n].append((ok, drain(s), s.jobs(),
                               {j: s.plan(j).to_crd() if s.plan(j) else None for j in s.jobs()},
                               {j: s.job_status(j) for j in s.jobs()}))
    finally:
        for src in sources:
            src.stop()
    return out


def test_the_cr_sources_deliver_the_same_events():
    srv = FakeKubeApiServer(max_watch_s=2.0)
    try:
        got = watch_both(srv)
        assert got["port"] == got["jax"]
        events = [e for step in got["port"] for e in step[1]]
        assert ("job_added", "future") in events and ("job_deleted", "future") in events
        assert [step[0] for step in got["port"]] == [True] * 7
        assert got["port"][-1][2] == ["a"]
        # the status writers PATCH the same document
        for n in PACKAGES:
            client = PACKAGES[n][4].KubeClient(base_url=srv.url, namespace="train", token="t")
            PACKAGES[n][3].make_status_writer(client)("a", {"phase": "Running", "roles": {
                "worker": {"active": 2, "succeeded": 0, "failed": 0}}, "by": n})
        assert srv.crs["elasticjobs"]["a"]["status"]["by"] == "jax"
    finally:
        srv.stop()
    srv = FakeKubeApiServer(max_watch_s=2.0)
    original = kube_cr_source.KubeCrSource._ingest_job

    def no_deletions(self, doc, event):  # the planted fault
        if event != "DELETED":
            original(self, doc, event)

    try:
        with mock.patch.object(kube_cr_source.KubeCrSource, "_ingest_job", no_deletions):
            faulty = watch_both(srv, timeout=1.0)
        assert faulty["port"][:-1] == faulty["jax"][:-1]
        assert faulty["port"][-1] != faulty["jax"][-1]
    finally:
        srv.stop()
