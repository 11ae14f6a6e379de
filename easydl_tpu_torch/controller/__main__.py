"""``python -m easydl_tpu_torch.controller`` — run the elastic operator.

Two CR sources select where ElasticJob / JobResource documents come from:

- ``--watch-dir DIR`` (standalone): watch a directory of YAML documents —
  drop or update files to drive the job. Useful without a cluster.
- ``--cr-source k8s`` (in-cluster): LIST/WATCH the CRs on the Kubernetes
  API server (easydl_tpu_torch/controller/kube_cr_source.py) — the reference's
  deployment shape (docs/design/elastic-training-operator.md:16-18,53-55),
  where ``kubectl apply`` of an ElasticJob is the only user action.

Either way the same reconcile loop runs against the selected pod backend:
``--pod-api memory`` logs decisions against the in-memory fake; ``k8s``
drives real cluster pods over the REST API.
"""

from __future__ import annotations

import argparse
import os
import time

import yaml

from easydl_tpu_torch.api.job_spec import JOB_KIND, JobSpec
from easydl_tpu_torch.api.resource_plan import PLAN_KIND, ResourcePlan
from easydl_tpu_torch.controller import CrStore, ElasticJobController, InMemoryPodApi
from easydl_tpu_torch.controller.operator import StalePlanError
from easydl_tpu_torch.utils.logging import get_logger

log = get_logger("controller", "main")


def ingest(store: CrStore, path: str, seen: dict, pending: set) -> None:
    for fname in sorted(os.listdir(path)):
        if not fname.endswith((".yaml", ".yml")):
            continue
        full = os.path.join(path, fname)
        # One bad file (syntax error, deleted mid-scan) must not take the
        # operator down with it — log and move to the next file. A file is
        # marked seen only after every document lands, so transient failures
        # (a plan whose job file sorts after it, a momentary read error) are
        # retried on the next scan instead of being dropped forever.
        try:
            mtime = os.path.getmtime(full)
            if seen.get(full) == mtime:
                continue
            with open(full) as f:
                docs = [d for d in yaml.safe_load_all(f) if isinstance(d, dict)]
        except (OSError, yaml.YAMLError) as e:
            log.error("unreadable manifest %s: %s", fname, e)
            continue
        retry = False
        for doc in docs:
            try:
                if doc.get("kind") == JOB_KIND:
                    job = JobSpec.from_crd(doc)
                    if store.job(job.name) is None:
                        store.submit_job(job)
                        log.info("submitted job %s from %s", job.name, fname)
                elif doc.get("kind") == PLAN_KIND:
                    plan = ResourcePlan.from_crd(doc)
                    try:
                        store.apply_plan(plan)
                        log.info("applied plan v%d for %s from %s",
                                 plan.version, plan.job_name, fname)
                        pending.discard(full)
                    except StalePlanError:
                        pass  # already applied: file unchanged since
                    except KeyError:
                        # Job not ingested yet (or misspelled selector) —
                        # retry next scan, but say so once per file.
                        retry = True
                        if full not in pending:
                            pending.add(full)
                            log.warning(
                                "plan in %s targets unknown job %r; will "
                                "retry until the job appears",
                                fname, plan.job_name,
                            )
            except Exception as e:
                log.error("bad document in %s: %s", fname, e)
        if not retry:
            seen[full] = mtime


def main() -> None:
    ap = argparse.ArgumentParser(description="easydl_tpu_torch elastic operator")
    ap.add_argument("--cr-source", choices=["dir", "k8s"], default="dir",
                    help="'dir' ingests CR YAMLs from --watch-dir; 'k8s' "
                         "LIST/WATCHes them on the API server")
    ap.add_argument("--watch-dir", default="",
                    help="directory of ElasticJob/JobResource YAMLs "
                         "(required with --cr-source dir)")
    ap.add_argument("--pod-api", choices=["memory", "k8s"], default="memory",
                    help="'k8s' reconciles real cluster pods over the k8s "
                         "REST API (in-cluster auth, or --kube-url)")
    ap.add_argument("--kube-url", default="",
                    help="k8s API server base URL (empty = in-cluster "
                         "service-account config)")
    ap.add_argument("--namespace", default="",
                    help="pod namespace (default: SA namespace or 'default')")
    ap.add_argument("--pod-workdir", default="",
                    help="in-container shared-workdir mount path substituted "
                         "into {workdir} command tokens (k8s pod api; "
                         "default /workdir)")
    ap.add_argument("--workdir-volume", default="",
                    help="JSON k8s volume source mounted at the pod workdir, "
                         'e.g. \'{"persistentVolumeClaim": {"claimName": '
                         '"train-shared"}}\'')
    ap.add_argument("--resync-s", type=float, default=2.0)
    args = ap.parse_args()
    if args.cr_source == "dir" and not args.watch_dir:
        ap.error("--watch-dir is required with --cr-source dir")

    store = CrStore()
    kube_client = None
    if args.pod_api == "k8s" or args.cr_source == "k8s":
        from easydl_tpu_torch.controller.kube_http import KubeClient

        kube_client = KubeClient(base_url=args.kube_url,
                                 namespace=args.namespace)
    if args.pod_api == "k8s":
        import json

        from easydl_tpu_torch.controller.kube_pod_api import (
            DEFAULT_WORKDIR,
            KubePodApi,
        )

        pod_api = KubePodApi(
            client=kube_client,
            workdir=args.pod_workdir or DEFAULT_WORKDIR,
            workdir_volume=(json.loads(args.workdir_volume)
                            if args.workdir_volume else None),
        )
    else:
        pod_api = InMemoryPodApi()
    ctl = ElasticJobController(store, pod_api)
    # Standalone mode: publish the controller's metrics address under the
    # watch dir (the operator-known location; ingest skips non-YAML
    # entries). In-cluster there is no shared dir — pin the port with
    # EASYDL_METRICS_PORT_CONTROLLER instead (docs/operations.md §4).
    ctl.start(resync_s=args.resync_s,
              obs_workdir=args.watch_dir or None)
    cr_source = None
    if args.cr_source == "k8s":
        from easydl_tpu_torch.controller.kube_cr_source import (
            KubeCrSource,
            make_status_writer,
        )

        store.add_status_sink(make_status_writer(kube_client))
        cr_source = KubeCrSource(store, kube_client).start()
        log.info("operator watching CRs on %s (pod api: %s)",
                 kube_client.base_url, args.pod_api)
    else:
        log.info("operator watching %s (pod api: %s)",
                 args.watch_dir, args.pod_api)
    seen: dict = {}
    pending: set = set()
    try:
        while True:
            if args.cr_source == "dir":
                ingest(store, args.watch_dir, seen, pending)
            if args.pod_api == "memory":
                pod_api.tick()  # the fake cluster needs a clock
            time.sleep(min(args.resync_s, 1.0))
    except KeyboardInterrupt:
        pass
    finally:
        if cr_source is not None:
            cr_source.stop()
        ctl.stop()
        # Drain the async status-sink queue before exiting: the final
        # /status PATCH (often the terminal-phase latch) must not die with
        # the daemon dispatch thread.
        store.flush_status()
        store.close()


if __name__ == "__main__":
    main()
