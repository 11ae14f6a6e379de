"""Reconcile decision function: (ResourcePlan, observed pods) → pod ops.

The C++ core (native/reconciler_core.cc) is the production decision engine;
:func:`_py_reconcile` is its pure-Python twin (same wire format, same rules)
used when no toolchain exists — and pinned to the core by a parity test
(tests/test_controller.py) so the two can't drift.

Semantics implemented (all from the reference design doc):
- failed pods are retired and their slots recreated (README.md:26-29);
- ``resource_updation`` entries replace-then-retire: new pod first, old pod
  deleted only when the replacement is Running
  (docs/design/elastic-training-operator.md:99-101);
- per-role replica counts are levelled, creating fresh names / deleting the
  highest indices (:53-55, :97-98).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from easydl_tpu_torch.api.job_spec import ResourceSpec
from easydl_tpu_torch.api.resource_plan import ResourcePlan
from easydl_tpu_torch.controller.pod_api import Pod
from easydl_tpu_torch.utils.native import load_native
from easydl_tpu_torch.utils.env import knob_float, knob_int
from easydl_tpu_torch.obs.errors import count_swallowed

_SOURCE = os.path.join(os.path.dirname(__file__), "native", "reconciler_core.cc")


def _bind(lib: ctypes.CDLL) -> None:
    lib.edr_reconcile.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.edr_reconcile.restype = ctypes.c_void_p  # manual free via edr_free
    lib.edr_free.argtypes = [ctypes.c_void_p]


def resource_sig(resource: ResourceSpec) -> str:
    """Deterministic short signature identifying a resource shape.

    Used to materialise CREATE ops back into full specs and to *detect* (not
    act on) role-level resource drift: per the reference, a changed role
    resource applies to newly created pods only — existing pods are resized
    exclusively through explicit ``resource_updation`` replace-then-retire
    entries (docs/design/elastic-training-operator.md:86-101). The operator
    logs drift so users know a resource_updation is needed."""
    blob = json.dumps(resource.to_dict(), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


@dataclass(frozen=True)
class PodOp:
    verb: str  # "CREATE" | "DELETE"
    name: str
    role: str = ""
    resource_sig: str = ""
    replaces: str = ""
    reason: str = ""


def encode_desired(job: str, plan: ResourcePlan) -> Tuple[str, Dict[str, ResourceSpec]]:
    """Wire-encode the plan; also return sig→ResourceSpec so ops can be
    materialised back into full pod specs."""
    sigs: Dict[str, ResourceSpec] = {}
    lines = [f"J|{job}"]
    for role, rp in plan.roles.items():
        sig = resource_sig(rp.resource)
        sigs[sig] = rp.resource
        lines.append(f"R|{role}|{rp.replicas}|{sig}")
    for u in plan.resource_updation:
        sig = resource_sig(u.resource)
        sigs[sig] = u.resource
        lines.append(f"U|{u.name}|{sig}")
    return "\n".join(lines) + "\n", sigs


def encode_observed(pods: List[Pod]) -> str:
    return "".join(
        f"P|{p.name}|{p.role}|{p.phase}|{resource_sig(p.resource)}|{p.replaces}\n"
        for p in pods
    )


def decode_ops(text: str) -> List[PodOp]:
    ops: List[PodOp] = []
    for line in text.splitlines():
        if not line:
            continue
        f = line.split("|")
        if f[0] == "CREATE":
            ops.append(PodOp("CREATE", f[1], role=f[2], resource_sig=f[3],
                             replaces=f[4] if len(f) > 4 else ""))
        elif f[0] == "DELETE":
            ops.append(PodOp("DELETE", f[1], reason=f[2] if len(f) > 2 else ""))
    return ops


# --------------------------------------------------------------- python twin


def _trailing_index(name: str) -> int:
    head, _, tail = name.rpartition("-")
    return int(tail) if head and tail.isdigit() else -1


def _py_reconcile(desired: str, observed: str) -> str:
    job, roles, updations, pods = "", {}, [], []
    frozen_roles = set()  # malformed replicas: don't level this pass
    for line in desired.splitlines():
        f = line.split("|")
        if f[0] == "J" and len(f) >= 2:
            job = f[1]
        elif f[0] == "R" and len(f) >= 4:
            # ASCII-digits-only, max 7 digits — matching the C++ core's
            # validation exactly (not int(): that accepts "+3"/" 3"/unicode
            # digits and unbounded magnitudes the core rejects). A malformed
            # count freezes the role — falling through to the
            # absent-role-means-0 fallback would delete every healthy pod.
            if f[2] and len(f[2]) <= 7 and all("0" <= c <= "9" for c in f[2]):
                roles[f[1]] = (int(f[2]), f[3])
            else:
                frozen_roles.add(f[1])
        elif f[0] == "U" and len(f) >= 3:
            updations.append((f[1], f[2]))
    for line in observed.splitlines():
        f = line.split("|")
        if f[0] == "P" and len(f) >= 6:
            pods.append(
                {"name": f[1], "role": f[2], "phase": f[3], "sig": f[4],
                 "replaces": f[5], "index": _trailing_index(f[1])}
            )

    next_index: Dict[str, int] = {}
    for p in pods:
        next_index[p["role"]] = max(next_index.get(p["role"], 0), p["index"] + 1)

    def next_name(role: str) -> str:
        n = next_index[role] = next_index.get(role, 0)
        next_index[role] = n + 1
        return f"{job}-{role}-{n}"

    ops: List[str] = []
    gone = set()
    for p in pods:
        if p["phase"] == "Failed":
            ops.append(f"DELETE|{p['name']}|failed")
            gone.add(p["name"])

    by_name = {p["name"]: p for p in pods if p["name"] not in gone}
    replacement_of = {
        p["replaces"]: p
        for p in pods
        if p["name"] not in gone and p["replaces"] and p["replaces"] in by_name
    }

    for name, sig in updations:
        old = by_name.get(name)
        # Succeeded pods completed their work: resizing one is meaningless
        # and replacing it would re-run finished work (the completion loop).
        if old is None or old["phase"] in ("Terminating", "Succeeded"):
            continue
        rep = replacement_of.get(name)
        if rep is not None:
            if rep["phase"] == "Running":
                ops.append(f"DELETE|{name}|replaced")
                gone.add(name)
        else:
            ops.append(f"CREATE|{next_name(old['role'])}|{old['role']}|{sig}|{name}")

    # Roles with pods but absent from the plan mean replicas 0 (omission must
    # not orphan pods); trainer is operator-owned, never levelled here.
    for p in pods:
        if (p["role"] != "trainer" and p["role"] not in roles
                and p["role"] not in frozen_roles):
            roles[p["role"]] = (0, "")

    def replacement_in_flight(p) -> bool:
        # Excluded from the count only while the pod it replaces still serves.
        if not p["replaces"] or p["replaces"] in gone:
            return False
        old = by_name.get(p["replaces"])
        return old is not None and old["phase"] in ("Pending", "Running")

    for role in sorted(roles):  # C++ core iterates a std::map: sorted
        want, sig = roles[role]
        # Succeeded pods fill their slot permanently (k8s Job semantics): a
        # worker only exits 0 when its work is COMPLETE, so the slot must not
        # be refilled — recreating it re-runs "job done" forever (a
        # completion loop). Succeeded pods are retained, never scale_down'd;
        # any job-end GC is an explicit operator action, not a levelling one.
        done = sum(
            1 for p in pods
            if p["role"] == role and p["name"] not in gone
            and p["phase"] == "Succeeded"
        )
        need = max(0, want - done)
        active = [
            p for p in pods
            if p["role"] == role and p["name"] not in gone
            and p["phase"] in ("Pending", "Running")
            and not replacement_in_flight(p)
        ]
        for _ in range(max(0, need - len(active))):
            ops.append(f"CREATE|{next_name(role)}|{role}|{sig}|")
        if len(active) > need:
            for p in sorted(active, key=lambda p: -p["index"])[: len(active) - need]:
                ops.append(f"DELETE|{p['name']}|scale_down")
                gone.add(p["name"])
    return "".join(op + "\n" for op in ops)


def reconcile_wire(desired: str, observed: str, force_python: bool = False) -> str:
    """Run the decision function on wire-format inputs."""
    lib = None if force_python else load_native(_SOURCE, _bind)
    if lib is None:
        return _py_reconcile(desired, observed)
    ptr = lib.edr_reconcile(desired.encode(), observed.encode())
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        lib.edr_free(ptr)


def reconcile(job: str, plan: ResourcePlan, pods: List[Pod],
              force_python: bool = False) -> Tuple[List[PodOp], Dict[str, ResourceSpec]]:
    """High-level entry: returns (ops, sig→ResourceSpec)."""
    desired, sigs = encode_desired(job, plan)
    observed = encode_observed(pods)
    return decode_ops(reconcile_wire(desired, observed, force_python)), sigs


# ----------------------------------------------------- PS hot-shard split

#: Skew triggers (env-overridable where maybe_split_ps is wired into a
#: loop): a split pays a full table migration, so it needs BOTH a
#: genuinely hot shard (skew the hash layout cannot fix by itself) and a
#: tier big enough that the imbalance matters. The ratio is against the
#: MEAN, whose max is the shard count itself (one shard holding all
#: rows) — 1.5 fires on real Zipf skew while a ratio ≥ the shard count
#: could never fire at all.
PS_SPLIT_HOT_RATIO = 1.5
PS_SPLIT_MIN_ROWS = 100_000
PS_SPLIT_MAX_SHARDS = 64
#: Access skew fires later than row skew (2.0 vs 1.5): pull traffic is
#: noisier than resident rows (a batch of lookups against one shard
#: spikes the counter without meaning sustained heat), so the trigger
#: demands a wider margin before paying a migration for it.
PS_SPLIT_ACCESS_RATIO = 2.0


def ps_split_decision(shard_rows: Dict[int, float], num_shards: int,
                      hot_ratio: float = PS_SPLIT_HOT_RATIO,
                      min_total_rows: float = PS_SPLIT_MIN_ROWS,
                      max_shards: int = PS_SPLIT_MAX_SHARDS,
                      shard_access: Optional[Dict[int, float]] = None,
                      access_ratio: float = PS_SPLIT_ACCESS_RATIO,
                      ) -> Optional[int]:
    """Pure decision: observed per-shard row counts (and optionally
    per-shard access counts) → target shard count for an online split
    (ps/reshard.py), or None.

    Doubles the shard count when the hottest shard holds ≥ ``hot_ratio``
    × the mean row count (static hash-sharding concentrating a Zipf id
    stream), OR — when ``shard_access`` is supplied — when one shard
    serves ≥ ``access_ratio`` × the mean access count. The second
    trigger exists for the two-tier store: a shard can be balanced by
    resident ROWS yet concentrate the hot WORKING SET, burning its hot
    arena on traffic the hash layout cannot spread. Both triggers share
    the ``min_total_rows`` floor (a small table never pays a migration,
    however skewed its traffic) and the ``max_shards`` cap. Callers
    that pass no access counts get the legacy row-count-only verdict,
    bit for bit. Deliberately the same shape as the reconcile core:
    pure inputs → pure verdict, so policy is unit-testable without a
    live tier."""
    if num_shards <= 0 or not shard_rows:
        return None
    total = float(sum(shard_rows.values()))
    if total < float(min_total_rows):
        return None
    target = num_shards * 2
    if target > max_shards:
        return None
    hottest = max(shard_rows.values())
    if hottest >= hot_ratio * (total / num_shards):
        return target
    if shard_access:
        atotal = float(sum(shard_access.values()))
        if atotal > 0.0:
            ahot = max(shard_access.values())
            if ahot >= access_ratio * (atotal / num_shards):
                return target
    return None


def maybe_split_ps(workdir: str,
                   hot_ratio: Optional[float] = None,
                   min_total_rows: Optional[float] = None,
                   max_shards: Optional[int] = None) -> Optional[int]:
    """Scrape the live PS tier's ``easydl_ps_table_rows`` gauges (the
    per-shard telemetry) from the job workdir's exporters and run
    :func:`ps_split_decision` over them. Returns the recommended target
    shard count, or None.

    Recommendation only — it never writes a migration plan: a plan in
    the routing table gates freshly-rescued source pods (ps/__main__.py),
    so claiming one without a coordinator ready to execute it would
    degrade the tier for nothing. The caller hands the verdict to
    ``ps.reshard.run_reshard``, which claims the plan itself. Skipped
    (None) while a plan is already in flight.

    The thresholds default from the environment
    (``EASYDL_PS_SPLIT_HOT_RATIO`` / ``EASYDL_PS_SPLIT_MIN_ROWS`` /
    ``EASYDL_PS_SPLIT_MAX_SHARDS`` / ``EASYDL_PS_SPLIT_ACCESS_RATIO``)
    so a deployed operator loop is tunable without a rollout; explicit
    args win."""
    import re as _re

    if hot_ratio is None:
        hot_ratio = knob_float("EASYDL_PS_SPLIT_HOT_RATIO",
                               PS_SPLIT_HOT_RATIO)
    if min_total_rows is None:
        min_total_rows = knob_float("EASYDL_PS_SPLIT_MIN_ROWS",
                                    PS_SPLIT_MIN_ROWS)
    if max_shards is None:
        max_shards = knob_int("EASYDL_PS_SPLIT_MAX_SHARDS",
                              PS_SPLIT_MAX_SHARDS)
    access_ratio = knob_float("EASYDL_PS_SPLIT_ACCESS_RATIO",
                              PS_SPLIT_ACCESS_RATIO)

    from easydl_tpu_torch.obs.scrape import merge_snapshot
    from easydl_tpu_torch.ps import registry as ps_registry

    rt = ps_registry.routing_table(workdir)
    if rt.get("plan"):
        return None
    smap = ps_registry.shard_map(workdir)
    num_shards = int(rt.get("num_shards", 0))
    if num_shards <= 0:
        if not smap:
            return None
        num_shards = max(int(d["num_shards"]) for d in smap.values())
    try:
        snap = merge_snapshot(workdir=workdir)
    except Exception as e:
        count_swallowed("controller.split_snapshot", e)
        return None
    # Per-service, filtered to the COMMITTED generation's pods — not the
    # blind merge: after a reshard the superseded sources are gated but
    # alive, still exporting easydl_ps_table_rows under the same shard
    # labels, and last-write-wins across exporters would hand the
    # decision phantom (pre-split) counts.
    committed = {f"ps-{d['pod']}" for d in smap.values() if d.get("pod")}
    rows_re = _re.compile(r'^easydl_ps_table_rows\{.*shard="(\d+)"')
    # Access signal for the two-tier store: a shard balanced by resident
    # rows can still concentrate the hot working set. Cumulative served-id
    # counters are a coarse proxy for that heat — good enough here because
    # the decision only compares shards against each other and the
    # counters all started at the same reshard generation.
    pulls_re = _re.compile(r'^easydl_ps_pull_ids_total\{.*shard="(\d+)"')
    shard_rows: Dict[int, float] = {}
    shard_access: Dict[int, float] = {}
    for component, svc in (snap.get("services") or {}).items():
        if component not in committed:
            continue
        for series, value in (svc.get("metrics") or {}).items():
            m2 = rows_re.match(series)
            if m2:
                s = int(m2.group(1))
                shard_rows[s] = shard_rows.get(s, 0.0) + float(value)
                continue
            m3 = pulls_re.match(series)
            if m3:
                s = int(m3.group(1))
                shard_access[s] = shard_access.get(s, 0.0) + float(value)
    return ps_split_decision(shard_rows, num_shards, hot_ratio=hot_ratio,
                             min_total_rows=min_total_rows,
                             max_shards=max_shards,
                             shard_access=shard_access,
                             access_ratio=access_ratio)


# ------------------------------------------------- serve replica autoscale

#: Replica-policy defaults (env-overridable through maybe_scale_serve):
#: a replica is "full" at SERVE_TARGET_QPS_PER_REPLICA, and p99 past the
#: budget means queueing — scale up even when the QPS math says there is
#: headroom (latency is the symptom the batch queue shows FIRST when the
#: forward or the PS pull saturates). Scale-down needs the fleet
#: comfortably under target (hysteresis) so a noisy minute can't flap
#: replicas — the serving twin of the straggler hold-down.
SERVE_TARGET_QPS_PER_REPLICA = 500.0
SERVE_P99_BUDGET_S = 0.050
SERVE_MIN_REPLICAS = 1
SERVE_MAX_REPLICAS = 64
SERVE_SCALE_DOWN_FRACTION = 0.4


def serve_scale_decision(replica_qps: Dict[str, float],
                         replica_p99: Dict[str, float],
                         target_qps: float = SERVE_TARGET_QPS_PER_REPLICA,
                         p99_budget_s: float = SERVE_P99_BUDGET_S,
                         min_replicas: int = SERVE_MIN_REPLICAS,
                         max_replicas: int = SERVE_MAX_REPLICAS,
                         scale_down_fraction: float =
                         SERVE_SCALE_DOWN_FRACTION,
                         router_offered_qps: Optional[float] = None,
                         router_replicas: Optional[int] = None,
                         router_p99_s: Optional[float] = None
                         ) -> Optional[int]:
    """Pure decision: observed per-replica QPS and p99 → target replica
    count, or None for "leave it alone". Same shape as
    :func:`ps_split_decision`: pure inputs → pure verdict, unit-testable
    without a live tier.

    - **capacity**: enough replicas that total QPS / replica ≤ target;
    - **latency**: any replica's p99 past the budget adds at least one
      replica even under the QPS target (queueing has started);
    - **hysteresis**: scale down only when total QPS would keep even the
      SHRUNK fleet under ``scale_down_fraction`` × target per replica and
      every p99 is under half the budget.

    ``router_*`` are the fleet router's door-side observations, and when
    present they are AUTHORITATIVE for what they measure: offered load
    (completed AND shed AND requests routed to replicas whose exporters
    this scrape cannot see — remote hosts, mid-crash replicas) and the
    true fleet size. Summing whichever replica gauges happened to get
    scraped UNDER-counts both: a 3-replica fleet at 60% each whose
    router answered the scrape but whose replicas didn't would otherwise
    read as one idle replica and scale to the floor."""
    replicas = max(len(replica_qps), int(router_replicas or 0))
    if replicas <= 0 or target_qps <= 0:
        return None
    total_qps = float(sum(replica_qps.values()))
    if router_offered_qps is not None:
        # The door sees every request; replicas see only what reached
        # them. max(): a stale router gauge must not hide replica load.
        total_qps = max(total_qps, float(router_offered_qps))
    worst_p99 = max(replica_p99.values(), default=0.0)
    if router_p99_s is not None:
        worst_p99 = max(worst_p99, float(router_p99_s))
    need_capacity = max(1, math.ceil(total_qps / target_qps))
    want = replicas
    if worst_p99 > p99_budget_s:
        want = max(need_capacity, replicas + 1)
    elif need_capacity > replicas:
        want = need_capacity
    elif (replicas > min_replicas
          and worst_p99 < 0.5 * p99_budget_s
          and total_qps < (scale_down_fraction * target_qps
                           * (replicas - 1))):
        want = max(need_capacity, min_replicas, replicas - 1)
    want = max(min_replicas, min(max_replicas, want))
    return want if want != replicas else None


def maybe_scale_serve(workdir: str,
                      target_qps: Optional[float] = None,
                      p99_budget_s: Optional[float] = None,
                      min_replicas: Optional[int] = None,
                      max_replicas: Optional[int] = None) -> Optional[int]:
    """Scrape every serving replica's rolling ``easydl_serve_qps_recent``
    / ``easydl_serve_p99_seconds_recent`` gauges (the exporters under
    the job workdir) and run :func:`serve_scale_decision` over them.
    Returns the recommended replica count, or None.

    Recommendation only, like :func:`maybe_split_ps`: the operator loop
    (or a human reading the runbook) levels the replica set — the same
    CREATE/DELETE pod mechanics every other role uses. Thresholds default
    from ``EASYDL_SERVE_TARGET_QPS`` / ``EASYDL_SERVE_P99_BUDGET_S`` /
    ``EASYDL_SERVE_MIN_REPLICAS`` / ``EASYDL_SERVE_MAX_REPLICAS``;
    explicit args win."""
    import re as _re

    if target_qps is None:
        target_qps = knob_float("EASYDL_SERVE_TARGET_QPS",
                                SERVE_TARGET_QPS_PER_REPLICA)
    if p99_budget_s is None:
        p99_budget_s = knob_float("EASYDL_SERVE_P99_BUDGET_S",
                                  SERVE_P99_BUDGET_S)
    if min_replicas is None:
        min_replicas = knob_int("EASYDL_SERVE_MIN_REPLICAS",
                                SERVE_MIN_REPLICAS)
    if max_replicas is None:
        max_replicas = knob_int("EASYDL_SERVE_MAX_REPLICAS",
                                SERVE_MAX_REPLICAS)

    from easydl_tpu_torch.obs.scrape import merge_snapshot

    try:
        snap = merge_snapshot(workdir=workdir)
    except Exception as e:
        count_swallowed("controller.serve_snapshot", e)
        return None
    qps_re = _re.compile(r'^easydl_serve_qps_recent\{.*replica="([^"]+)"')
    p99_re = _re.compile(
        r'^easydl_serve_p99_seconds_recent\{.*replica="([^"]+)"')
    # Fleet router gauges (easydl_tpu_torch/serve/router.py): door-side offered
    # load + true rotation size. Summed / maxed across routers.
    r_qps_re = _re.compile(
        r'^easydl_serve_router_offered_qps_recent\{.*replica="([^"]+)"')
    r_live_re = _re.compile(
        r'^easydl_serve_router_live_replicas\{.*replica="([^"]+)"')
    r_p99_re = _re.compile(
        r'^easydl_serve_router_p99_seconds_recent\{.*replica="([^"]+)"')
    replica_qps: Dict[str, float] = {}
    replica_p99: Dict[str, float] = {}
    router_offered: Dict[str, float] = {}
    router_live: Dict[str, float] = {}
    router_p99: Dict[str, float] = {}
    for _component, svc in (snap.get("services") or {}).items():
        for series, value in (svc.get("metrics") or {}).items():
            for rx, sink in ((qps_re, replica_qps), (p99_re, replica_p99),
                             (r_qps_re, router_offered),
                             (r_live_re, router_live),
                             (r_p99_re, router_p99)):
                m = rx.match(series)
                if m:
                    sink[m.group(1)] = float(value)
                    break
    if not replica_qps and not router_offered:
        return None
    return serve_scale_decision(
        replica_qps, replica_p99, target_qps=target_qps,
        p99_budget_s=p99_budget_s, min_replicas=min_replicas,
        max_replicas=max_replicas,
        router_offered_qps=(sum(router_offered.values())
                            if router_offered else None),
        router_replicas=(int(max(router_live.values()))
                         if router_live else None),
        router_p99_s=(max(router_p99.values()) if router_p99 else None))
