"""The ``EASYDL_*`` variables the port reads, and their readers: a copy of
``easydl_tpu/utils/env.py``'s typed accessors (:func:`knob_str`,
:func:`knob_int`, :func:`knob_float`, :func:`knob_bool`, :func:`knob_raw`,
:func:`env_flag`, :func:`obs_port_from_env`) and of the declarations the
copied modules read (the PS tier, its WAL, the RPC layer's metrics
exporter, tracing, chaos, the elastic control plane, the serving tier,
the production loop, the operator and the fleet scrape), with the JAX
package's names, types, defaults and help text. The port declares no variable of its own:
``tests/test_torch_port_rules.py`` holds every name here to the JAX
package's ``KNOB_DECLS``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

#: (name, type, default, help), as in the JAX package. type ∈
#: {str,int,float,bool}; default None means REQUIRED — reading it when
#: unset raises KeyError.
KNOB_DECLS = (
    # -- identity / job wiring (set by launchers, read by services) ------
    ("EASYDL_WORKDIR", "str", None,
     "Job working directory: journals, WAL roots, checkpoints, metrics "
     "files, timelines all live under it."),
    ("EASYDL_JOB", "str", "",
     "Job name a pod belongs to (controller process/kube backends)."),
    ("EASYDL_POD_NAME", "str", "",
     "Pod name injected by the controller backends (PS pod identity)."),
    ("EASYDL_POD_ROLE", "str", "",
     "Pod role (ps/master/agent/serve) injected by controller backends."),
    ("EASYDL_REPLACES", "str", "",
     "Pod name a rescue PS shard replaces (claims its WAL + shard slot)."),
    ("EASYDL_RESHARD_DEST", "bool", False,
     "Marks a PS pod as a live-reshard destination (skips rescue probe)."),
    # -- elastic control plane -------------------------------------------
    ("EASYDL_MASTER_WAIT_S", "float", 600.0,
     "How long an agent waits for a master before giving up."),
    ("EASYDL_MESH_PIN", "str", "",
     "Operator override: pin the elastic mesh-shape policy to this shape "
     "key ('dp=8'); invalid-for-world pins fall back to the policy."),
    ("EASYDL_GCE_METADATA_URL", "str", "",
     "GCE metadata server override (tests, proxies)."),
    # -- metrics exporter ------ --------------------------------------
    ("EASYDL_METRICS_HOST", "str", "",
     "Bind host for /metrics exporters (default localhost)."),
    ("EASYDL_METRICS_PORT", "int", 0,
     "Exporter port for all components; 0 picks a free port; "
     "off/disabled/negative disables."),
    ("EASYDL_METRICS_PORT_PS", "int", 0,
     "Exporter port for PS shard pods."),
    ("EASYDL_METRICS_PORT_CONTROLLER", "int", 0,
     "Exporter port for the controller/operator."),
    ("EASYDL_METRICS_PORT_SERVE", "int", 0,
     "Exporter port for serving replicas."),
    # -- tracing ----------------------------------------------------------
    ("EASYDL_TRACE", "str", "",
     "Arms distributed tracing; ''/0/off/false/no/disabled/none = off."),
    ("EASYDL_TRACE_CONTEXT", "str", "",
     "Injected parent span context (subprocess hop of propagation)."),
    ("EASYDL_TRACE_PROC", "str", "",
     "Process name override for the flight recorder."),
    ("EASYDL_TRACE_MAX_BYTES", "int", 8_388_608,  # 8 MiB
     "Flight-recorder ring size per process."),
    # -- parameter server -------------------------------------------------
    ("EASYDL_PS_WAL", "bool", True,
     "Push write-ahead log on/off (zero-loss recovery)."),
    ("EASYDL_PS_WAL_SEGMENT_BYTES", "int", 33_554_432,  # 32 MiB
     "WAL segment roll size."),
    ("EASYDL_PS_WAL_SYNC_S", "float", 0.2,
     "WAL fsync cadence; 0 = fsync every append."),
    ("EASYDL_PS_FENCE_CHECK_S", "float", 0.5,
     "Zombie self-check cadence against the registry epoch."),
    ("EASYDL_PS_PROBE_TIMEOUT_S", "float", 5.0,
     "Rescue probe per-attempt timeout."),
    ("EASYDL_PS_PROBE_RETRIES", "int", 2,
     "Rescue probe attempts before declaring a shard dead."),
    ("EASYDL_PS_CHUNK_BYTES", "int", 1_048_576,  # 1 MiB
     "Client-side pull/push chunking target."),
    ("EASYDL_PS_COALESCE", "bool", True,
     "Duplicate-id coalescing on pull (trainer path defaults off)."),
    ("EASYDL_PS_RAW_IDS", "bool", True,
     "Zero-copy raw-bytes id wire format (falls back per shard)."),
    ("EASYDL_PS_PULL_FP16", "bool", False,
     "Negotiate fp16 pull payloads (halves the wire)."),
    ("EASYDL_PS_PULL_I8", "bool", False,
     "Negotiate int8 pull payloads (per-row symmetric quantization, "
     "~0.25x the f32 wire; serving replicas only — the trainer keeps "
     "f32)."),
    ("EASYDL_PS_SHM", "bool", False,
     "Zero-copy shared-memory pull transport: shards mirror tables into "
     "named shm segments, co-located clients gather rows directly "
     "(seqlock-validated) and fall back to gRPC on any mismatch."),
    ("EASYDL_PS_SHM_MAX_MB", "int", 256,
     "Per-table shm mirror capacity cap; a table outgrowing it revokes "
     "the mirror (clients fall back to the wire)."),
    ("EASYDL_PS_STORE_LOOP", "bool", False,
     "Force the python reference row-apply loop (bench comparisons)."),
    ("EASYDL_PS_TIER_HOT_MB", "int", 0,
     "Hot-tier byte budget per shard for the two-tier native store; 0 = "
     "single-tier (no cold spill)."),
    ("EASYDL_PS_TIER_COLD_MB", "int", 4096,
     "Cold-tier mmap file capacity per table (under the shard workdir)."),
    ("EASYDL_PS_TIER_PROMOTE_INTERVAL_S", "float", 2.0,
     "Tier maintenance cadence: decay frequencies, demote cold hot rows, "
     "promote warm cold rows."),
    ("EASYDL_PS_TIER_DECAY", "float", 0.9,
     "Per-tick multiplicative access-frequency decay (ages out "
     "yesterday's hot set)."),
    ("EASYDL_PS_SPLIT_HOT_RATIO", "float", 1.5,
     "Hot-shard split trigger: shard rows vs mean ratio."),
    ("EASYDL_PS_SPLIT_MIN_ROWS", "float", 100_000.0,
     "Minimum total rows before split decisions engage."),
    ("EASYDL_PS_SPLIT_MAX_SHARDS", "int", 64,
     "Upper bound on PS shard fan-out from auto-splits."),
    ("EASYDL_PS_SPLIT_ACCESS_RATIO", "float", 2.0,
     "Max/mean per-shard access ratio that counts as hot-working-set "
     "skew (the two-tier split trigger)."),
    # -- serving ----------------------------------------------------------
    ("EASYDL_SERVE_TARGET_QPS", "float", 500.0,
     "Per-replica QPS target for the autoscale policy."),
    ("EASYDL_SERVE_P99_BUDGET_S", "float", 0.050,
     "p99 latency budget for the autoscale policy."),
    ("EASYDL_SERVE_MIN_REPLICAS", "int", 1,
     "Autoscale floor for serving replicas."),
    ("EASYDL_SERVE_MAX_REPLICAS", "int", 64,
     "Autoscale ceiling for serving replicas."),
    # -- serve fleet router ------------------------------------------------
    ("EASYDL_SERVE_HEDGE_BUDGET", "float", 0.1,
     "Hedged-request budget: max fraction of recent routed requests that "
     "may carry a hedge (a sick fleet must not double its own load); "
     "<= 0 disables hedging."),
    ("EASYDL_SERVE_HEDGE_MIN_MS", "float", 5.0,
     "Floor for the p95-derived hedge delay."),
    ("EASYDL_SERVE_HEDGE_MAX_MS", "float", 200.0,
     "Ceiling for the p95-derived hedge delay."),
    ("EASYDL_SERVE_ROUTER_HOLDDOWN_S", "float", 2.0,
     "Hold-down before an ejected replica is re-probed for rotation."),
    ("EASYDL_SERVE_ROUTER_EJECT_FAILS", "int", 3,
     "Consecutive transport failures (or hard sheds) that eject a "
     "replica from rotation."),
    ("EASYDL_SERVE_ROUTER_REFRESH_S", "float", 1.0,
     "Replica discovery refresh cadence (workdir serve/ registry scan)."),
    # -- production loop: feedback stream + rollout -----------------------
    ("EASYDL_FEEDBACK_SPOOL_BYTES", "int", 268_435_456,  # 256 MiB
     "Per-replica feedback spool byte bound; past it (after retiring "
     "trainer-consumed segments) new events DROP with a count — the "
     "spool never blocks or fails a serve request."),
    ("EASYDL_FEEDBACK_SEGMENT_BYTES", "int", 8_388_608,  # 8 MiB
     "Feedback spool segment roll size."),
    ("EASYDL_FEEDBACK_SYNC_S", "float", 0.2,
     "Feedback spool fsync cadence; 0 = every append, negative = never."),
    ("EASYDL_FEEDBACK_POLL_S", "float", 0.2,
     "Continuous-trainer poll cadence on an exhausted spool "
     "(block-with-timeout, never terminate)."),
    ("EASYDL_FEEDBACK_LABEL_HORIZON_S", "float", 60.0,
     "Delayed-label join horizon: a serve event unlabeled past it trains "
     "with the implicit negative label."),
    ("EASYDL_ROLLOUT_POLL_S", "float", 0.5,
     "Serve-side model-publication watcher poll cadence."),
    ("EASYDL_ROLLOUT_KEEP", "int", 4,
     "Committed model versions the publisher keeps on disk."),
    ("EASYDL_ROLLOUT_CANARY_FRACTION", "float", 0.1,
     "Session-hash fraction routed to the canary arm while one is "
     "active (sessions without an id always serve control)."),
    ("EASYDL_ROLLOUT_SALT", "str", "",
     "Session->arm hash salt; rotate to reshuffle the A/B population."),
    # -- retrieval (read by the serving frontend) -------------------------
    ("EASYDL_RETRIEVAL_USER_TABLE", "str", "tt_user",
     "PS table holding the user-tower context embeddings."),
    ("EASYDL_RETRIEVAL_K", "int", 10,
     "Default candidate count a Retrieve request gets when it asks for "
     "k<=0."),
    ("EASYDL_RETRIEVAL_NPROBE", "int", 8,
     "Centroid buckets probed per query; >= nlist degenerates to exact "
     "brute force."),
    # -- SLOs / alerting -------------------------------------------------
    ("EASYDL_SCRAPE_POOL", "int", 8,
     "Bounded worker pool for concurrent fleet scrapes "
     "(obs.scrape.scrape_fleet)."),
    # -- chaos / harness child markers ------------------------------------
    ("EASYDL_CHAOS_SPEC", "str", "",
     "Armed chaos scenario spec path; unset = every hook is one dict "
     "lookup."),
)


@dataclass(frozen=True)
class Knob:
    name: str
    type: str
    default: object
    help: str


KNOBS: Dict[str, Knob] = {d[0]: Knob(*d) for d in KNOB_DECLS}

_UNSET = object()


def _declared(name: str) -> Knob:
    k = KNOBS.get(name)
    if k is not None:
        return k
    raise KeyError(
        f"{name} is not declared in easydl_tpu_torch.utils.env.KNOB_DECLS: the port "
        "reads only variables that easydl_tpu/utils/env.py declares")


def knob_raw(name: str, env: Optional[Mapping[str, str]] = None,
             ) -> Optional[str]:
    """The declared-but-untyped read: raw value or None when unset. For
    save/restore idioms and presence checks; typed reads use knob_*."""
    _declared(name)
    return (env if env is not None else os.environ).get(name)


def _resolve(name: str, default, env) -> Optional[str]:
    knob = _declared(name)
    v = (env if env is not None else os.environ).get(name)
    if v is not None:
        return v
    d = knob.default if default is _UNSET else default
    if d is None:
        raise KeyError(f"required knob {name} is not set")
    return d


def knob_str(name: str, default=_UNSET,
             env: Optional[Mapping[str, str]] = None) -> str:
    return str(_resolve(name, default, env))


def knob_int(name: str, default=_UNSET,
             env: Optional[Mapping[str, str]] = None) -> int:
    return int(_resolve(name, default, env))


def knob_float(name: str, default=_UNSET,
               env: Optional[Mapping[str, str]] = None) -> float:
    return float(_resolve(name, default, env))


def knob_bool(name: str, default=_UNSET,
              env: Optional[Mapping[str, str]] = None) -> bool:
    v = _resolve(name, default, env)
    if isinstance(v, bool):
        return v
    return v not in ("", "0", "false", "False")


def env_flag(name: str, default: bool) -> bool:
    """Boolean EASYDL_* knob convention: unset → ``default``; ``"0"``,
    ``"false"``/``"False"`` and empty mean off; anything else means on.
    (Deliberately lenient about undeclared names — tests mint throwaway
    flags; the knob-registry lint still checks literal in-tree uses.)"""
    v = os.environ.get(name)
    if v is None:
        return default
    return v not in ("", "0", "false", "False")


def obs_port_from_env(component: str, default: int = 0):
    """Resolve a service's metrics-exporter port from the environment.

    Precedence: ``EASYDL_METRICS_PORT`` + ``_<COMPONENT>`` (component
    upper-cased, non-alnum → ``_``) > ``EASYDL_METRICS_PORT`` > ``default`` (0 = pick a
    free port). ``off``/``disabled``/negative disables the exporter —
    returns None. Unparseable values fall back to the default rather than
    killing the service: observability must never be load-bearing."""
    key = "EASYDL_METRICS_PORT" + "_" + "".join(
        c if c.isalnum() else "_" for c in component
    ).upper()
    raw = os.environ.get(key) or os.environ.get("EASYDL_METRICS_PORT")
    if raw is None:
        return default
    raw = raw.strip().lower()
    if raw in ("off", "disabled", "none", "false"):
        return None
    try:
        port = int(raw)
    except ValueError:
        return default
    if port < 0:
        return None
    if port > 65535:  # a typo'd port must not take the service down
        return default
    return port
