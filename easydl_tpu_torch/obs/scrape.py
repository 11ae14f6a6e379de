"""Scrape-side half of the telemetry layer: fetch, parse, and merge.

``scripts/obs_scrape.py`` is a thin CLI over this module; the functions live
in the package so tests (and the Brain, later) can consume fleet snapshots
programmatically. Discovery reads the address files every exporter publishes
under ``<workdir>/obs/`` (easydl_tpu_torch/obs/exporter.py) — the shared job
workdir already is the rendezvous point for master.json and the PS registry,
so it is the natural scrape inventory too.
"""

from __future__ import annotations

import json
import os
import re
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from easydl_tpu_torch.obs.exporter import OBS_DIR
from easydl_tpu_torch.utils.env import knob_int

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^}]*\})?\s+(?P<value>\S+)"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_text(text: str) -> Dict[str, float]:
    """Prometheus text format → flat ``{'name{k="v"}': value}`` dict.

    Labels are re-serialized in sorted-key order so the same series from
    two scrapes always merges onto one key."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = m.group("labels") or ""
        if labels:
            pairs = sorted(_LABEL_RE.findall(labels))
            labels = "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"
        out[m.group("name") + labels] = value
    return out


def fetch(address: str, path: str = "/metrics",
          timeout: float = 5.0) -> str:
    url = f"http://{address}{path}"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8", errors="replace")


def scrape_target(address: str, timeout: float = 5.0) -> Dict[str, object]:
    """One endpoint → {'ok', 'metrics', 'health'} (never raises: a dead
    service is a data point, not a scrape failure)."""
    doc: Dict[str, object] = {"address": address, "ok": False,
                              "metrics": {}, "health": None}
    try:
        doc["metrics"] = parse_text(fetch(address, "/metrics", timeout))
        doc["ok"] = True
    except Exception as e:
        doc["error"] = repr(e)
        return doc
    try:
        doc["health"] = json.loads(fetch(address, "/healthz", timeout))
    except Exception:
        pass  # metrics answered; health is advisory
    return doc


def scrape_fleet(targets: Dict[str, str], timeout: float = 5.0,
                 pool: Optional[int] = None) -> Dict[str, Dict[str, object]]:
    """``{component: address}`` → ``{component: scrape_target(...)}``,
    fetched CONCURRENTLY through a bounded worker pool (default
    ``EASYDL_SCRAPE_POOL``). Serial scraping does not survive scale: a
    100-replica fleet with one dead exporter at the 5 s per-target
    timeout turns every snapshot into minutes of wall clock, which is
    exactly when the snapshot matters most.

    Every attempt increments ``easydl_scrape_attempts_total{target}`` in
    this process' registry and every failed one
    ``easydl_scrape_failures_total{target}`` — a dead exporter is itself
    a detectable signal (the ``fleet_scrape_health`` SLO pages on the
    failure counter's burn, which is how process-kill drills are
    detected at all)."""
    from easydl_tpu_torch.obs.registry import get_registry

    reg = get_registry()
    attempts = reg.counter(
        "easydl_scrape_attempts_total",
        "Fleet scrape attempts by target component.", ("target",))
    failures = reg.counter(
        "easydl_scrape_failures_total",
        "Fleet scrape attempts that got no /metrics answer, by target "
        "component.", ("target",))
    workers = max(1, int(pool if pool is not None
                         else knob_int("EASYDL_SCRAPE_POOL")))
    items = sorted(targets.items())
    out: Dict[str, Dict[str, object]] = {}
    if not items:
        return out
    with ThreadPoolExecutor(max_workers=min(workers, len(items))) as ex:
        docs = ex.map(lambda kv: scrape_target(kv[1], timeout=timeout),
                      items)
        for (component, _), doc in zip(items, docs):
            attempts.inc(target=component)
            if not doc.get("ok"):
                failures.inc(target=component)
            out[component] = doc
    return out


def discover_docs(workdir: str) -> Dict[str, dict]:
    """{component: publication doc} from the exporters' address files."""
    docs: Dict[str, dict] = {}
    d = os.path.join(workdir, OBS_DIR)
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return docs
    for name in names:
        # torn publications are <component>.json.tmp — filtered here too
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, name)) as f:
                doc = json.load(f)
            docs[str(doc["component"])] = doc
        except (OSError, ValueError, KeyError):
            continue  # torn publication; next scrape sees it
    return docs


def discover(workdir: str) -> Dict[str, str]:
    """{component: address} from the exporters' publication files."""
    return {c: str(doc["address"]) for c, doc in discover_docs(workdir).items()
            if "address" in doc}


def merge_snapshot(
    workdir: Optional[str] = None,
    targets: Dict[str, str] | None = None,
    timeout: float = 5.0,
) -> Dict[str, object]:
    """Poll every service and fold the results into one document:

    ``{"services": {component: scrape_target(...)}, "merged": {series: v}}``

    Identical series from different services DO happen — every process
    exports the same ``easydl_rpc_client_*{method,service}`` families and
    the unlabeled ``easydl_train_*`` gauges — so the merge must not simply
    last-write-win: additive series (``_total``/``_count``/``_sum``/
    ``_bucket`` suffixes — counters and histogram components) are SUMMED
    across services, which keeps fleet-wide RPC totals correct; gauges keep
    the last scraped value (per-service values stay exact under
    ``services[component]["metrics"]``). Exporters co-hosted in ONE process
    (a local job running master + agents in-process) all serve the same
    registry, so summing across them would multiply real values by the
    exporter count — publications carry the exporter's pid, and services
    sharing a (host, pid) contribute each series once."""
    # source key -> {series: value}; one source = one process registry.
    all_targets: Dict[str, Tuple[str, tuple]] = {}
    if workdir:
        for component, doc in discover_docs(workdir).items():
            addr = str(doc.get("address", ""))
            if not addr:
                continue
            host = addr.rsplit(":", 1)[0]
            pid = doc.get("pid")
            reg = doc.get("registry")
            key = ((host, pid, reg) if pid is not None and reg is not None
                   else ("component", component))
            all_targets[component] = (addr, key)
    for component, addr in (targets or {}).items():
        all_targets[component] = (addr, ("target", component))
    services = scrape_fleet(
        {c: addr for c, (addr, _) in all_targets.items()}, timeout=timeout)
    by_source: Dict[tuple, Dict[str, float]] = {}
    for component, (_, key) in sorted(all_targets.items()):
        doc = services[component]
        if doc["ok"]:
            by_source.setdefault(key, {}).update(doc["metrics"])  # type: ignore[arg-type]
    merged: Dict[str, float] = {}
    for metrics in by_source.values():
        for series, value in metrics.items():
            if series in merged and _is_additive(series):
                merged[series] += value
            else:
                merged[series] = value
    return {"services": services, "merged": merged}


def _is_additive(series: str) -> bool:
    name = series.split("{", 1)[0]
    return name.endswith(("_total", "_count", "_sum", "_bucket"))


def format_console(snapshot: Dict[str, object],
                   pattern: Optional[str] = None) -> str:
    """Human console rendering of a merged snapshot."""
    rx = re.compile(pattern) if pattern else None
    lines: List[str] = []
    services: Dict[str, Dict[str, object]] = snapshot["services"]  # type: ignore[assignment]
    for component, doc in services.items():
        status = "up" if doc.get("ok") else f"DOWN ({doc.get('error')})"
        health = doc.get("health") or {}
        up = (f", uptime {health.get('uptime_s')}s"
              if isinstance(health, dict) and "uptime_s" in health else "")
        lines.append(f"== {component} @ {doc.get('address')} [{status}{up}]")
        metrics: Dict[str, float] = doc.get("metrics") or {}  # type: ignore[assignment]
        for series in sorted(metrics):
            if rx is not None and not rx.search(series):
                continue
            lines.append(f"  {series} = {metrics[series]}")
    return "\n".join(lines)
