"""Serve fleet router: one front door over N serving replicas.

A frontend is one replica; this is what makes "fleet" a noun. The router
dispatches ``Infer`` traffic over every discovered replica
(least-loaded, with consistent-hash session affinity — the pure policy
in :mod:`easydl_tpu_torch.serve.routing`), hedges requests that outlive the
rolling p95 against a second replica (first answer wins, loser
cancelled, duplicates budget-capped so a sick fleet cannot double its
own load), ejects dead or persistently-shedding replicas from rotation
with hold-down + re-probe, and exports the FLEET-WIDE gauges the
Brain's ``serve_scale_decision`` scales on — offered load summed at the
door, where sheds and ejected replicas are visible, not at whichever
replica happened to answer.

Discovery rides the workdir: every replica's ``serve()`` publishes
``<workdir>/serve/<name>.json`` (address + pid, removed on clean stop,
dead-pid files swept here), so a fleet is "whatever is alive under the
job workdir" — the same convention as the obs exporter discovery files
and the PS registry. A static ``addresses`` list works too (tests,
fixed deployments).

Failure handling is layered, strictest first:

1. transport error / hard error from the primary → if a hedge is in
   flight its answer RESCUES the request; otherwise the request
   re-routes to the next replica (exactly-once is the replica's
   problem — Infer is read-only);
2. ``eject_fails`` consecutive transport failures (or sheds) eject the
   replica: out of rotation, hold-down, background re-probe
   (Rollout-status) before re-admission;
3. a retriable shed re-routes once per remaining replica; only when
   EVERY healthy replica sheds does the shed reach the caller — the
   fleet-level admission answer.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from easydl_tpu_torch.obs import get_registry, start_exporter
from easydl_tpu_torch.obs.errors import count_swallowed
from easydl_tpu_torch.proto import easydl_pb2 as pb
from easydl_tpu_torch.serve.frontend import SERVE_SERVICE, InferResult, OVERLOADED
from easydl_tpu_torch.serve.routing import (
    ReplicaView,
    hedge_decision,
    hedge_delay_s,
    probe_due,
    route_decision,
)
from easydl_tpu_torch.utils.env import knob_float, knob_int
from easydl_tpu_torch.utils.logging import get_logger
from easydl_tpu_torch.utils.retry import is_transport_error
from easydl_tpu_torch.utils.rpc import GRPC_MSG_OPTIONS, RpcClient, serve

log = get_logger("serve", "router")

#: Rolling window (seconds) behind the router's fleet gauges — matches the
#: replica-side QPS_WINDOW_S so the two sets of gauges are comparable.
ROUTER_WINDOW_S = 10.0


class _Replica:
    """Router-side state for one backend replica."""

    def __init__(self, name: str, address: str, timeout_s: float):
        self.name = name
        self.address = address
        self.client = RpcClient(SERVE_SERVICE, address, timeout=timeout_s,
                                options=GRPC_MSG_OPTIONS)
        self.outstanding = 0
        self.qps_recent = 0.0
        self.p99_recent_s = 0.0
        self.consecutive_fails = 0
        self.consecutive_sheds = 0
        self.ejected = False
        self.ejected_at = 0.0
        self.probing = False

    def view(self) -> ReplicaView:
        return ReplicaView(name=self.name, outstanding=self.outstanding,
                           qps_recent=self.qps_recent,
                           p99_recent_s=self.p99_recent_s,
                           healthy=not self.ejected)


_router_metrics_cache: Optional[tuple] = None


def _router_metrics():
    global _router_metrics_cache
    if _router_metrics_cache is None:
        reg = get_registry()
        _router_metrics_cache = (
            reg.counter(
                "easydl_serve_router_requests_total",
                "Requests through the fleet router, by final verdict "
                "(ok | shed | error).", ("replica", "verdict")),
            reg.counter(
                "easydl_serve_router_routed_total",
                "Primary dispatches per backend replica.",
                ("replica", "target")),
            reg.counter(
                "easydl_serve_router_hedges_total",
                "Hedged duplicates, by outcome: won (hedge answered "
                "first), rescued (hedge answered after the primary "
                "FAILED), lost (primary answered first), denied "
                "(budget spent).", ("replica", "result")),
            reg.counter(
                "easydl_serve_router_ejections_total",
                "Replicas ejected from rotation (dead = transport "
                "failures, shedding = persistent overload).",
                ("replica", "reason")),
            reg.counter(
                "easydl_serve_router_readmissions_total",
                "Ejected replicas re-admitted after a successful "
                "post-hold-down probe.", ("replica",)),
            reg.counter(
                "easydl_serve_router_reroutes_total",
                "Requests re-dispatched to another replica after a "
                "failure or shed.", ("replica",)),
            reg.gauge(
                "easydl_serve_router_live_replicas",
                "Replicas currently in rotation (discovered minus "
                "ejected).", ("replica",)),
            reg.gauge(
                "easydl_serve_router_known_replicas",
                "Replicas known to the router (in rotation + ejected).",
                ("replica",)),
            reg.gauge(
                "easydl_serve_router_offered_qps_recent",
                f"Fleet-wide OFFERED load over the last "
                f"{ROUTER_WINDOW_S:.0f}s — every request at the door, "
                "completed and shed, the number the replica autoscale "
                "policy must scale on.", ("replica",)),
            reg.gauge(
                "easydl_serve_router_p99_seconds_recent",
                f"Fleet-wide p99 over the last {ROUTER_WINDOW_S:.0f}s "
                "(completed requests only).", ("replica",)),
            reg.histogram(
                "easydl_serve_router_request_latency_seconds",
                "End-to-end latency through the router (hedges "
                "included).", ("replica",)),
        )
    return _router_metrics_cache


class ServeRouter:
    """Dispatch + hedging + ejection over a serve fleet. Thread-safe."""

    def __init__(self, workdir: Optional[str] = None,
                 addresses: Optional[Dict[str, str]] = None,
                 name: str = "router-0",
                 hedge_budget: Optional[float] = None,
                 hedge_min_ms: Optional[float] = None,
                 hedge_max_ms: Optional[float] = None,
                 holddown_s: Optional[float] = None,
                 eject_fails: Optional[int] = None,
                 refresh_s: Optional[float] = None,
                 salt: str = "", timeout_s: float = 30.0):
        self.workdir = workdir
        self.name = name
        self.salt = salt
        self.timeout_s = float(timeout_s)
        self.hedge_budget = float(
            knob_float("EASYDL_SERVE_HEDGE_BUDGET")
            if hedge_budget is None else hedge_budget)
        self.hedge_min_s = float(
            knob_float("EASYDL_SERVE_HEDGE_MIN_MS")
            if hedge_min_ms is None else hedge_min_ms) / 1000.0
        self.hedge_max_s = float(
            knob_float("EASYDL_SERVE_HEDGE_MAX_MS")
            if hedge_max_ms is None else hedge_max_ms) / 1000.0
        self.holddown_s = float(
            knob_float("EASYDL_SERVE_ROUTER_HOLDDOWN_S")
            if holddown_s is None else holddown_s)
        self.eject_fails = int(
            knob_int("EASYDL_SERVE_ROUTER_EJECT_FAILS")
            if eject_fails is None else eject_fails)
        self.refresh_s = float(
            knob_float("EASYDL_SERVE_ROUTER_REFRESH_S")
            if refresh_s is None else refresh_s)
        self._mu = threading.Lock()
        self._replicas: Dict[str, _Replica] = {}
        self._refreshed_at = 0.0
        #: (t, latency_s or None) — None = shed; the fleet window
        self._window: Deque[Tuple[float, Optional[float]]] = deque()
        self._hedge_marks: Deque[float] = deque()
        self._gauges_at = 0.0
        self._server = None
        self._exporter = None
        #: python-side evidence counters (the chaos drill reads these)
        self.counters: Dict[str, int] = {
            "requests": 0, "ok": 0, "shed": 0, "error": 0,
            "hedges_fired": 0, "hedges_won": 0, "hedges_rescued": 0,
            "hedges_lost": 0, "hedges_denied": 0, "ejections": 0,
            "readmissions": 0, "reroutes": 0,
        }
        self._counters_mu = threading.Lock()
        for rname, addr in (addresses or {}).items():
            self._replicas[rname] = _Replica(rname, addr, self.timeout_s)
        if workdir:
            self._refresh_replicas(force=True)

    def _count(self, key: str, n: int = 1) -> None:
        # The evidence counters feed the chaos drill's anti-vacuous
        # gates and /healthz; unsynchronized += from concurrent dispatch
        # threads loses increments. Dedicated lock: callers may already
        # hold _mu (ejection/readmission paths), and nothing acquires
        # _mu under this one.
        with self._counters_mu:
            self.counters[key] += n

    # ------------------------------------------------------------ discovery
    def _refresh_replicas(self, force: bool = False) -> None:
        if not self.workdir:
            return
        now = time.monotonic()
        with self._mu:
            if not force and now - self._refreshed_at < self.refresh_s:
                return
            self._refreshed_at = now
        seen: Dict[str, dict] = {}
        for path in glob.glob(os.path.join(self.workdir, "serve",
                                           "*.json")):
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            pid = int(doc.get("pid", 0))
            host = str(doc.get("host", ""))
            if pid and host in ("localhost", "127.0.0.1"):
                # Same-host publications from dead pids are leftovers of a
                # crashed replica — sweep them (same discipline as the
                # obs exporter discovery sweep).
                try:
                    os.kill(pid, 0)
                except ProcessLookupError:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                    continue
                except OSError:
                    pass
            if doc.get("replica") and doc.get("address"):
                seen[str(doc["replica"])] = doc
        closed: List[_Replica] = []
        with self._mu:
            for rname, doc in seen.items():
                cur = self._replicas.get(rname)
                if cur is None:
                    self._replicas[rname] = _Replica(
                        rname, str(doc["address"]), self.timeout_s)
                    log.info("router %s: discovered replica %s at %s",
                             self.name, rname, doc["address"])
                elif cur.address != str(doc["address"]):
                    # Same name, new address = a restarted replica: fresh
                    # client, fresh health.
                    closed.append(cur)
                    self._replicas[rname] = _Replica(
                        rname, str(doc["address"]), self.timeout_s)
            for rname in [r for r in self._replicas if r not in seen]:
                # File gone = clean shutdown (or swept crash leftover).
                closed.append(self._replicas.pop(rname))
        for rec in closed:
            rec.client.close()

    # ------------------------------------------------------------- rotation
    def _views(self) -> List[ReplicaView]:
        now = time.monotonic()
        probe: List[_Replica] = []
        with self._mu:
            views = []
            for rec in self._replicas.values():
                if (rec.ejected and not rec.probing
                        and probe_due(now, rec.ejected_at,
                                      self.holddown_s)):
                    rec.probing = True
                    probe.append(rec)
                views.append(rec.view())
        for rec in probe:
            threading.Thread(target=self._probe, args=(rec,),
                             daemon=True,
                             name=f"router-probe-{rec.name}").start()
        return views

    def _probe(self, rec: _Replica) -> None:
        """Post-hold-down health probe: one cheap Rollout-status RPC; a
        reply re-admits the replica, failure re-arms the hold-down."""
        try:
            rec.client.Rollout(pb.RolloutRequest(action="status"),
                               timeout_s=min(self.timeout_s, 5.0))
            ok = True
        except Exception as e:  # still down: re-arm the hold-down
            count_swallowed("serve.router.probe", e)
            ok = False
        with self._mu:
            rec.probing = False
            if ok:
                rec.ejected = False
                rec.consecutive_fails = 0
                rec.consecutive_sheds = 0
                self._count("readmissions")
            else:
                rec.ejected_at = time.monotonic()
        if ok:
            _router_metrics()[4].inc(replica=self.name)
            log.info("router %s: replica %s re-admitted after probe",
                     self.name, rec.name)

    def _eject(self, rec: _Replica, reason: str) -> None:
        with self._mu:
            if rec.ejected:
                return
            rec.ejected = True
            rec.ejected_at = time.monotonic()
            self._count("ejections")
        _router_metrics()[3].inc(replica=self.name, reason=reason)
        log.warning("router %s: replica %s EJECTED (%s); hold-down %.1fs",
                    self.name, rec.name, reason, self.holddown_s)

    def _note_result(self, rec: _Replica, ok: bool, shed: bool,
                     transport_fail: bool, resp=None) -> None:
        with self._mu:
            if transport_fail:
                rec.consecutive_fails += 1
                fails = rec.consecutive_fails
            else:
                rec.consecutive_fails = 0
                if shed:
                    rec.consecutive_sheds += 1
                else:
                    rec.consecutive_sheds = 0
                fails = 0
            sheds = rec.consecutive_sheds
            if resp is not None:
                rec.qps_recent = float(resp.qps_recent)
                rec.p99_recent_s = float(resp.p99_seconds_recent)
        if fails >= self.eject_fails:
            self._eject(rec, "dead")
        elif sheds >= 4 * self.eject_fails:
            # 4x the dead threshold: a shed is a well-formed answer, so
            # the bar for removing capacity is much higher than for a
            # replica that stopped answering at all. And shedding is an
            # OUTLIER signal, not a death certificate: eject only while
            # the FLEET is healthy (most recent requests completed) and
            # some other replica is not at a shed streak — a persistent
            # shedder in a healthy fleet is stuck, the same replicas
            # under a flash crowd at capacity are just full, and
            # ejecting them would shrink the fleet exactly when it is
            # busiest (the shed already IS the correct fleet answer).
            with self._mu:
                other_ok = any(
                    not r.ejected and r.name != rec.name
                    and r.consecutive_sheds == 0
                    for r in self._replicas.values())
                window = list(self._window)
            completed = sum(1 for _, lat in window if lat is not None)
            fleet_healthy = (not window
                             or completed >= 0.8 * len(window))
            if other_ok and fleet_healthy:
                self._eject(rec, "shedding")

    # ---------------------------------------------------------- fleet gauges
    def _observe(self, latency_s: Optional[float]) -> None:
        now = time.monotonic()
        with self._mu:
            self._window.append((now, latency_s))
            if now - self._gauges_at < 0.25:
                return
        self._refresh_gauges(now)

    def _refresh_gauges(self, now: float) -> None:
        with self._mu:
            self._gauges_at = now
            cutoff = now - ROUTER_WINDOW_S
            while self._window and self._window[0][0] < cutoff:
                self._window.popleft()
            while self._hedge_marks and self._hedge_marks[0] < cutoff:
                self._hedge_marks.popleft()
            window = list(self._window)
            live = sum(1 for r in self._replicas.values() if not r.ejected)
            known = len(self._replicas)
        m = _router_metrics()
        m[6].set(live, replica=self.name)
        m[7].set(known, replica=self.name)
        if not window:
            m[8].set(0.0, replica=self.name)
            m[9].set(0.0, replica=self.name)
            return
        span_s = max(ROUTER_WINDOW_S / 2, now - window[0][0], 1e-3)
        lats = sorted(l for _, l in window if l is not None)
        p99 = (lats[min(len(lats) - 1, int(0.99 * len(lats)))]
               if lats else 0.0)
        m[8].set(len(window) / span_s, replica=self.name)
        m[9].set(p99, replica=self.name)

    def _recent_counts(self) -> Tuple[int, int]:
        now = time.monotonic()
        cutoff = now - ROUTER_WINDOW_S
        with self._mu:
            while self._window and self._window[0][0] < cutoff:
                self._window.popleft()
            while self._hedge_marks and self._hedge_marks[0] < cutoff:
                self._hedge_marks.popleft()
            return len(self._hedge_marks), len(self._window)

    def _latency_p95(self) -> float:
        with self._mu:
            lats = sorted(l for _, l in self._window if l is not None)
        if not lats:
            return 0.0
        return lats[min(len(lats) - 1, int(0.95 * len(lats)))]

    # ------------------------------------------------------------- dispatch
    def infer(self, ids: np.ndarray, dense: Optional[np.ndarray] = None,
              session_id: str = "") -> InferResult:
        """Python-side entry: arrays in, scores out — same contract as a
        single replica's ``ServeFrontend.infer``."""
        ids = np.asarray(ids, np.int64)
        if ids.ndim != 2:
            raise ValueError(f"ids must be (rows, fields), got {ids.shape}")
        req = pb.InferRequest(
            raw_ids=np.ascontiguousarray(ids, "<i8").tobytes(),
            fields=int(ids.shape[1]),
            session_id=session_id,
        )
        if dense is not None:
            dense = np.ascontiguousarray(dense, np.float32)
            req.dense = dense.astype("<f4", copy=False).tobytes()
            req.dense_dim = int(dense.shape[1])
        resp = self._dispatch(req, session_id)
        scores = (np.frombuffer(resp.scores, "<f4").copy()
                  if resp.scores else None)
        return InferResult(bool(resp.ok), str(resp.verdict), scores)

    def Infer(self, req: pb.InferRequest, ctx) -> pb.InferResponse:
        """gRPC passthrough: the router IS an easydl.Serve endpoint, so a
        client needs one address for the whole fleet."""
        return self._dispatch(req, str(req.session_id))

    def Rollout(self, req: pb.RolloutRequest, ctx) -> pb.RolloutResponse:
        """Proxy rollout control to the first healthy replica (fleet-wide
        rollback is the publication pin — one replica's Rollout RPC
        writes it, every watcher converges)."""
        self._refresh_replicas()
        target = route_decision(self._views(), salt=self.salt)
        if target is None:
            return pb.RolloutResponse(ok=False,
                                      message="error: no healthy replica")
        with self._mu:
            rec = self._replicas.get(target)
        if rec is None:
            return pb.RolloutResponse(ok=False,
                                      message="error: replica vanished")
        return rec.client.Rollout(req)

    def Retrieve(self, req: pb.RetrieveRequest, ctx) -> pb.RetrieveResponse:
        """Proxy candidate generation with the same session affinity as
        scoring: the session's HRW-preferred replica answers, so a
        session's retriever arm AND its index snapshot stay consistent
        across the retrieve->rank pair. Transport failure ejects-and-
        reroutes exactly like Infer dispatch (one retry pass over the
        remaining fleet)."""
        self._refresh_replicas()
        session_id = str(req.session_id)
        tried: List[str] = []
        self._count("requests")
        last_error = "no healthy replica"
        t0 = time.monotonic()
        while True:
            target = route_decision(self._views(), session_id=session_id,
                                    exclude=tuple(tried), salt=self.salt)
            if target is None:
                self._count("error")
                return pb.RetrieveResponse(
                    ok=False, verdict=f"error: {last_error}")
            with self._mu:
                rec = self._replicas.get(target)
            tried.append(target)
            if rec is None:
                last_error = "replica vanished"
                continue
            if len(tried) > 1:
                self._count("reroutes")
            try:
                resp = rec.client.Retrieve(req)
            except Exception as e:
                count_swallowed("serve.router.retrieve_leg", e)
                last_error = repr(e)
                self._note_result(rec, ok=False, shed=False,
                                  transport_fail=True)
                continue
            self._note_result(rec, ok=bool(resp.ok), shed=False,
                              transport_fail=False, resp=resp)
            self._observe(time.monotonic() - t0)
            self._count("ok" if resp.ok else "error")
            return resp

    def _dispatch(self, req: pb.InferRequest,
                  session_id: str) -> pb.InferResponse:
        m = _router_metrics()
        t0 = time.monotonic()
        self._count("requests")
        tried: List[str] = []
        shed_resp: Optional[pb.InferResponse] = None
        last_error = "no replicas discovered"
        deadline = t0 + self.timeout_s
        while time.monotonic() < deadline:
            self._refresh_replicas()
            views = self._views()
            target = route_decision(views, session_id=session_id,
                                    exclude=tuple(tried), salt=self.salt)
            if target is None:
                break
            with self._mu:
                rec = self._replicas.get(target)
            if rec is None:
                tried.append(target)
                continue
            tried.append(target)
            if len(tried) > 1:
                self._count("reroutes")
                m[5].inc(replica=self.name)
            m[1].inc(replica=self.name, target=target)
            outcome, resp, err = self._send_hedged(rec, req, views,
                                                   deadline)
            if outcome == "ok":
                lat = time.monotonic() - t0
                self._observe(lat)
                m[0].inc(replica=self.name, verdict="ok")
                m[10].observe(lat, replica=self.name)
                self._count("ok")
                return resp
            if outcome == "shed":
                shed_resp = resp
                continue  # try the rest of the fleet before shedding
            if outcome == "hard":
                # Non-retriable verdict from a healthy replica: the
                # request itself is bad — rerouting cannot fix it.
                self._observe(time.monotonic() - t0)
                m[0].inc(replica=self.name, verdict="error")
                self._count("error")
                return resp
            last_error = err or "transport failure"
        if shed_resp is not None:
            # Every healthy replica shed: the fleet-level admission
            # answer, retriable by the same contract as one replica's.
            self._observe(None)
            m[0].inc(replica=self.name, verdict="shed")
            self._count("shed")
            return shed_resp
        self._observe(time.monotonic() - t0)
        m[0].inc(replica=self.name, verdict="error")
        self._count("error")
        return pb.InferResponse(
            ok=False, verdict=f"error: fleet exhausted ({last_error}); "
                              f"tried {tried}")

    def _send_hedged(self, rec: _Replica, req: pb.InferRequest,
                     views, deadline: float):
        """One primary send with optional hedge. Returns
        ``(outcome, response, error)`` with outcome in ok|shed|hard|fail.
        """
        m = _router_metrics()
        ev = threading.Event()  # shared: any leg completing wakes the loop
        entries = [self._launch(rec, req, ev)]
        hedge_fired = False
        hedge_denied = False
        try:
            delay_at = time.monotonic() + hedge_delay_s(
                self._latency_p95(), self.hedge_min_s, self.hedge_max_s)
            while True:
                now = time.monotonic()
                if now >= deadline:
                    return "fail", None, "deadline"
                pending = [e for e in entries if not e["fut"].done()]
                finished = [e for e in entries
                            if e["fut"].done() and not e.get("seen")]
                for e in finished:
                    e["seen"] = True
                    outcome, resp, err = self._consume(e, req)
                    if outcome == "ok":
                        if e["kind"] == "hedge":
                            primary_failed = (entries[0]["fut"].done()
                                              and entries[0].get("failed"))
                            result = ("rescued" if primary_failed
                                      else "won")
                            self._count(f"hedges_{result}")
                            m[2].inc(replica=self.name, result=result)
                        elif hedge_fired:
                            self._count("hedges_lost")
                            m[2].inc(replica=self.name, result="lost")
                        return "ok", resp, None
                    if outcome in ("shed", "hard"):
                        # A completed non-ok answer from either leg
                        # resolves this send (the dispatch loop decides
                        # whether to reroute a shed).
                        if e["kind"] == "primary" or not pending:
                            return outcome, resp, err
                    e["failed"] = True
                    # transport failure on this leg; the other leg (if
                    # any) may still rescue — loop on.
                if not pending and all(e.get("seen") for e in entries):
                    return "fail", None, entries[0].get("error", "failed")
                # hedge timer
                if (not hedge_fired and not hedge_denied
                        and not entries[0]["fut"].done()
                        and time.monotonic() >= delay_at):
                    hedges, reqs = self._recent_counts()
                    target = hedge_decision(
                        views, rec.name, hedges, max(reqs, 1),
                        self.hedge_budget)
                    hrec = None
                    if target is not None:
                        with self._mu:
                            hrec = self._replicas.get(target)
                    if hrec is not None:
                        entries.append(self._launch(hrec, req, ev,
                                                    kind="hedge"))
                        hedge_fired = True
                        self._count("hedges_fired")
                        with self._mu:
                            self._hedge_marks.append(time.monotonic())
                    else:
                        hedge_denied = True
                        self._count("hedges_denied")
                        m[2].inc(replica=self.name, result="denied")
                # Wait for the next completion (or the hedge timer).
                waits = [deadline]
                if not hedge_fired and not hedge_denied:
                    waits.append(delay_at)
                timeout = max(0.0, min(waits) - time.monotonic())
                ev.wait(min(timeout, 0.05))
                ev.clear()
        finally:
            for e in entries:
                if not e["fut"].done():
                    e["fut"].cancel()
                with self._mu:
                    if not e.get("settled"):
                        e["settled"] = True
                        e["rec"].outstanding = max(
                            0, e["rec"].outstanding - 1)

    def _launch(self, rec: _Replica, req: pb.InferRequest,
                ev: threading.Event, kind: str = "primary") -> dict:
        with self._mu:
            rec.outstanding += 1
        entry = {"rec": rec, "kind": kind}
        try:
            fut = rec.client.call_future(
                "Infer", req, timeout_s=self.timeout_s)
        except Exception as e:  # channel already closed
            class _Failed:
                def done(self_inner):
                    return True

                def cancel(self_inner):
                    return False

                def result(self_inner, timeout=None):
                    raise e

            entry["fut"] = _Failed()
            ev.set()
            return entry
        fut.add_done_callback(lambda _f: ev.set())
        entry["fut"] = fut
        return entry

    def _consume(self, entry: dict, req: pb.InferRequest):
        """Classify one completed leg: ok | shed | hard | fail."""
        rec = entry["rec"]
        with self._mu:
            if not entry.get("settled"):
                entry["settled"] = True
                rec.outstanding = max(0, rec.outstanding - 1)
        try:
            resp = entry["fut"].result()
        except Exception as e:
            # A failed leg is an OUTCOME here, not an error to hide: it
            # feeds ejection accounting and the dispatch loop's reroute.
            entry["error"] = repr(e)
            cancelled = "Cancelled" in type(e).__name__
            if not cancelled:
                count_swallowed("serve.router.leg_failed", e)
                if is_transport_error(e):
                    self._note_result(rec, ok=False, shed=False,
                                      transport_fail=True)
            return "fail", None, repr(e)
        if resp.ok:
            self._note_result(rec, ok=True, shed=False,
                              transport_fail=False, resp=resp)
            return "ok", resp, None
        if resp.verdict.startswith(OVERLOADED):
            self._note_result(rec, ok=False, shed=True,
                              transport_fail=False, resp=resp)
            return "shed", resp, resp.verdict
        self._note_result(rec, ok=False, shed=False, transport_fail=False,
                          resp=resp)
        return "hard", resp, resp.verdict

    # ----------------------------------------------------------- lifecycle
    def replicas(self) -> Dict[str, dict]:
        with self._mu:
            return {
                r.name: {"address": r.address, "ejected": r.ejected,
                         "outstanding": r.outstanding,
                         "qps_recent": r.qps_recent,
                         "p99_recent_s": r.p99_recent_s}
                for r in self._replicas.values()
            }

    def serve(self, port: int = 0, obs_workdir: Optional[str] = None,
              obs_name: Optional[str] = None):
        """Expose the router itself as an ``easydl.Serve`` endpoint (one
        address for the fleet) plus a /metrics exporter carrying the
        fleet-wide gauges the autoscale policy scrapes."""
        self._server = serve(SERVE_SERVICE, self, port=port,
                             options=GRPC_MSG_OPTIONS)
        self._exporter = start_exporter(
            obs_name or self.name, workdir=obs_workdir or self.workdir,
            health_fn=lambda: {
                "router": self.name,
                "replicas": self.replicas(),
                "counters": dict(self.counters),
            },
        )
        log.info("serve router %s on :%d (%d replica(s))", self.name,
                 self._server.port, len(self._replicas))
        return self._server

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None
        with self._mu:
            recs = list(self._replicas.values())
            self._replicas.clear()
        for rec in recs:
            rec.client.close()
