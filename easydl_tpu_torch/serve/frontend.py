"""Stateless inference frontend: micro-batched, admission-controlled,
PS-backed.

Request path (the ``easydl.Serve`` gRPC service, or :meth:`ServeFrontend.
infer` in-process)::

    submit -> [admission control] -> micro-batch queue -> batch runner:
        hot-cached PS pull (ps/read_client.py) -> forward -> split
        scores back per request -> resolve futures

Three perf layers, per the serving tentpole:

1. **Micro-batching with deadline-based admission control**: requests
   coalesce FIFO up to ``max_batch`` examples or until the OLDEST queued
   request has waited ``max_wait_ms`` (the batching deadline — a lone
   request never waits longer than that). Past ``max_pending`` queued
   examples the frontend sheds load: the request is answered immediately
   with a RETRIABLE ``overloaded`` verdict instead of growing an unbounded
   queue whose tail latency nobody can meet.
2. **Hot-id cache**: the read client validates every batch against live
   shard push-versions, so a trainer push or a live reshard can never
   leave a stale row in the response (see ps/read_client.py for the exact
   contract).
3. **Shared read client**: pulls are the trainer's own code path — raw
   ids, optional per-client fp16, chunked concurrent transfers,
   stale-route ride-out all come for free.

Telemetry: ``easydl_serve_*`` counters/gauges/histograms through the obs
registry (scraped fleet-wide by scripts/obs_scrape.py; the Brain's replica
policy reads the rolling qps/p99 gauges — controller/reconciler.py
``maybe_scale_serve``). Tracing: a span per request plus a span per batch
via the tracing layer, no-ops unless ``EASYDL_TRACE`` is armed.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from easydl_tpu_torch.loop.rollout import CANARY, CONTROL, assign_arm
from easydl_tpu_torch.obs import get_registry, start_exporter, tracing
from easydl_tpu_torch.proto import easydl_pb2 as pb
from easydl_tpu_torch.ps.read_client import PsReadClient
from easydl_tpu_torch.utils.env import knob_float, knob_int, knob_str
from easydl_tpu_torch.utils.logging import get_logger
from easydl_tpu_torch.utils.rpc import GRPC_MSG_OPTIONS, ServiceDef, serve

log = get_logger("serve", "frontend")

SERVE_SERVICE = ServiceDef(
    "easydl.Serve",
    {
        "Infer": (pb.InferRequest, pb.InferResponse),
        "Retrieve": (pb.RetrieveRequest, pb.RetrieveResponse),
        "Rollout": (pb.RolloutRequest, pb.RolloutResponse),
    },
)

ENV_CANARY_FRACTION = "EASYDL_ROLLOUT_CANARY_FRACTION"
ENV_ROLLOUT_SALT = "EASYDL_ROLLOUT_SALT"
ENV_RETRIEVAL_K = "EASYDL_RETRIEVAL_K"
ENV_RETRIEVAL_NPROBE = "EASYDL_RETRIEVAL_NPROBE"
ENV_RETRIEVAL_USER_TABLE = "EASYDL_RETRIEVAL_USER_TABLE"

#: InferResponse.verdict prefix for a shed request — the RETRIABLE class
#: (back off and re-send); anything else non-empty is a hard failure.
OVERLOADED = "overloaded"

#: Rolling window (seconds) behind the easydl_serve_qps_recent /
#: easydl_serve_p99_seconds_recent gauges the replica policy scrapes.
QPS_WINDOW_S = 10.0


@dataclass(frozen=True)
class ServeConfig:
    """Knobs of one serving replica (docs/operations.md §12)."""

    table: str
    fields: int                    # sparse fields per example
    dense_dim: int = 0
    max_batch: int = 256           # examples per forward micro-batch
    max_wait_ms: float = 2.0       # batching deadline for the oldest request
    max_pending: int = 2048        # admission bound, queued examples
    request_timeout_s: float = 30.0


@dataclass
class InferResult:
    ok: bool
    verdict: str                   # "" ok; "overloaded..." = shed/retriable
    scores: Optional[np.ndarray] = None
    latency_s: float = 0.0

    @property
    def retriable(self) -> bool:
        return (not self.ok) and self.verdict.startswith(OVERLOADED)


@dataclass
class RetrieveResult:
    ok: bool
    verdict: str                   # "" ok; non-empty = hard failure
    candidate_ids: Optional[np.ndarray] = None   # (rows, k) int64, -1 pads
    scores: Optional[np.ndarray] = None          # (rows, k) float32
    index_version: int = 0
    arm: str = CONTROL
    latency_s: float = 0.0


@dataclass
class _Work:
    seq: int
    ids: np.ndarray                # (rows, fields) int64
    dense: np.ndarray              # (rows, dense_dim) float32
    t_enq: float
    session_id: str = ""
    arm: str = CONTROL             # session-consistent A/B assignment
    future: "Future[InferResult]" = field(default_factory=Future)

    @property
    def rows(self) -> int:
        return len(self.ids)


def make_deepfm_forward(fields: int, dim: int, dense_dim: int,
                        hidden=(64,), use_fm: bool = True, seed: int = 0,
                        max_batch: int = 256,
                        params: Optional[Any] = None,
                        device="cuda") -> Callable:
    """DeepFM's dense-tower forward over PS-pulled embeddings, on
    ``device`` (the card unless the caller asks for the CPU) — the
    flagship recommender's serving path (models/deepfm.py with
    ``embedding="ps"``: the model is identical from the first dense op
    on; here it runs scoring only, no labels, no grads).

    ``params`` is the JAX layout: the flax ``DeepFMDense`` tree of numpy
    arrays (``{"wide": {"kernel", "bias"}, "deep_0": ..., "deep_out":
    ...}``), carried across by ``convert``. Without it the tower
    initialises from ``seed`` through a CPU ``torch.Generator``: the
    same values on the card and on the CPU, but not JAX's values for the
    same seed. The returned forward scores in f32 under
    ``torch.inference_mode()``; on the card TF32 must be off
    (``models/classifier.refuse_tf32`` raises otherwise). The weights
    are on the device, copies finished, when this returns: a version
    built on a watcher thread is whole before it can enter the bank.

    Batches are padded to power-of-two buckets (capped at ``max_batch``)
    so variable micro-batch sizes hit a handful of product shapes.
    ``params`` defaults to a fresh deterministic init — the bench and
    drills score with it; production restores the trainer's dense
    checkpoint instead."""
    import torch

    from easydl_tpu_torch import convert
    from easydl_tpu_torch.models.classifier import refuse_tf32
    from easydl_tpu_torch.models.deepfm import DeepFMConfig, DeepFMDense
    from easydl_tpu_torch.utils.device import require_device

    dev = require_device(device)
    model = DeepFMDense(DeepFMConfig(num_sparse=fields, dim=dim,
                                     num_dense=max(dense_dim, 1),
                                     hidden=tuple(hidden), use_fm=use_fm))
    if params is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        sd = convert.deepfm_params_from_jax({"dense": params})
        model.load_state_dict({k[len("dense."):]: v for k, v in sd.items()})
    model = model.to(dev).eval()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    def forward(emb: np.ndarray, dense: np.ndarray) -> np.ndarray:
        n = len(emb)
        bucket = 1
        while bucket < n:
            bucket *= 2
        bucket = min(max(bucket, 1), max(max_batch, n))
        if bucket > n:
            emb = np.concatenate(
                [emb, np.zeros((bucket - n,) + emb.shape[1:], emb.dtype)])
            dense = np.concatenate(
                [dense,
                 np.zeros((bucket - n,) + dense.shape[1:], dense.dtype)])
        if dense.shape[1] == 0:  # the model was built 1 wide
            dense = np.zeros((len(dense), 1), np.float32)
        with torch.inference_mode():
            e = torch.from_numpy(np.ascontiguousarray(emb, np.float32)).to(dev)
            d = torch.from_numpy(np.ascontiguousarray(dense, np.float32)).to(dev)
            refuse_tf32(e)
            return model(e, d)[:n].cpu().numpy()

    return forward


def _numpy_forward(emb: np.ndarray, dense: np.ndarray) -> np.ndarray:
    """Dependency-free fallback scorer (drills and queue tests): a fixed
    linear read of the embeddings so scores are a deterministic function
    of the PULLED ROWS — a stale cached row changes the score, which is
    exactly what the chaos drill's stale-read check wants to see."""
    scores = emb.reshape(len(emb), -1).sum(axis=1)
    if dense.size:
        scores = scores + dense.sum(axis=1)
    return scores.astype(np.float32)


_serve_metrics_cache: Optional[tuple] = None


def _serve_metrics():
    global _serve_metrics_cache
    if _serve_metrics_cache is None:
        reg = get_registry()
        _serve_metrics_cache = (
            reg.counter(
                "easydl_serve_requests_total",
                "Inference requests, by replica and verdict "
                "(ok | shed | error).", ("replica", "verdict")),
            reg.counter(
                "easydl_serve_examples_total",
                "Examples scored (rows across all ok requests).",
                ("replica",)),
            reg.histogram(
                "easydl_serve_request_latency_seconds",
                "End-to-end request latency (enqueue to scores).",
                ("replica",)),
            reg.histogram(
                "easydl_serve_batch_examples",
                "Examples per executed micro-batch.", ("replica",),
                buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)),
            reg.counter(
                "easydl_serve_cache_hits_total",
                "Hot-id cache hits (validated, served without a pull).",
                ("replica",)),
            reg.counter(
                "easydl_serve_cache_misses_total",
                "Hot-id cache misses (absent or version-demoted).",
                ("replica",)),
            reg.counter(
                "easydl_serve_cache_invalidations_total",
                "Cache entries dropped for staleness (push-version or "
                "routing-generation).", ("replica",)),
            reg.counter(
                "easydl_serve_cache_evictions_total",
                "Cache entries evicted by the LRU byte bound.",
                ("replica",)),
            reg.gauge(
                "easydl_serve_cache_bytes",
                "Hot-id cache resident bytes.", ("replica",)),
            reg.gauge(
                "easydl_serve_queue_examples",
                "Examples currently queued (admission bound applies to "
                "this).", ("replica",)),
            reg.gauge(
                "easydl_serve_qps_recent",
                f"Handled-request rate over the last {QPS_WINDOW_S:.0f}s "
                "window, completed AND shed — the OFFERED load the "
                "replica policy scales on; decays to 0 when traffic "
                "stops.", ("replica",)),
            reg.gauge(
                "easydl_serve_p99_seconds_recent",
                f"p99 request latency over the last {QPS_WINDOW_S:.0f}s "
                "window (completed requests only).", ("replica",)),
            reg.gauge(
                "easydl_serve_model_version",
                "Published model version this replica currently serves, "
                "per arm (0 = the static constructor-supplied forward; "
                "version visibility is commit-marker-gated, so a half-"
                "published model can never appear here).",
                ("replica", "arm")),
        )
    return _serve_metrics_cache


_retrieve_metrics_cache: Optional[tuple] = None


def _retrieve_metrics():
    global _retrieve_metrics_cache
    if _retrieve_metrics_cache is None:
        reg = get_registry()
        _retrieve_metrics_cache = (
            reg.counter(
                "easydl_retrieval_requests_total",
                "Retrieve (candidate-generation) requests, by replica and "
                "verdict (ok | error).", ("replica", "verdict")),
            reg.counter(
                "easydl_retrieval_candidates_total",
                "Candidates returned across ok Retrieve requests "
                "(excludes -1 padding).", ("replica",)),
            reg.gauge(
                "easydl_retrieval_index_version",
                "Published ANN index snapshot this replica answers "
                "retrievals from, per arm (0 = no index installed; "
                "visibility is commit-marker-gated like model "
                "versions).", ("replica", "arm")),
        )
    return _retrieve_metrics_cache


class ServeFrontend:
    """One serving replica: queue + batch runner + forward + gRPC surface.

    ``forward(emb [B,F,D] f32, dense [B,dd] f32) -> scores [B] f32``; the
    default is the numpy fallback scorer, :func:`make_deepfm_forward`
    builds the DeepFM tower on the card.
    """

    def __init__(self, reads: PsReadClient, config: ServeConfig,
                 forward: Optional[Callable] = None, name: str = "serve-0",
                 feedback=None, canary_fraction: Optional[float] = None,
                 rollout_salt: Optional[str] = None):
        self.reads = reads
        self.config = config
        self.forward = forward or _numpy_forward
        self.name = name
        #: per-arm (version, forward) bank. Version 0 = the static
        #: constructor forward; hot-swaps replace the CONTROL entry
        #: between batches (a batch snapshots the bank once under the
        #: lock and runs wholly on it — a swap can never split a batch
        #: across model versions).
        self._models: Dict[str, Tuple[int, Callable]] = {
            CONTROL: (0, self.forward)}
        #: per-arm (version, AnnIndex) bank for the Retrieve path — the
        #: retrieval twin of the model bank, fed by a ModelVersionWatcher
        #: over the index publish dir. Same swap discipline: a retrieve
        #: snapshots one entry under the lock and answers wholly from it.
        self._indexes: Dict[str, Tuple[int, Any]] = {}
        #: user-tower table the Retrieve path pulls context rows from
        #: (attach_retrieval sets it; None = Retrieve answers a verdict).
        self._retrieval_user_table: Optional[str] = None
        #: loop/feedback.py FeedbackWriter (optional): the emit hook.
        #: Contract: emission NEVER blocks or fails a request — the
        #: writer itself is lossy-with-count, and emission runs on the
        #: batch runner thread, after futures resolve.
        self.feedback = feedback
        self.canary_fraction = float(
            knob_float(ENV_CANARY_FRACTION)
            if canary_fraction is None else canary_fraction)
        self.rollout_salt = str(
            knob_str(ENV_ROLLOUT_SALT)
            if rollout_salt is None else rollout_salt)
        #: loop/publish.py ModelVersionWatcher, attached by the caller —
        #: the Rollout RPC's actuation target
        self.rollout_watcher = None
        #: optional loop/rollout.py RolloutPacer fed per-request outcomes
        self.pacer = None
        self._mu = threading.Condition()
        self._queue: Deque[_Work] = deque()
        self._pending_examples = 0
        self._seq = 0
        self._stopped = False
        self._server = None
        self._exporter = None
        #: recent batch compositions (request seqs, FIFO) — test + drill
        #: evidence that batch order is deterministic
        self.recent_batches: Deque[Tuple[int, ...]] = deque(maxlen=64)
        self.batches_run = 0
        self._lat_window: Deque[Tuple[float, float]] = deque()
        self._gauges_at = 0.0
        self._qps_recent = 0.0
        self._p99_recent = 0.0
        self._discovery_file: Optional[str] = None
        self._cache_last: Dict[str, float] = {}
        self._runner = threading.Thread(
            target=self._run_loop, name=f"serve-batch-{name}", daemon=True)
        self._runner.start()

    # ----------------------------------------------------------- model bank
    def set_model(self, version: int, forward: Callable,
                  arm: str = CONTROL) -> None:
        """Install a fully-built forward for ``arm`` — the hot-swap. The
        bank entry flips atomically under the lock; in-flight batches
        finish on the snapshot they took, the NEXT batch runs the new
        version (swap lands between batches, never inside one)."""
        with self._mu:
            self._models[arm] = (int(version), forward)
        _serve_metrics()[12].set(int(version), replica=self.name, arm=arm)
        if arm == CANARY and self.pacer is not None:
            self.pacer.start_canary(int(version), time.monotonic())

    def clear_canary(self) -> None:
        with self._mu:
            self._models.pop(CANARY, None)
        _serve_metrics()[12].set(0, replica=self.name, arm=CANARY)
        if self.pacer is not None:
            self.pacer.end_canary()

    def promote_canary(self) -> bool:
        """Canary → control (the pacing policy's PROMOTE actuation)."""
        with self._mu:
            entry = self._models.get(CANARY)
            if entry is None:
                return False
            self._models[CONTROL] = entry
            self._models.pop(CANARY, None)
        _serve_metrics()[12].set(entry[0], replica=self.name, arm=CONTROL)
        _serve_metrics()[12].set(0, replica=self.name, arm=CANARY)
        if self.pacer is not None:
            self.pacer.end_canary()
        return True

    def model_versions(self) -> Dict[str, int]:
        with self._mu:
            return {arm: v for arm, (v, _f) in self._models.items()}

    def _assign_arm(self, session_id: str) -> str:
        with self._mu:
            has_canary = CANARY in self._models
        if not has_canary or not session_id:
            return CONTROL
        return assign_arm(session_id, self.canary_fraction,
                          self.rollout_salt)

    # ----------------------------------------------------------- index bank
    def attach_retrieval(self, user_table: str) -> None:
        """Arm the Retrieve path: context ids pull from ``user_table``
        through the same hot-cached read client as ranking pulls."""
        self._retrieval_user_table = str(user_table)

    def set_index(self, version: int, index, arm: str = CONTROL) -> None:
        """Install a loaded ANN index snapshot for ``arm`` (the retrieval
        hot-swap; same between-requests atomicity as :meth:`set_model`)."""
        with self._mu:
            self._indexes[arm] = (int(version), index)
        _retrieve_metrics()[2].set(int(version), replica=self.name,
                                   arm=arm)

    def clear_canary_index(self) -> None:
        with self._mu:
            self._indexes.pop(CANARY, None)
        _retrieve_metrics()[2].set(0, replica=self.name, arm=CANARY)

    def index_versions(self) -> Dict[str, int]:
        with self._mu:
            return {arm: v for arm, (v, _i) in self._indexes.items()}

    def _assign_index_arm(self, session_id: str) -> str:
        """Session-consistent retriever A/B: the same assign_arm hash as
        model arms, gated on a canary INDEX being installed."""
        with self._mu:
            has_canary = CANARY in self._indexes
        if not has_canary or not session_id:
            return CONTROL
        return assign_arm(session_id, self.canary_fraction,
                          self.rollout_salt)

    def retrieve(self, user_ids: np.ndarray, k: Optional[int] = None,
                 session_id: str = "",
                 nprobe: Optional[int] = None) -> RetrieveResult:
        """Generate top-k candidates for ``(rows, user_fields)`` context
        ids: pull the context rows, mean-pool them into user-tower
        vectors, search the session's arm's index. Runs inline (cheap
        numpy + one cached pull), not through the ranking micro-batch
        queue — retrieval latency must not ride the scoring deadline."""
        m = _retrieve_metrics()
        t0 = time.monotonic()
        k = int(knob_int(ENV_RETRIEVAL_K) if k is None or k <= 0 else k)
        user_ids = np.asarray(user_ids, np.int64)
        if user_ids.ndim != 2 or user_ids.shape[1] < 1:
            raise ValueError(
                f"user_ids must be (rows, user_fields), got "
                f"{user_ids.shape}")
        arm = self._assign_index_arm(session_id)
        with self._mu:
            entry = self._indexes.get(arm) or self._indexes.get(CONTROL)
        table = self._retrieval_user_table
        if entry is None or table is None:
            m[0].inc(replica=self.name, verdict="error")
            return RetrieveResult(
                False, "error: no retrieval index attached",
                arm=arm, latency_s=time.monotonic() - t0)
        version, index = entry
        rows = self.reads.pull(table, user_ids.reshape(-1))
        u = rows.reshape(user_ids.shape + (rows.shape[-1],)) \
                .mean(axis=1, dtype=np.float32)
        cand, scores = index.search(u, k, nprobe=nprobe)
        lat = time.monotonic() - t0
        m[0].inc(replica=self.name, verdict="ok")
        m[1].inc(int((cand >= 0).sum()), replica=self.name)
        # Retrieval is offered load too: feed the rolling qps/p99 window
        # the replica policy and the router's least-loaded dispatch read.
        self._observe_latency(lat)
        return RetrieveResult(True, "", cand, scores, version, arm, lat)

    # --------------------------------------------------------------- submit
    def infer(self, ids: np.ndarray, dense: Optional[np.ndarray] = None,
              session_id: str = "") -> InferResult:
        """Score ``rows`` examples. Blocks until the micro-batch containing
        them ran (bounded by max_wait + forward time), or sheds
        immediately when the queue is past the admission bound.
        ``session_id`` picks the A/B arm session-consistently (hash, not
        state — every replica assigns the same arm)."""
        cfg = self.config
        ids = np.asarray(ids, np.int64)
        if ids.ndim != 2 or ids.shape[1] != cfg.fields:
            raise ValueError(
                f"ids must be (rows, {cfg.fields}), got {ids.shape}")
        if dense is None:
            dense = np.zeros((len(ids), cfg.dense_dim), np.float32)
        dense = np.ascontiguousarray(dense, np.float32)
        if dense.shape != (len(ids), cfg.dense_dim):
            raise ValueError(
                f"dense must be ({len(ids)}, {cfg.dense_dim}), "
                f"got {dense.shape}")
        m = _serve_metrics()
        t0 = time.monotonic()
        span = tracing.start_span("serve_request", replica=self.name,
                                  rows=int(len(ids)))
        try:
            if len(ids) > cfg.max_pending:
                # Could NEVER be admitted: a retriable verdict here would
                # livelock a contract-following client (retry forever
                # against a permanently-true bound). Hard client error.
                m[0].inc(replica=self.name, verdict="error")
                return InferResult(
                    False,
                    f"error: request of {len(ids)} examples exceeds the "
                    f"admission bound {cfg.max_pending}; split it")
            with self._mu:
                if self._stopped:
                    return self._finish(
                        InferResult(False, "error: frontend stopped"),
                        t0, span)
                if self._pending_examples + len(ids) > cfg.max_pending:
                    depth = self._pending_examples
                    span.add_event("shed", queued=depth)
                    m[0].inc(replica=self.name, verdict="shed")
                    result = InferResult(
                        False,
                        f"{OVERLOADED}: {depth} examples queued >= bound "
                        f"{cfg.max_pending}; retry with backoff",
                        latency_s=time.monotonic() - t0)
                    # Sheds feed the qps window too (latency None): the
                    # scale policy's capacity term must see OFFERED load,
                    # or a replica shedding 90% would read as idle.
                    self._observe_latency(None)
                    return result
                self._seq += 1
                work = _Work(self._seq, ids, dense, t0,
                             session_id=session_id,
                             arm=self._assign_arm(session_id))
                self._queue.append(work)
                self._pending_examples += len(ids)
                m[9].set(self._pending_examples, replica=self.name)
                self._mu.notify_all()
            try:
                result = work.future.result(timeout=cfg.request_timeout_s)
            except Exception as e:  # timeout or runner crash
                result = InferResult(False, f"error: {e!r}")
            return self._finish(result, t0, span, arm=work.arm)
        finally:
            span.end()

    def _finish(self, result: InferResult, t0: float, span,
                arm: str = CONTROL) -> InferResult:
        m = _serve_metrics()
        result.latency_s = time.monotonic() - t0
        if result.ok:
            m[0].inc(replica=self.name, verdict="ok")
            m[1].inc(len(result.scores), replica=self.name)
        elif not result.retriable:
            m[0].inc(replica=self.name, verdict="error")
            span.add_event("error", verdict=result.verdict)
        m[2].observe(result.latency_s, replica=self.name)
        self._observe_latency(result.latency_s)
        if self.pacer is not None and (result.ok or not result.retriable):
            # Completed outcomes only: sheds say nothing about either
            # model's quality, and counting them would starve the canary
            # gates exactly when the replica is busiest.
            self.pacer.observe(arm, result.ok)
        return result

    # --------------------------------------------------------- batch runner
    def _run_loop(self) -> None:
        cfg = self.config
        while True:
            with self._mu:
                while not self._queue and not self._stopped:
                    self._mu.wait(0.5)
                    # Idle decay: with no completions arriving, the
                    # rolling gauges must still walk down to 0 as the
                    # window empties (Condition's RLock makes the
                    # nested acquire safe).
                    now = time.monotonic()
                    if now - self._gauges_at >= 0.5:
                        self._refresh_window_gauges(now)
                if self._stopped and not self._queue:
                    return
                # Batching deadline: the OLDEST request bounds the wait —
                # a lone request leaves at t_enq + max_wait_ms whether or
                # not the batch filled.
                deadline = self._queue[0].t_enq + cfg.max_wait_ms / 1000.0
                while (self._pending_examples < cfg.max_batch
                       and not self._stopped):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._mu.wait(remaining)
                # FIFO pop: arrival order IS batch order (deterministic).
                works: List[_Work] = []
                total = 0
                while self._queue:
                    if works and total + self._queue[0].rows > cfg.max_batch:
                        break
                    w = self._queue.popleft()
                    works.append(w)
                    total += w.rows
                self._pending_examples -= total
                _serve_metrics()[9].set(self._pending_examples,
                                        replica=self.name)
            if works:
                self._run_batch(works, total)

    def _run_batch(self, works: List[_Work], total: int) -> None:
        cfg = self.config
        m = _serve_metrics()
        span = tracing.start_span("serve_batch", replica=self.name,
                                  requests=len(works), examples=total)
        # One bank snapshot per batch: the whole batch scores on it, a
        # concurrent hot-swap/rollback lands on the NEXT batch — a request
        # can never see a half-updated model mid-batch.
        with self._mu:
            bank = dict(self._models)
        versions: Dict[int, int] = {}   # work seq -> scoring model version
        try:
            ids = np.concatenate([w.ids for w in works])
            dense = np.concatenate([w.dense for w in works])
            emb = self.reads.pull(cfg.table, ids)
            scores = np.empty(total, np.float32)
            offs = np.cumsum([0] + [w.rows for w in works])
            arms = sorted({w.arm for w in works})
            for arm in arms:
                idx = np.concatenate([
                    np.arange(offs[i], offs[i + 1])
                    for i, w in enumerate(works) if w.arm == arm
                ])
                version, fwd = bank.get(arm) or bank[CONTROL]
                s = np.asarray(fwd(emb[idx], dense[idx]), np.float32)
                if s.shape != (len(idx),):
                    raise ValueError(
                        f"forward({arm}) returned {s.shape}, "
                        f"want ({len(idx)},)")
                scores[idx] = s
                for i, w in enumerate(works):
                    if w.arm == arm:
                        versions[w.seq] = version
            for i, w in enumerate(works):
                w.future.set_result(
                    InferResult(True, "", scores[offs[i]:offs[i + 1]]))
            batch_ok = True
        except Exception as e:
            batch_ok = False
            log.warning("serve batch failed (%d requests): %s",
                        len(works), e)
            span.add_event("batch-error", error=repr(e))
            for w in works:
                if not w.future.done():
                    w.future.set_result(InferResult(False, f"error: {e!r}"))
        finally:
            span.end()
        self.batches_run += 1
        self.recent_batches.append(tuple(w.seq for w in works))
        m[3].observe(total, replica=self.name)
        self._drain_cache_metrics()
        if self.feedback is not None and batch_ok:
            # The emit hook: after futures resolve, off the request path.
            # FeedbackWriter is lossy-with-count and never raises — a
            # broken spool costs a counter, never a request.
            for i, w in enumerate(works):
                if w.seq in versions:
                    self.feedback.emit_serve(
                        f"{self.name}-{w.seq}", w.session_id, w.arm,
                        versions[w.seq], w.ids, scores[offs[i]:offs[i + 1]])

    def _drain_cache_metrics(self) -> None:
        cache = getattr(self.reads, "cache", None)
        if cache is None:
            return
        m = _serve_metrics()
        stats = cache.stats()
        last = self._cache_last
        for key, metric in (("hits", m[4]), ("misses", m[5]),
                            ("invalidations", m[6]), ("evictions", m[7])):
            delta = stats[key] - last.get(key, 0.0)
            if delta > 0:
                metric.inc(delta, replica=self.name)
            last[key] = stats[key]
        m[8].set(stats["bytes"], replica=self.name)

    # ------------------------------------------------------- rolling window
    def _observe_latency(self, latency_s: Optional[float]) -> None:
        """Record one handled request (latency None = shed: it counts
        toward the offered-load rate but not the latency percentile)."""
        now = time.monotonic()
        with self._mu:
            self._lat_window.append((now, latency_s))
            # Recompute the gauges at most 4×/s: an O(n log n) sort per
            # REQUEST would tax the hot path at exactly the QPS the
            # gauges exist to report.
            if now - self._gauges_at < 0.25:
                return
        self._refresh_window_gauges(now)

    def _refresh_window_gauges(self, now: float) -> None:
        """Prune + recompute the rolling qps/p99 gauges. Also called from
        the idle runner loop: a replica whose traffic STOPS must decay to
        qps 0 within the window, or the scale policy forever reads the
        last busy minute and never shrinks the fleet."""
        with self._mu:
            self._gauges_at = now
            cutoff = now - QPS_WINDOW_S
            while self._lat_window and self._lat_window[0][0] < cutoff:
                self._lat_window.popleft()
            window = list(self._lat_window)
        m = _serve_metrics()
        if not window:
            self._qps_recent = 0.0
            self._p99_recent = 0.0
            m[10].set(0.0, replica=self.name)
            m[11].set(0.0, replica=self.name)
            return
        span_s = max(QPS_WINDOW_S / 2, now - window[0][0], 1e-3)
        lats = sorted(l for _, l in window if l is not None)
        p99 = (lats[min(len(lats) - 1, int(0.99 * len(lats)))]
               if lats else 0.0)
        # Cached for the InferResponse piggyback (the router's least-
        # loaded signal) — the gauges are recomputed at most 4×/s, the
        # piggyback must not add a sort per answer.
        self._qps_recent = len(window) / span_s
        self._p99_recent = p99
        m[10].set(self._qps_recent, replica=self.name)
        m[11].set(p99, replica=self.name)

    def recent_gauges(self) -> Tuple[float, float]:
        """(qps_recent, p99_seconds_recent) as last computed — what the
        rolling gauges show and what every InferResponse piggybacks."""
        return self._qps_recent, self._p99_recent

    # ----------------------------------------------------------------- rpc
    def Infer(self, req: pb.InferRequest, ctx) -> pb.InferResponse:
        fields = int(req.fields) or self.config.fields
        if len(req.raw_ids) % 8:
            # Same verdict contract as every other malformed input — a
            # frombuffer raise would surface as an opaque UNKNOWN status.
            return pb.InferResponse(
                ok=False,
                verdict=f"error: raw_ids is {len(req.raw_ids)} bytes, not "
                        "a multiple of 8 (little-endian int64)")
        ids = np.frombuffer(req.raw_ids, dtype="<i8")
        if fields <= 0 or len(ids) % fields:
            return pb.InferResponse(
                ok=False,
                verdict=f"error: {len(ids)} ids not divisible by "
                        f"fields={fields}")
        rows = len(ids) // fields
        dd = int(req.dense_dim)
        dense = np.frombuffer(req.dense, "<f4") if req.dense else \
            np.zeros(rows * self.config.dense_dim, np.float32)
        if dd and dd != self.config.dense_dim:
            return pb.InferResponse(
                ok=False, verdict=f"error: dense_dim {dd} != configured "
                                  f"{self.config.dense_dim}")
        try:
            dense = dense.reshape(rows, self.config.dense_dim)
        except ValueError:
            return pb.InferResponse(
                ok=False, verdict="error: dense payload shape mismatch")
        try:
            result = self.infer(ids.reshape(rows, fields), dense,
                                session_id=str(req.session_id))
        except ValueError as e:
            # Shape/config mismatch is a client error, not a server crash:
            # answer with a verdict (an exception here would surface as a
            # retry-proof UNKNOWN RPC status with no explanation).
            return pb.InferResponse(ok=False, verdict=f"error: {e}")
        qps, p99 = self.recent_gauges()
        return pb.InferResponse(
            ok=result.ok, verdict=result.verdict,
            scores=(result.scores.astype("<f4").tobytes()
                    if result.scores is not None else b""),
            # Piggybacked rolling gauges: the fleet router's least-loaded
            # dispatch reads load off every answer instead of scraping.
            qps_recent=qps, p99_seconds_recent=p99,
        )

    def Retrieve(self, req: pb.RetrieveRequest, ctx) -> pb.RetrieveResponse:
        """Candidate generation over the wire — same malformed-input
        verdict contract as Infer (a raise would surface as an opaque
        UNKNOWN status; a verdict names the defect)."""
        if len(req.raw_user_ids) % 8:
            _retrieve_metrics()[0].inc(replica=self.name, verdict="error")
            return pb.RetrieveResponse(
                ok=False,
                verdict=f"error: raw_user_ids is {len(req.raw_user_ids)} "
                        "bytes, not a multiple of 8 (little-endian int64)")
        ids = np.frombuffer(req.raw_user_ids, dtype="<i8")
        fields = int(req.user_fields)
        if fields <= 0 or len(ids) == 0 or len(ids) % fields:
            _retrieve_metrics()[0].inc(replica=self.name, verdict="error")
            return pb.RetrieveResponse(
                ok=False,
                verdict=f"error: {len(ids)} user ids not divisible by "
                        f"user_fields={fields}")
        try:
            result = self.retrieve(ids.reshape(-1, fields),
                                   k=int(req.k),
                                   session_id=str(req.session_id))
        except ValueError as e:
            _retrieve_metrics()[0].inc(replica=self.name, verdict="error")
            return pb.RetrieveResponse(ok=False, verdict=f"error: {e}")
        qps, p99 = self.recent_gauges()
        return pb.RetrieveResponse(
            ok=result.ok, verdict=result.verdict,
            candidate_ids=(result.candidate_ids.astype("<i8").tobytes()
                           if result.candidate_ids is not None else b""),
            scores=(result.scores.astype("<f4").tobytes()
                    if result.scores is not None else b""),
            index_version=int(result.index_version), arm=result.arm,
            qps_recent=qps, p99_seconds_recent=p99,
        )

    def attach_rollout(self, watcher) -> None:
        """Wire a loop/publish.py ModelVersionWatcher: its swaps land via
        :meth:`set_model`, and the Rollout RPC actuates it."""
        self.rollout_watcher = watcher

    def Rollout(self, req: pb.RolloutRequest, ctx) -> pb.RolloutResponse:
        """One-RPC rollout control. ``rollback`` pins publication
        visibility AND swaps this replica to an already-validated older
        version in the same call — instant, and by construction never a
        half-updated model (only CRC-validated, commit-marked versions
        ever enter the bank)."""
        versions = self.model_versions()
        w = self.rollout_watcher
        base = dict(
            active_version=int(versions.get(CONTROL, 0)),
            canary_version=int(versions.get(CANARY, 0)),
            swaps=int(w.swaps) if w is not None else 0,
        )
        action = str(req.action or "status")
        if action == "status":
            return pb.RolloutResponse(ok=True, message="", **base)
        if w is None:
            return pb.RolloutResponse(
                ok=False, message="error: no rollout watcher attached",
                **base)
        if action == "rollback":
            ok, msg = w.rollback(int(req.version) or None)
        elif action == "clear":
            from easydl_tpu_torch.loop.publish import clear_rollback

            clear_rollback(w.dir)
            w.poll_once()
            ok, msg = True, "rollback pin cleared"
        else:
            return pb.RolloutResponse(
                ok=False, message=f"error: unknown action {action!r}",
                **base)
        versions = self.model_versions()
        base.update(active_version=int(versions.get(CONTROL, 0)),
                    canary_version=int(versions.get(CANARY, 0)),
                    swaps=int(w.swaps))
        return pb.RolloutResponse(ok=ok, message=msg, **base)

    # --------------------------------------------------------------- serve
    def serve(self, port: int = 0, obs_workdir: Optional[str] = None,
              obs_name: Optional[str] = None):
        self._server = serve(SERVE_SERVICE, self, port=port,
                             options=GRPC_MSG_OPTIONS)
        cache = getattr(self.reads, "cache", None)
        self._exporter = start_exporter(
            obs_name or self.name, workdir=obs_workdir,
            health_fn=lambda: {
                "replica": self.name,
                "table": self.config.table,
                "queued_examples": self._pending_examples,
                "batches_run": self.batches_run,
                "cache": cache.stats() if cache is not None else None,
                "model_versions": self.model_versions(),
            },
        )
        if obs_workdir:
            # Fleet discovery: one JSON per replica under <workdir>/serve/
            # (atomic rename, removed on clean stop; the router sweeps
            # dead-pid leftovers). This is how a replica joins the
            # router's rotation — same pattern as the obs/ exporter
            # discovery files.
            import json

            d = os.path.join(obs_workdir, "serve")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"{obs_name or self.name}.json")
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"replica": self.name,
                           "address": self._server.address,
                           "pid": os.getpid(),
                           "host": self._server.address.rsplit(":", 1)[0]},
                          f)
            os.replace(tmp, path)
            self._discovery_file = path
        log.info("serve replica %s on :%d (table %s, max_batch %d, "
                 "max_wait %.1fms, admission bound %d)", self.name,
                 self._server.port, self.config.table,
                 self.config.max_batch, self.config.max_wait_ms,
                 self.config.max_pending)
        return self._server

    def stop(self) -> None:
        with self._mu:
            self._stopped = True
            self._mu.notify_all()
        self._runner.join(timeout=10.0)
        with self._mu:
            leftovers = list(self._queue)
            self._queue.clear()
            self._pending_examples = 0
        for w in leftovers:
            if not w.future.done():
                w.future.set_result(
                    InferResult(False, "error: frontend stopped"))
        if self._discovery_file is not None:
            try:
                os.unlink(self._discovery_file)
            except OSError:
                pass
            self._discovery_file = None
        if self._server is not None:
            self._server.stop()
            self._server = None
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None
        if self.feedback is not None:
            try:
                self.feedback.close()
            except Exception as e:  # teardown hygiene, never a crash
                log.warning("feedback writer close failed: %s", e)
