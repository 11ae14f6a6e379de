"""The training worker of the elastic runtime, in the port: the process the
agent (re)launches for each membership generation.

Counterpart of ``easydl_tpu/elastic/worker.py``. It speaks the same agent
protocol: it reads ``EASYDL_RANK/WORLD/COORD/GEN/WORKDIR/METRICS/TIMELINE/
MESH`` and ``<workdir>/job.json``, appends one metrics record a step, marks
the same timeline phases, quiesces on SIGUSR1 at a step boundary that every
rank agrees on, checkpoints, and exits 0. So the JAX package's master and
agents drive it unchanged::

    Agent(..., worker_argv=[sys.executable, "-m", "easydl_tpu_torch.elastic.worker"])

    python -m easydl_tpu_torch.elastic.worker [--device cpu] [--nproc N]

**One process per device**, where JAX runs one per host. The process the
agent starts is a supervisor: it starts ``--nproc`` local ranks (default:
every visible GPU, or 1 with ``--device cpu``), forwards SIGUSR1 to them,
and exits 0 only when every rank did; a rank that fails takes its siblings
down and fails the worker, so the agent reports a crash. Each rank:

- joins the generation's group: agent rank 0's first local rank hosts a
  ``TCPStore`` at ``EASYDL_COORD``; every agent publishes its process count
  there, and a rank's global rank is the sum of the counts of the agents
  before it plus its local rank. NCCL on ``cuda:LOCAL_RANK``, gloo on the
  CPU, and beside it a gloo group of CPU tensors for the quiesce consensus.
  With one device in all there is no group, as JAX's worker joins none at
  world 1;
- trains ``job.json``'s model with ``torch.optim.Adam(lr)`` (the JAX
  worker's ``optax.adam``) on the one-device ``Trainer`` or, with several
  devices, on ``Trainer(mesh_spec=...)`` over ``dp`` x ``fsdp`` x ``tp``
  (``EASYDL_MESH``, else ``job.json``'s ``mesh`` with ``dp`` filling the
  world);
- draws agent rank r's rows as the JAX process does,
  ``make_data(global_batch // EASYDL_WORLD, seed=seed + r)``, and takes its
  consecutive share of them (:func:`agent_rows`: the ranks of one ``tp``
  group, consecutive local ranks, take the same share), so the global batch
  is the JAX world's;
- or, with ``data_dir`` in ``job.json``, reads files as the JAX worker
  does: every local rank builds the agent's dataset (``TokenFileDataset``
  or ``ArrayImageDataset`` at rank ``EASYDL_RANK`` of ``EASYDL_WORLD``, the
  agent's rows a batch) and takes its consecutive share of each batch. The
  cursor rides every checkpoint (``{"data_state": ...}``, taken when the
  save is called) and is restored with the model, rescaled when the world
  changed, so the batches, the cursor and its rescale are the JAX worker's
  and a ``data_state`` either worker saved resumes in the other;
- restores the newest committed step that reads back
  (``restore_with_fallback``), a save of either package from any mesh,
  each chunk from the host's chunk cache where this host wrote it.

The lead rank of each agent (local rank 0) writes the agent's metrics,
timeline and tracing spans (``obs/tracing.py``: ``worker_run`` parented on
``EASYDL_TRACE_CONTEXT``, ``dist_init``, ``restore`` and a sampled ``step``
every ``EASYDL_TRACE_STEP_EVERY`` steps; only with ``EASYDL_TRACE`` armed).
With ``EASYDL_CHAOS_SPEC`` set, each step calls the chaos straggler gate for
this agent (``EASYDL_AGENT_ID``) inside its timed window.

The agent's two gated workers:

- **warm standby** (``EASYDL_WARM_FILE``): the supervisor starts its ranks
  at once; each imports torch and the training stack (and loads the
  kernels' library on the host), writes its ready marker and polls the warm
  file for the membership; once every rank is ready the supervisor writes
  ``<warm file>.ready`` and marks ``standby_warm_ready``. The payload then
  starts the generation in every process. No device work happens before
  it; a process in standby exits 0 when its parent changes.
- **preflight** (``EASYDL_GO_FILE``): the ranks rendezvous for the prepared
  generation, build the trainer and run one discarded step on an init state
  and a synthetic batch while the current generation still trains; once
  every rank wrote its ready marker the supervisor writes ``<go
  file>.ready`` and marks ``preflight_ready``. A go verdict for another
  generation or coordinator ends every rank, and the worker, with 3; a
  matching one goes on to the restore.

What the JAX worker does besides (PS mode, feedback spools, click-log
data) is not ported yet: the worker refuses it before it starts a rank,
naming the option.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, List, Mapping, Optional, Sequence

from easydl_tpu_torch.elastic import timeline

#: ``jax.distributed.initialize``'s own default: a generation whose ranks do
#: not all join within it fails instead of hanging
RENDEZVOUS_TIMEOUT_S = 300
#: how often the supervisor looks at its ranks and its parent
POLL_S = 0.1
_QUIESCE = {"flag": False}


def _on_sigusr1(signum, frame) -> None:
    _QUIESCE["flag"] = True


def consensus_interval(target_s: float, step_time_s: float,
                       max_interval: int = 64) -> int:
    """Steps between quiesce-consensus allgathers for a given step time.

    Pure and deterministic: every rank feeds it the same *agreed* (reduced)
    step time, so all ranks compute the same next consensus step. Clamped to
    [1, max_interval] — unknown/zero step time degrades to every-step checks
    (safe), and even microsecond steps check at least every 64 steps so a
    preemption notice is never starved."""
    if step_time_s <= 0:
        return 1
    return max(1, min(max_interval, int(target_s / step_time_s)))


def periodic_ckpt_due(ckpt_interval: int, step: int, next_ckpt: int,
                      target_s: float, agreed_dt: float) -> tuple:
    """Is a periodic checkpoint due at ``step``? → ``(due, next_ckpt)``.

    The single copy of the cadence contract (documented in
    docs/operations.md):

    - ``ckpt_interval < 0`` — periodic checkpoints DISABLED (quiesce and
      final saves still happen). This restores the pre-auto-cadence way to
      turn the schedule off, which the auto default had silently removed
      (ADVICE round 5): any non-positive value used to enable auto with no
      opt-out left.
    - ``ckpt_interval > 0`` — the classic every-N-steps modulo schedule.
    - ``ckpt_interval == 0`` (``"auto"``) — wall-clock cadence: the next
      save step derives from the consensus-agreed step time, so every rank
      computes the same schedule.

    Pure and deterministic so ranks can never disagree (and tests can
    enumerate it)."""
    if ckpt_interval < 0:
        return False, next_ckpt
    if ckpt_interval > 0:
        return step % ckpt_interval == 0, next_ckpt
    due = step >= next_ckpt
    if due:
        next_ckpt = step + consensus_interval(
            target_s, agreed_dt, max_interval=100_000)
    return due, next_ckpt


@dataclass(frozen=True)
class Generation:
    """This worker's place in the generation, as the agent sets it."""

    rank: int  # the agent's rank in the membership
    world: int  # agents in the membership
    coordinator: str
    generation: int
    workdir: str
    metrics: str
    timeline: Optional[str]
    mesh: str  # the mesh the master decided; "" = the job config's

    @classmethod
    def from_env(cls, env: Mapping[str, str]) -> "Generation":
        missing = [v for v in ("EASYDL_RANK", "EASYDL_WORLD", "EASYDL_COORD", "EASYDL_GEN",
                               "EASYDL_WORKDIR", "EASYDL_METRICS") if v not in env]
        if missing:
            raise SystemExit(f"worker: {', '.join(missing)} not set: the elastic agent "
                             "sets them when it starts the worker")
        return cls(rank=int(env["EASYDL_RANK"]), world=int(env["EASYDL_WORLD"]),
                   coordinator=env["EASYDL_COORD"], generation=int(env["EASYDL_GEN"]),
                   workdir=env["EASYDL_WORKDIR"], metrics=env["EASYDL_METRICS"],
                   timeline=env.get("EASYDL_TIMELINE") or None,
                   mesh=env.get("EASYDL_MESH", ""))


def read_job(workdir: str) -> Dict[str, Any]:
    with open(os.path.join(workdir, "job.json")) as f:
        return json.load(f)


def unported(cfg: Mapping[str, Any]) -> List[str]:
    """The options of ``cfg`` that the JAX worker serves and this one does
    not yet (ROADMAP.md Queue A 4-5 and ``loop/``)."""
    out = []
    if dict(cfg.get("model_kwargs", {})).get("embedding") == "ps":
        out.append("model_kwargs.embedding='ps' (PS mode)")
    if cfg.get("feedback_spools"):
        out.append("feedback_spools")
    data_dir = cfg.get("data_dir")
    if data_dir and os.path.exists(os.path.join(data_dir, "sparse.npy")):
        out.append(f"data_dir {data_dir} of click logs (sparse.npy)")
    return out


def agent_rows(per_agent: int, nproc: int, local_rank: int, tp: int = 1) -> slice:
    """A local rank's rows of its agent's ``per_agent``: the agent's
    ``nproc / tp`` batch ranks take consecutive shares in order. ``tp`` is
    the mesh's innermost axis, so a ``tp`` group is ``tp`` consecutive local
    ranks, which take the same share."""
    if nproc % tp:
        raise ValueError(f"tp={tp} does not divide the agent's {nproc} local ranks")
    batch_ranks = nproc // tp
    if per_agent % batch_ranks:
        raise ValueError(f"the agent's {per_agent} rows do not split over {batch_ranks} "
                         f"batch ranks ({nproc} local ranks, tp={tp})")
    share = per_agent // batch_ranks
    first = local_rank // tp * share
    return slice(first, first + share)


def _ready_marker(gate_file: str, local_rank: int) -> str:
    """A rank's marker that it is ready at ``gate_file`` (the warm or go
    file); the supervisor writes ``<gate_file>.ready`` once all are."""
    return f"{gate_file}.ready.{local_rank}"


def _write(path: str, text: str) -> None:
    try:
        with open(path, "w") as f:
            f.write(text)
    except OSError:
        pass


def _poll_json(path: str, parent_pid: int) -> Optional[Dict[str, Any]]:
    """The non-empty JSON object at ``path`` once it is there; None when this
    process's parent changed first (the caller then exits 0)."""
    while True:
        if os.getppid() != parent_pid:
            return None
        try:
            with open(path) as f:
                doc = json.load(f)
            if doc:
                return doc
        except (OSError, ValueError):
            pass
        time.sleep(0.05)


# ----------------------------------------------------------------- supervisor
def supervise(device: str, nproc: int, rank_cmd: Sequence[str]) -> int:
    """The process the agent starts: starts ``nproc`` local ranks (0: one a
    visible GPU, or 1 on the CPU) as ``rank_cmd --device D --nproc N
    --local-rank I``, forwards SIGUSR1 to them and returns 0 once all exited
    0. A rank's failure kills the others and is returned; so is the agent's
    death (4), except in standby (0). The caller has installed the SIGUSR1
    handler. In standby (``EASYDL_WARM_FILE``) the ranks start before the
    membership is known; with ``EASYDL_GO_FILE`` (preflight) the supervisor
    reports its ranks ready."""
    parent_pid = os.getppid()
    warm_file = os.environ.get("EASYDL_WARM_FILE", "")
    if not warm_file:
        gen = Generation.from_env(os.environ)
        _refuse_unported(read_job(gen.workdir))
        timeline.emit(gen.timeline, "worker_main_start", gen.generation, rank=gen.rank)
    nproc = nproc or _device_count(device)
    # a rank holds SIGUSR1 pending, not fatal, until it has its handler
    # (blocked signals stay blocked across exec)
    unblocked = signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGUSR1})
    procs: List[subprocess.Popen] = []
    try:
        for i in range(nproc):
            procs.append(subprocess.Popen([*rank_cmd, "--device", device, "--nproc", str(nproc),
                                           "--local-rank", str(i)]))
    finally:
        signal.pthread_sigmask(signal.SIG_SETMASK, unblocked)
    try:
        if warm_file:
            rc = _standby(warm_file, procs, parent_pid)
            if rc is not None:
                return rc
            gen = Generation.from_env(os.environ)
            _refuse_unported(read_job(gen.workdir))
        go_file = os.environ.get("EASYDL_GO_FILE", "")
        forwarded = False
        while True:
            rc = _failed(procs)
            if rc is not None:
                return rc
            if all(p.returncode == 0 for p in procs):
                return 0
            if os.getppid() != parent_pid:
                print("worker: the agent (parent) died; stopping the ranks", file=sys.stderr,
                      flush=True)
                return 4
            if go_file and _all_ready(go_file, len(procs)):
                _write(go_file + ".ready", str(os.getpid()))
                timeline.emit(gen.timeline, "preflight_ready", gen.generation, rank=gen.rank)
                go_file = ""
            if _QUIESCE["flag"] and not forwarded:
                for p in procs:
                    p.send_signal(signal.SIGUSR1)  # skips a rank that has exited
                forwarded = True
            time.sleep(POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _refuse_unported(cfg: Mapping[str, Any]) -> None:
    refused = unported(cfg)
    if refused:
        raise SystemExit("worker: not ported yet (ROADMAP.md Queue A 4-5 and later): "
                         + "; ".join(refused))


def _failed(procs: Sequence[subprocess.Popen]) -> Optional[int]:
    """The exit code to return when a rank failed (non-zero), else None."""
    for i, p in enumerate(procs):
        rc = p.poll()
        if rc not in (None, 0):
            print(f"worker: local rank {i} exited {rc}; stopping the others", file=sys.stderr,
                  flush=True)
            return rc if rc > 0 else 1
    return None


def _all_ready(gate_file: str, nproc: int) -> bool:
    return all(os.path.exists(_ready_marker(gate_file, i)) for i in range(nproc))


def _standby(warm_file: str, procs: Sequence[subprocess.Popen],
             parent_pid: int) -> Optional[int]:
    """The supervisor's standby: ``<warm_file>.ready`` and
    ``standby_warm_ready`` once every rank is ready, then the membership
    payload merged into this process's environment (the lead rank marks
    ``worker_main_start`` at its promotion). Returns None when promoted,
    else the exit code: a rank's failure, or 0 when the agent (parent) is
    gone."""
    ready = False
    while True:
        rc = _failed(procs)
        if rc is not None:
            return rc
        if os.getppid() != parent_pid:
            return 0
        if not ready and _all_ready(warm_file, len(procs)):
            _write(warm_file + ".ready", str(os.getpid()))
            timeline.emit(os.environ.get("EASYDL_TIMELINE"), "standby_warm_ready", -1)
            ready = True
        if ready:
            try:
                with open(warm_file) as f:
                    payload = json.load(f)
            except (OSError, ValueError):
                payload = None
            if payload:
                os.environ.update({k: str(v) for k, v in payload.items()})
                return None
        time.sleep(POLL_S)


def _warm_wait(warm_file: str, device: str, local_rank: int) -> Optional[Dict[str, str]]:
    """A rank in standby: imports torch and the training stack (the
    expensive part of a rank's start) and, on the GPU, loads the kernels'
    library on the host, with no device work; writes its ready marker and
    returns the membership payload once the agent writes it into
    ``warm_file``, or None when its parent (the supervisor) is gone."""
    parent_pid = os.getppid()
    import torch  # noqa: F401  (the import is the work)

    from easydl_tpu_torch.core import checkpoint, train_loop  # noqa: F401
    from easydl_tpu_torch.models import registry  # noqa: F401
    from easydl_tpu_torch.ops import flash_attention

    if device == "cuda":
        flash_attention._lib()  # dlopen only: no CUDA context yet
    _write(_ready_marker(warm_file, local_rank), str(os.getpid()))
    payload = _poll_json(warm_file, parent_pid)
    # the supervisor marks the standby ready (every rank) before any rank
    # marks the generation's start
    while payload is not None and not os.path.exists(warm_file + ".ready"):
        if os.getppid() != parent_pid:
            return None
        time.sleep(0.01)
    return None if payload is None else {k: str(v) for k, v in payload.items()}


def _die_with_parent() -> None:
    """Linux: SIGKILL this rank when the supervisor dies (the agent kills a
    worker with SIGKILL), so that a rank blocked in a collective does not
    outlive its worker holding its device. The orphan check at each step
    boundary covers the rest."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


# ----------------------------------------------------------------------- rank
def _rendezvous(gen: Generation, local_rank: int, nproc: int):
    """(store, global rank, number of ranks) of this generation's group."""
    import torch.distributed as dist

    host, _, port = gen.coordinator.rpartition(":")
    timeout = timedelta(seconds=RENDEZVOUS_TIMEOUT_S)
    store = dist.TCPStore(host or "localhost", int(port),
                          is_master=gen.rank == 0 and local_rank == 0,
                          timeout=timeout, wait_for_workers=False)
    store = dist.PrefixStore(f"easydl/gen{gen.generation}", store)
    if local_rank == 0:
        store.set(f"nproc/{gen.rank}", str(nproc))
    keys = [f"nproc/{r}" for r in range(gen.world)]
    store.wait(keys, timeout)
    counts = [int(store.get(k)) for k in keys]
    return store, sum(counts[:gen.rank]) + local_rank, sum(counts)


def run_worker(env: Mapping[str, str], device: str = "cuda", local_rank: int = 0,
               nproc: int = 1) -> int:
    """One local rank of the worker (see the module docstring); returns its
    exit code: 0 when done or quiesced, 3 when its preflight was aborted, 4
    when its parent died. SIGUSR1 arrives blocked (``supervise``) and is
    unblocked once handled."""
    signal.signal(signal.SIGUSR1, _on_sigusr1)
    # restart the system calls it interrupts in native threads (gloo, NCCL)
    signal.siginterrupt(signal.SIGUSR1, False)
    signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGUSR1})
    parent_pid = os.getppid()  # before the slow start: see the JAX worker
    _die_with_parent()
    gen = Generation.from_env(env)
    cfg = read_job(gen.workdir)
    lead = local_rank == 0
    tl_path = gen.timeline if lead else None
    # the host's id, which agent-targeted chaos windows name; the file name
    # (metrics-<agent>.jsonl) covers a worker started by hand
    agent_id = env.get("EASYDL_AGENT_ID") or os.path.basename(gen.metrics)[
        len("metrics-"):-len(".jsonl")]

    from easydl_tpu_torch.obs import tracing

    # the lead rank writes the agent's spans, under the master's switch
    # context when the agent passed one; every hook is a no-op unless
    # EASYDL_TRACE is armed
    if lead:
        tracing.configure(env.get(tracing.PROC_ENV) or f"worker-r{gen.rank}", gen.workdir)
    root_span = tracing.start_span("worker_run", parent=tracing.from_env(env),
                                   generation=gen.generation, rank=gen.rank, world=gen.world)
    try:
        trace_step_every = max(1, int(env.get("EASYDL_TRACE_STEP_EVERY") or 25))
    except ValueError:  # a typo'd variable must not take the worker down
        trace_step_every = 25

    import functools
    import logging

    import torch
    import torch.distributed as dist

    from easydl_tpu_torch.core.checkpoint import (CheckpointManager, chunk_reads,
                                                  restore_with_fallback)
    from easydl_tpu_torch.core.mesh import MeshSpec, init_distributed
    from easydl_tpu_torch.core.mfu import peak_flops_per_chip
    from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer
    from easydl_tpu_torch.models.registry import get_model
    from easydl_tpu_torch.utils.device import require_device
    from easydl_tpu_torch.utils.logging import get_logger

    # the protocol's name for the end of the runtime imports (torch here)
    timeline.emit(tl_path, "jax_imported", gen.generation, rank=gen.rank)
    rank, n_ranks, consensus = local_rank, nproc, None
    if gen.world > 1 or nproc > 1:
        with tracing.start_span("dist_init", parent=root_span, coordinator=gen.coordinator,
                                world=gen.world, rank=gen.rank):
            store, rank, n_ranks = _rendezvous(gen, local_rank, nproc)
            dev = init_distributed(device, rank=rank, world_size=n_ranks, local_rank=local_rank,
                                   store=dist.PrefixStore("pg", store))
            consensus = dist.new_group(backend="gloo")
    else:
        dev = require_device(device)
    timeline.emit(tl_path, "dist_init_done", gen.generation, rank=gen.rank)
    log = get_logger("elastic", f"worker-r{rank}")
    if not lead:
        logging.getLogger("easydl_tpu_torch").setLevel(logging.WARNING)

    if gen.mesh:
        # the master's mesh-shape policy decided this generation's shape;
        # a size mismatch is a control-plane bug: fail loudly
        mesh_spec = MeshSpec.parse(gen.mesh)
        if mesh_spec.size != n_ranks:
            raise RuntimeError(f"decided mesh {gen.mesh!r} needs {mesh_spec.size} devices "
                               f"but this world has {n_ranks}")
    else:
        mesh_spec = MeshSpec.from_world(n_ranks, **dict(cfg.get("mesh", {})))
    bundle = get_model(cfg["model"], **dict(cfg.get("model_kwargs", {})))
    global_batch = int(cfg.get("global_batch", 32))
    seed = int(cfg.get("seed", 0))
    trainer = Trainer(
        init_fn=bundle.init_fn,
        loss_fn=bundle.loss_fn,
        optimizer=functools.partial(torch.optim.Adam, lr=float(cfg.get("lr", 1e-3))),
        config=TrainConfig(global_batch=global_batch, grad_accum=int(cfg.get("grad_accum", 1)),
                           seed=seed),
        device=dev,
        jax_layout=bundle.jax_layout,
        # one device in all: the one-device path (FSDP2 at one rank only adds)
        mesh_spec=mesh_spec if n_ranks > 1 else None,
        param_axes=bundle.param_axes,
    )
    timeline.emit(tl_path, "trainer_built", gen.generation, rank=gen.rank)
    per_agent = global_batch // max(gen.world, 1)
    rows = agent_rows(per_agent, nproc, local_rank, mesh_spec.tp)

    go_file = env.get("EASYDL_GO_FILE", "")
    if go_file:
        # preflight: this generation does not exist yet and the current one
        # still trains. One discarded step on an init state and a synthetic
        # batch overlaps the start (and the first step's allocations and
        # kernel loads) with that training; then hold for the verdict
        warm_state = trainer.init_state()
        warm_batch = next(iter(bundle.make_data(per_agent, seed=0)))
        warm_state, warm_metrics = trainer.train_step(
            warm_state, {k: v[rows] for k, v in warm_batch.items()})
        float(warm_metrics["loss"])  # waits for the device
        del warm_state, warm_metrics
        if dev.type == "cuda":
            torch.cuda.empty_cache()  # the live generation shares the card
        _write(_ready_marker(go_file, local_rank), str(os.getpid()))
        go = _poll_json(go_file, parent_pid)
        if go is None:
            return 0
        if int(go.get("generation", -1)) != gen.generation \
                or go.get("coordinator") != gen.coordinator:
            log.info("gen %d: preflight aborted (formed %s@%s)", gen.generation,
                     go.get("generation"), go.get("coordinator"))
            root_span.end(outcome="preflight_abort")
            return 3
        timeline.emit(tl_path, "preflight_go", gen.generation, rank=gen.rank)

    # async saves overlap the chunk IO with training; several ranks commit
    # in ckpt.finalize() at the step boundaries below
    ckpt = CheckpointManager(os.path.join(gen.workdir, "ckpt"), keep=3, async_save=True)

    def restore(step: int):
        # once per candidate: after a corrupt-step fallback the timeline
        # names the step that restored
        timeline.emit(tl_path, "restore_agreed", gen.generation, rank=gen.rank, step=step)
        return trainer.restore_from(ckpt, step)

    restore_span = tracing.start_span("restore", parent=root_span, rank=gen.rank)
    reads_before = dict(chunk_reads)
    state, latest = restore_with_fallback(ckpt, restore)
    restore_span.end(step=latest)
    if latest < 0:
        timeline.emit(tl_path, "restore_agreed", gen.generation, rank=gen.rank, step=-1)
        state, start_step = trainer.init_state(), 0
        log.info("gen %d: fresh init, world=%d (%d devices)", gen.generation, gen.world, n_ranks)
    else:
        start_step = latest
        log.info("gen %d: restored step %d onto world=%d (%d devices); chunks read from "
                 "the host cache %d, from storage %d", gen.generation, latest, gen.world,
                 n_ranks, chunk_reads["cache"] - reads_before["cache"],
                 chunk_reads["storage"] - reads_before["storage"])
    timeline.emit(tl_path, "restored", gen.generation, rank=gen.rank, step=start_step)

    total_steps = int(cfg.get("total_steps", 100))
    ckpt_raw = cfg.get("ckpt_interval", 20)
    ckpt_interval = 0 if str(ckpt_raw) == "auto" else int(ckpt_raw)
    ckpt_target_s = float(cfg.get("ckpt_target_s", 5.0))
    next_ckpt = start_step + 1
    agreed_dt = 0.0
    sync_raw = cfg.get("sync_every", 0)
    sync_every = 0 if str(sync_raw) == "auto" else int(sync_raw)
    sync_target_s = float(cfg.get("sync_target_s", 1.0))
    ema_dt = 0.0
    next_sync = start_step
    source = _file_data(cfg, bundle, per_agent, gen)
    if source is not None:
        if latest >= 0:
            # the cursor resumes with the model; a resized world rescales it
            data_state = ckpt.metadata(latest).get("metadata", {}).get("data_state")
            if data_state:
                source.restore_state(data_state)
        log.info("gen %d: file data %s (%d batches/epoch, agent %d/%d)", gen.generation,
                 cfg["data_dir"], source.batches_per_epoch, gen.rank, gen.world)
        data = iter(source)
    else:
        data = iter(bundle.make_data(per_agent, seed=seed + gen.rank))

    def data_meta():
        # the cursor at the saved step, taken when the save is called
        return {"data_state": source.state()} if source is not None else None

    # live MFU (core/mfu.py, bench.py's definition) where the card's peak is
    # known; an unknown card fails here, at start. The CPU has no peak.
    flops_per_sample = float(bundle.flops_per_sample_hint)
    mfu_denom = (n_ranks * peak_flops_per_chip(torch.cuda.get_device_name(dev))
                 if dev.type == "cuda" and flops_per_sample > 0 else 0.0)
    mesh_key = mesh_spec.key()

    def append_metrics(step: int, loss: float, dt: float) -> None:
        rate = (global_batch / dt) if dt > 0 else 0.0
        rec = {"step": step, "loss": loss, "step_time_s": dt, "samples_per_sec": rate,
               "world_size": n_ranks, "generation": gen.generation, "mesh": mesh_key,
               "t": time.time()}
        if mfu_denom > 0:
            rec["mfu"] = round(rate * flops_per_sample / mfu_denom, 8)
        with open(gen.metrics, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def leave() -> None:
        if consensus is not None:  # rank 0 hosts the store: nobody leaves early
            dist.barrier(group=consensus)
            dist.destroy_process_group()

    maybe_straggle = None
    if env.get("EASYDL_CHAOS_SPEC"):
        from easydl_tpu_torch.chaos.injectors import maybe_straggle

    first_step_emitted = False
    step = start_step
    while step < total_steps:
        if os.getppid() != parent_pid:
            log.warning("gen %d: worker (parent) died; rank exiting at step %d",
                        gen.generation, step)
            root_span.end(outcome="orphaned", step=step)
            return 4
        # quiesce consensus at the step boundary: a rank acts only on the
        # agreed flag, or its peers would hang in the next collective
        want_quiesce = _QUIESCE["flag"]
        if consensus is not None:
            due = (step % sync_every == 0) if sync_every > 0 else (step >= next_sync)
            if due:
                # flag and step-time EMA in one allgather; every rank derives
                # the next consensus step from the same reduced step time
                mine = torch.tensor([1.0 if want_quiesce else 0.0, ema_dt], dtype=torch.float64)
                parts = [torch.empty_like(mine) for _ in range(n_ranks)]
                dist.all_gather(parts, mine, group=consensus)
                flags = torch.stack(parts)
                want_quiesce = bool(flags[:, 0].sum() > 0)
                agreed_dt = float(flags[:, 1].max())
                if sync_every <= 0:
                    next_sync = step + consensus_interval(sync_target_s, agreed_dt)
            else:
                want_quiesce = False
        if want_quiesce:
            # a late SIGUSR1 must be inert: the consensus may quiesce this
            # rank on a peer's flag before its own signal lands
            signal.signal(signal.SIGUSR1, signal.SIG_IGN)
            log.info("gen %d: quiescing at step %d", gen.generation, step)
            timeline.emit(tl_path, "quiesce_ckpt_begin", gen.generation, step=step)
            # skipped if already committed
            ckpt.save(step, trainer.state_leaves(state), metadata=data_meta())
            ckpt.wait()  # the commit lands before this process exits
            timeline.emit(tl_path, "quiesce_exit", gen.generation, step=step)
            root_span.end(outcome="quiesced", step=step)
            leave()
            return 0

        t0 = time.perf_counter()
        if maybe_straggle is not None:
            # inside the timed window, so a slow host shows in the step time;
            # after the quiesce check, so a draining worker exits promptly
            maybe_straggle(gen.rank, agent=agent_id)
        batch = next(data)
        state, metrics = trainer.train_step(state, {k: v[rows] for k, v in batch.items()})
        loss = float(metrics["loss"])  # waits for the device: the real step time
        dt = time.perf_counter() - t0
        ema_dt = dt if ema_dt == 0.0 else 0.8 * ema_dt + 0.2 * dt
        step += 1
        if lead:
            append_metrics(step, loss, dt)
        if step % trace_step_every == 0:
            # written afterwards from the loop's own timing: no step-path work
            t_end = time.time()
            tracing.record_span("step", t_end - dt, t_end, parent=root_span, step=step,
                                loss=round(loss, 5))
        if not first_step_emitted:
            timeline.emit(tl_path, "first_step_done", gen.generation, rank=gen.rank, step=step,
                          step_time_s=round(dt, 3))
            first_step_emitted = True
        # the auto cadence derives from values every rank shares; one rank
        # has nothing to agree with and takes its own EMA
        if ckpt_interval == 0 and consensus is None:
            agreed_dt = ema_dt
        save_due, next_ckpt = periodic_ckpt_due(ckpt_interval, step, next_ckpt, ckpt_target_s,
                                                agreed_dt)
        if save_due and step < total_steps:
            ckpt.save(step, trainer.state_leaves(state), metadata=data_meta())
        ckpt.finalize()  # commits a save of several ranks once all have written

    signal.signal(signal.SIGUSR1, signal.SIG_IGN)  # a finished worker is no crash
    ckpt.save(total_steps, trainer.state_leaves(state), metadata=data_meta())
    ckpt.wait()
    if rank == 0:
        with open(os.path.join(gen.workdir, "DONE"), "w") as f:
            f.write(str(total_steps))
    log.info("gen %d: job complete at step %d", gen.generation, total_steps)
    root_span.end(outcome="done", step=total_steps)
    leave()
    return 0


def _file_data(cfg: Mapping[str, Any], bundle, per_agent: int, gen: Generation):
    """``cfg``'s ``data_dir`` as the agent's dataset (the JAX worker's: its
    rank and world, its rows a batch, the ``train`` split of
    ``val_fraction``), or None for the bundle's synthetic data."""
    data_dir = cfg.get("data_dir")
    if not data_dir:
        return None
    from easydl_tpu_torch.data import ArrayImageDataset, TokenFileDataset

    # val_fraction carves the evaluator's holdout out of training here too
    val_fraction = float(cfg.get("val_fraction", 0.0))
    if os.path.exists(os.path.join(data_dir, "images.npy")):
        return ArrayImageDataset(data_dir, batch_size=per_agent, rank=gen.rank, world=gen.world,
                                 split="train", val_fraction=val_fraction)
    seq_len = int(cfg.get("seq_len", 0)) or getattr(bundle.make_data(1), "seq_len", 0)
    return TokenFileDataset(data_dir, batch_size=per_agent, seq_len=seq_len, rank=gen.rank,
                            world=gen.world, split="train", val_fraction=val_fraction)


def _device_count(device: str) -> int:
    """The default ``--nproc``: every visible GPU, or 1 on the CPU."""
    if device == "cpu":
        return 1
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("worker: --device cuda but no CUDA GPU is available "
                         "(torch.cuda.is_available() is False); pass --device cpu to run "
                         "on the CPU")
    return torch.cuda.device_count()


def main(argv: Optional[Sequence[str]] = None,
         rank_cmd: Sequence[str] = (sys.executable, "-m", "easydl_tpu_torch.elastic.worker")
         ) -> None:
    """The entry point; ``rank_cmd`` is how the supervisor starts a rank
    (the module itself, or a wrapper that instruments it)."""
    # first: a SIGUSR1 during the start must set the flag, not kill the process
    signal.signal(signal.SIGUSR1, _on_sigusr1)
    ap = argparse.ArgumentParser(description="easydl_tpu_torch elastic worker")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; fails without a GPU) or cpu")
    ap.add_argument("--nproc", type=int, default=0,
                    help="local ranks (default: every visible GPU; 1 on the CPU)")
    ap.add_argument("--local-rank", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.local_rank is not None:
        warm_file = os.environ.get("EASYDL_WARM_FILE", "")
        if warm_file:
            payload = _warm_wait(warm_file, args.device, args.local_rank)
            if payload is None:  # the supervisor is gone: nothing to promote
                sys.exit(0)
            os.environ.update(payload)
            if args.local_rank == 0:  # the promote instant: its imports are behind it
                gen = Generation.from_env(os.environ)
                timeline.emit(gen.timeline, "worker_main_start", gen.generation, rank=gen.rank)
        sys.exit(run_worker(os.environ, args.device, args.local_rank, args.nproc))
    rc = supervise(args.device, args.nproc, rank_cmd)
    signal.signal(signal.SIGUSR1, signal.SIG_IGN)  # no signal may kill the exit
    sys.exit(rc)


if __name__ == "__main__":
    main()
