"""The elastic worker with its counters read out, for the on-card checks
(``chip_smoke.py`` phases 8 and 9, ``scripts/nccl_cards.py``'s resize).

    python -m easydl_tpu_torch.scripts.instrumented_worker OUT [--no-state-hashes] \
        [worker arguments]

Runs ``easydl_tpu_torch.elastic.worker`` as an agent would, and starts each
of its local ranks through this module too, which records in ``OUT``:

- ``launches-g<GEN>-a<AGENT RANK>-l<LOCAL RANK>.json``: the rank's flash
  kernel launches (``ops.flash_attention.launches``) when it exits, and
  ``launches-preflight-g<GEN>-...json`` those of its preflight step (the
  launches before ``preflight_go``) where it ran one, and
  ``memory-preflight-g<GEN>-...json`` what the preflight held on its card
  while it waited for the go (``torch.cuda`` allocator bytes: allocated,
  reserved, and the peak of its discarded step);
- ``reads-g<GEN>-a<AGENT RANK>-l<LOCAL RANK>.json``: the chunks its
  restores loaded from the host cache and from storage
  (``core.checkpoint.chunk_reads``), when it exits;
- ``batches-g<GEN>.jsonl``: on global rank 0, one line a train step: the
  step it makes, the sha256 of each array of the rank's batch, and whether
  it was a preflight's discarded step;
- ``states-g<GEN>.jsonl``: on global rank 0, one line each time the worker
  saves (``"saved"``, from ``Trainer.state_leaves``) or restores
  (``"restored"``, from ``Trainer.restore_from``) a state: its step and the
  sha256 of every parameter, both Adam moments and counts, each whole
  (:func:`state_hashes`; every rank takes part), and the seconds that took
  (``hash_s``: time the worker would not spend uninstrumented); with
  ``--no-state-hashes`` only the kind and the step, so that the worker's
  save and restore are timed as they run uninstrumented.

The worker itself is unchanged: the records come from wrapping those two
``Trainer`` methods and ``timeline.emit``, and from an exit hook in the
rank processes; a rank reads its generation when it writes (a standby
learns it at promotion). :func:`start` starts it as an agent of a
generation would, :func:`start_gated` as the agent starts a warm standby or
a preflight.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
from typing import Mapping, Optional, Sequence

REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def hashed_state(record: dict) -> dict:
    """A ``states-g*.jsonl`` record without what is not the state: two
    records hash the same state when these are equal."""
    return {k: v for k, v in record.items() if k not in ("kind", "hash_s")}


def read_jsonl(path) -> list:
    """The whole lines of a JSONL file that a process may be appending to."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.endswith("\n") and line.strip()]


def start(out, workdir, *, gen: int, coord: str, rank: int = 0, world: int = 1,
          agent: str = "a0", args: Sequence[str] = (), hashes: bool = True,
          env: Optional[Mapping[str, str]] = None) -> subprocess.Popen:
    """The instrumented worker of agent ``agent`` (rank ``rank`` of ``world``)
    for generation ``gen``, with the variables the JAX agent sets; its
    output goes to ``workdir/worker-<agent>.log``, its metrics and timeline
    to ``workdir/metrics-<agent>.jsonl`` and ``timeline-<agent>.jsonl``. In
    its own process group; ``hashes=False`` passes ``--no-state-hashes``."""
    full = dict(os.environ, PYTHONPATH=str(REPO), EASYDL_AGENT_ID=agent,
                **generation_env(workdir, gen=gen, coord=coord, rank=rank, world=world,
                                 agent=agent), **(env or {}))
    with open(os.path.join(workdir, f"worker-{agent}.log"), "ab") as log:
        return subprocess.Popen([sys.executable, "-m", __spec__.name, str(out),
                                 *_hash_flag(hashes), *args],
                                env=full, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)


def start_gated(out, workdir, gate: str, *, agent: str = "a0", args: Sequence[str] = (),
                env: Optional[Mapping[str, str]] = None, hashes: bool = True) -> tuple:
    """The instrumented worker as agent ``agent`` starts a gated one:
    ``gate`` is ``"warm"`` (a standby: only ``EASYDL_WARM_FILE`` and the
    timeline; the membership comes later, through :func:`promote`) or
    ``"go"`` (a preflight: ``env`` holds the prepared generation's
    variables, and ``EASYDL_GO_FILE``). Returns ``(process, gate file)``;
    ``<gate file>.ready`` appears once the worker is ready."""
    gate_file = os.path.join(workdir, f".{gate}-{agent}.json")
    for path in (gate_file, gate_file + ".ready"):
        if os.path.exists(path):
            os.remove(path)
    var = "EASYDL_WARM_FILE" if gate == "warm" else "EASYDL_GO_FILE"
    full = {k: v for k, v in os.environ.items()
            if k not in ("EASYDL_RANK", "EASYDL_WORLD", "EASYDL_GEN", "EASYDL_COORD")}
    full.update({"PYTHONPATH": str(REPO), "EASYDL_AGENT_ID": agent, var: gate_file,
                 "EASYDL_TIMELINE": os.path.join(workdir, f"timeline-{agent}.jsonl")})
    full.update(env or {})
    with open(os.path.join(workdir, f"worker-{agent}.log"), "ab") as log:
        proc = subprocess.Popen([sys.executable, "-m", __spec__.name, str(out),
                                 *_hash_flag(hashes), *args],
                                env=full, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
    return proc, gate_file


def promote(gate_file: str, payload: Mapping[str, str]) -> None:
    """The agent's verdict into a gate file, written atomically: the
    membership for a standby, ``{"generation", "coordinator"}`` for a
    preflight."""
    tmp = gate_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(dict(payload), f)
    os.replace(tmp, gate_file)


def generation_env(workdir, *, gen: int, coord: str, rank: int = 0, world: int = 1,
                   agent: str = "a0") -> dict:
    """The membership variables the agent gives generation ``gen``."""
    return {"EASYDL_RANK": str(rank), "EASYDL_WORLD": str(world), "EASYDL_GEN": str(gen),
            "EASYDL_COORD": coord, "EASYDL_WORKDIR": str(workdir),
            "EASYDL_METRICS": os.path.join(workdir, f"metrics-{agent}.jsonl"),
            "EASYDL_TIMELINE": os.path.join(workdir, f"timeline-{agent}.jsonl")}


def run_generation(out, workdir, *, gen: int, agents: int = 1, args: Sequence[str] = (),
                   env=lambda agent: {}, quiesce_at: Optional[int] = None,
                   deadline_s: float = 300) -> None:
    """One generation, as its agents run it: the workers of ``agents``
    agents (:func:`start`; ``env(agent)`` adds to agent ``agent``'s
    variables), SIGUSR1 to the last agent's worker alone once agent a0's
    metrics show step ``quiesce_at``. Raises, with the workers' log tails,
    unless every worker exits 0 (and was signalled, if asked) within
    ``deadline_s``; kills them all first."""
    coord = f"localhost:{free_port()}"
    procs = [start(out, workdir, gen=gen, coord=coord, rank=a, world=agents, agent=f"a{a}",
                   args=args, env=env(a)) for a in range(agents)]
    metrics = os.path.join(workdir, "metrics-a0.jsonl")
    deadline, signalled = time.monotonic() + deadline_s, False
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if quiesce_at and not signalled and any(
                    r["step"] >= quiesce_at and r["generation"] == gen
                    for r in read_jsonl(metrics)):
                procs[-1].send_signal(signal.SIGUSR1)
                signalled = True
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    rcs = [p.returncode for p in procs]
    if rcs != [0] * agents or (quiesce_at and not signalled):
        for a in range(agents):
            with open(os.path.join(workdir, f"worker-a{a}.log")) as f:
                print(f"--- generation {gen}, agent a{a} (rc {rcs[a]}):\n{f.read()[-6000:]}",
                      file=sys.stderr)
        raise RuntimeError(f"generation {gen}: the workers exited {rcs} (killed at the "
                           f"{deadline_s}s deadline if negative), signalled {signalled}")


#: a generation switch on an agent's timeline: the generation before it
#: ends (quiesce), the next one starts
SWITCH = ("quiesce_ckpt_begin", "quiesce_exit", "worker_main_start", "jax_imported",
          "dist_init_done", "trainer_built", "preflight_ready", "preflight_go", "restore_agreed",
          "restored",
          "first_step_done")


def switch_phases(timeline, gen: int = 2) -> dict:
    """The switch into generation ``gen`` on ``timeline`` (a timeline
    JSONL): each phase's time, the quiesce phases of ``gen - 1`` and the rest
    of ``gen``, the first of each (a preflight's start comes before the
    quiesce)."""
    at = {}
    for e in read_jsonl(timeline):
        if e["phase"] in SWITCH and e["gen"] == (gen - 1 if e["phase"].startswith("quiesce")
                                                 else gen):
            at.setdefault(e["phase"], e["t"])
    return at


def switch(timeline, gen: int = 2) -> str:
    """The switch into generation ``gen`` (:func:`switch_phases`), in time
    order: each phase's seconds from ``quiesce_ckpt_begin`` (a preflight's
    first phases are before it) and from the phase before."""
    at = switch_phases(timeline, gen)
    phases = sorted(at, key=at.get)
    t0 = at.get("quiesce_ckpt_begin", at[phases[0]])
    return ", ".join(f"{p} {at[p] - t0:.2f}" + (f" (+{at[p] - at[phases[i - 1]]:.2f})" if i else "")
                     for i, p in enumerate(phases) if p != "quiesce_ckpt_begin")


def whole(t):
    """``t`` whole on every rank (every rank calls this together): the shards
    of a sharded tensor all-gathered with the c10d collective, since
    ``DTensor.full_tensor``'s functional collectives crash (SIGSEGV) over
    gloo on CUDA tensors in torch 2.11. A tensor split on several mesh
    dimensions (``tp`` and ``fsdp``) is gathered cut by cut, the innermost
    first (``core.jax_state.splits``)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from easydl_tpu_torch.core.jax_state import splits

    if not isinstance(t, DTensor):
        return t
    out, mesh = t.to_local().detach(), t.device_mesh
    for dim, cuts in splits(t).items():
        for axis, parts, _ in reversed(cuts):
            pieces = [torch.empty_like(out) for _ in range(parts)]
            dist.all_gather(pieces, out.contiguous(),
                            group=mesh.get_group(mesh.mesh_dim_names.index(axis)))
            out = torch.cat(pieces, dim=dim)
    if out.shape != t.shape:
        raise AssertionError(f"uneven shards: {tuple(out.shape)} gathered, {tuple(t.shape)} held")
    return out


def state_hashes(state) -> dict:
    """sha256 of every parameter and Adam moment, whole (a sharded tensor is
    gathered first: every rank calls this together), and the Adam step."""
    out = {"step": state.step}
    opt = state.optimizer.state
    for name, p in state.model.named_parameters():
        for kind, t in (("", p), (" exp_avg", opt[p]["exp_avg"]),
                        (" exp_avg_sq", opt[p]["exp_avg_sq"])):
            data = whole(t).detach().cpu().numpy().tobytes()
            out[name + kind] = hashlib.sha256(data).hexdigest()
        out[name + " count"] = int(opt[p]["step"])
    return out


def _hash_flag(hashes: bool) -> list:
    return [] if hashes else ["--no-state-hashes"]


def instrument(out: Path, local_rank: int, hashes: bool = True) -> None:
    """Installs the records (see the module docstring) in this rank."""
    import torch
    import torch.distributed as dist

    from easydl_tpu_torch.core import checkpoint
    from easydl_tpu_torch.core.train_loop import Trainer
    from easydl_tpu_torch.elastic import timeline
    from easydl_tpu_torch.ops import flash_attention as fa

    def tag() -> str:  # read late: a standby learns its generation at promotion
        return f"g{os.environ['EASYDL_GEN']}-a{os.environ['EASYDL_RANK']}-l{local_rank}"

    def record(kind: str, state) -> None:
        t0 = time.perf_counter()
        digest = state_hashes(state) if hashes else {"step": state.step}
        if not dist.is_initialized() or dist.get_rank() == 0:
            with open(out / f"states-g{os.environ['EASYDL_GEN']}.jsonl", "a") as f:
                f.write(json.dumps({"kind": kind, "hash_s": time.perf_counter() - t0,
                                    **digest}) + "\n")

    state_leaves, restore_from, emit = Trainer.state_leaves, Trainer.restore_from, timeline.emit
    train_step = Trainer.train_step
    went = {"go": False}  # past preflight_go: the preflight's step is behind

    def recorded_step(self, state, batch):
        if not dist.is_initialized() or dist.get_rank() == 0:
            preflight = bool(os.environ.get("EASYDL_GO_FILE")) and not went["go"]
            with open(out / f"batches-g{os.environ['EASYDL_GEN']}.jsonl", "a") as f:
                f.write(json.dumps({"step": int(state.step) + 1, "preflight": preflight, **{
                    k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
                    for k, v in batch.items()}}) + "\n")
        return train_step(self, state, batch)

    def recorded_leaves(self, state):
        record("saved", state)
        return state_leaves(self, state)

    def recorded_restore(self, checkpoint, step=None):
        state = restore_from(self, checkpoint, step)
        record("restored", state)
        return state

    def recorded_emit(path, phase, generation, **data):
        if phase == "preflight_go":  # every rank passes here; only the lead writes
            (out / f"launches-preflight-{tag()}.json").write_text(json.dumps(fa.launches))
            if torch.cuda.is_initialized():
                (out / f"memory-preflight-{tag()}.json").write_text(json.dumps({
                    "allocated": torch.cuda.memory_allocated(),
                    "reserved": torch.cuda.memory_reserved(),
                    "peak": torch.cuda.max_memory_allocated()}))
            went["go"] = True
        emit(path, phase, generation, **data)

    Trainer.state_leaves, Trainer.restore_from = recorded_leaves, recorded_restore
    Trainer.train_step = recorded_step
    timeline.emit = recorded_emit

    def write_counts() -> None:
        if "EASYDL_GEN" not in os.environ:  # a standby never promoted
            return
        (out / f"launches-{tag()}.json").write_text(json.dumps(fa.launches))
        (out / f"reads-{tag()}.json").write_text(json.dumps(checkpoint.chunk_reads))

    atexit.register(write_counts)


def main() -> None:
    from easydl_tpu_torch.elastic import worker

    out, args = Path(sys.argv[1]), sys.argv[2:]
    hashes = args[:1] != ["--no-state-hashes"]
    args = args[len(_hash_flag(hashes)):]
    if "--local-rank" in args:
        instrument(out, int(args[args.index("--local-rank") + 1]), hashes)
    worker.main(args, rank_cmd=[sys.executable, "-m", __spec__.name, str(out),
                                *_hash_flag(hashes)])


if __name__ == "__main__":
    main()
