"""GPT-2 345M trained over several CUDA GPUs of one host, one process a card
in an NCCL group: the port's distributed path (``core/mesh.py``,
``core/sharding.py``, FSDP2) with collectives that move data between cards,
held against one process.

    python -m easydl_tpu_torch.scripts.nccl_cards
    # rehearsal on the CPU (four gloo ranks, the test size):
    python -m easydl_tpu_torch.scripts.nccl_cards --device cpu --size test

The parent builds the kernels' library (on CUDA) and starts one rank a
visible card (at least 2, an even count) as ``python -m
easydl_tpu_torch.scripts.nccl_cards --rank R WORKDIR``; the ranks only load
the library. Rank r runs on ``cuda:r``, on the mesh dp N/2 x fsdp
:data:`FSDP`, with ``gpt345m``'s set-up: global batch 16 in 2
microbatches, each rank its 16/N rows of every batch.

1. Rank 0 trains one process on its card first (``gpt345m.STEPS`` steps,
   the same batches): its losses, grad norms, step time and parameters
   are the reference. The other ranks wait at a barrier.
2. Every rank: 1 warm-up and 3 timed steps on the mesh. The losses are
   within :data:`LOSS_ABS` of the one process's, step for step, and the
   parameters after them within :data:`PARAM_REL` in relative L2 (the
   bounds of ``chip_smoke.py``'s phases 7a and 7b); each rank launches
   every flash kernel once a layer and microbatch.
   The parameters are also compared after :data:`STEPS_F32` steps.
3. One more step under ``torch.profiler`` on every rank: each rank's NCCL
   kernels (device time and count), its kernel time over the untraced
   step, rank 0's FSDP2 ranges. On CUDA it fails unless every rank ran
   NCCL kernels with device time.
4. Tensor parallelism: the same ``gpt345m.STEPS`` steps on each mesh of
   :func:`tp_meshes` (fsdp 2 x tp 2 and dp 2 x tp 2 on four cards): each
   rank takes its batch coordinate's rows, the ranks of a ``tp`` group the
   same ones; losses within :data:`LOSS_ABS` of the one process's, the
   parameters within :data:`PARAM_REL`, every flash kernel once a layer and
   microbatch on each rank; one traced step's NCCL kernels by rank (the
   ``tp`` all-reduces among them).
5. :data:`STEPS_F32` steps at f32 compute (the f32 model and kernels), one
   process against the mesh: the losses within :data:`LOSS_ABS`; the
   parameter gap is printed. It tells bf16 rounding from a fault of the
   NCCL path.
6. The elastic worker resized across NCCL, once for each pair of
   :func:`resizes` (the ``tp`` pair where four divide the cards) (``elastic/worker.py``, through
   ``scripts/instrumented_worker.py``), on token shards of seeded ids
   (``data_dir``): two agents of N/2 ranks each (their cards set by
   ``CUDA_VISIBLE_DEVICES``, each its own host chunk cache, as two hosts
   have) at dp N/2 x fsdp 2 (or fsdp 2 x tp 2), SIGUSR1 to the second
   agent's worker alone; both must quiesce at one step. Then the first
   agent alone, N/2 ranks at dp N/2 (or tp 2), restores that step by
   reshard (every tensor and count
   bit-equal, sha256, to the state saved) and trains to step
   :data:`RESIZE_STEPS` and ``DONE``, losing no step; every rank launches
   each kernel once a layer, microbatch and step. The data cursor is the
   agents' (world 2, 8 rows) at the quiesce and rescales onto one agent
   (16 rows) at the same global position: global rank 0's rows of every
   step (its ``tp`` group's share) are an uninterrupted reader's. Each restoring rank counts the
   chunks it read from its host's cache and from storage: from storage
   only what the first agent's ranks did not write.

Prints step time, tokens/s and peak memory beside the one process's, the
card line, and one JSON object of the readings on the last line. Exits
non-zero if a check fails, a rank fails, or the ranks overrun
:data:`DEADLINE_S`.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

from easydl_tpu_torch.core.train_loop import TrainConfig
from easydl_tpu_torch.models.gpt import SIZES
from easydl_tpu_torch.models.registry import get_model
from easydl_tpu_torch.ops import flash_attention as fa
from easydl_tpu_torch.scripts import gpt345m
from easydl_tpu_torch.scripts.instrumented_worker import whole

LOSS_ABS = 2e-3   # chip_smoke.DIST_LOSS_ABS
PARAM_REL = 2e-3  # chip_smoke.DIST_PARAM_REL
DEADLINE_S = 900  # the ranks, from their start to their exit
FSDP = 2
CPU_RANKS = 4  # the rehearsal's
STEPS_F32 = 2
RESIZE_STEPS, RESIZE_QUIESCE_AT = 6, 2

RESIZE_DEADLINE_S = 300  # a generation of the resize, from its start to its exit
F32_CONFIG = TrainConfig(global_batch=gpt345m.GLOBAL_BATCH, grad_accum=gpt345m.MICROBATCHES,
                         compute_dtype=torch.float32)
REPO = Path(__file__).resolve().parents[2]


def log(msg: str) -> None:
    print(msg, flush=True)


def seq_len(size: str) -> int:
    return gpt345m.SEQ if size == "345m" else 64


def model_kwargs(size: str, dtype: str = "bfloat16") -> dict:
    """``gpt345m``'s model, or a smaller size (seq 64, vocab 256) to rehearse."""
    if size == "345m":
        return {"size": size, "seq_len": gpt345m.SEQ, "vocab": gpt345m.VOCAB, "dtype": dtype}
    return {"size": size, "seq_len": seq_len(size), "vocab": 256, "dtype": dtype}


def bundle_for(size: str, dtype: str = "bfloat16"):
    return get_model("gpt", **model_kwargs(size, dtype))


def train(trainer, state, data, rows: slice, steps: int = gpt345m.STEPS, after=None):
    """``steps`` steps of this process's ``rows``: (losses, grad norms,
    seconds a step); ``after(step, state)`` runs after each, untimed."""
    losses, norms, step_s = [], [], []
    for step in range(1, steps + 1):
        batch = next(data)
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, {k: v[rows] for k, v in batch.items()})
        losses.append(float(m["loss"]))  # syncs
        norms.append(float(m["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
        if after is not None:
            after(step, state)
    return losses, norms, step_s


def param_rel(state, ref: dict, rank: int) -> float:
    """Relative L2 of the mesh's parameters (every rank gathers together)
    from one process's ``ref``, on rank 0 (None on the others)."""
    diff = norm = 0.0
    for name, p in state.model.named_parameters():
        full = whole(p)
        if rank == 0:
            diff += (full.float() - ref[name].float()).square().sum().item()
            norm += ref[name].float().square().sum().item()
    return math.sqrt(diff / norm) if rank == 0 else None


def snapshot(state) -> dict:
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def profiled(trainer, state, batch, device: torch.device) -> dict:
    """One traced step: NCCL kernels, all kernels and FSDP2's ranges."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        _, m = trainer.train_step(state, batch)
        float(m["loss"])
    events = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False)]
    nccl = [k for k in kernels if "nccl" in k[0].lower()]
    fsdp = {}
    for e in events:
        if e.key.startswith("FSDP::") and e.device_type == torch.autograd.DeviceType.CPU:
            name = e.key.split(" (")[0]
            fsdp[name] = fsdp.get(name, 0.0) + e.cpu_time_total / 1e3
    return {"kernel_ms": sum(ms for _, ms, _ in kernels),
            "nccl": [[n[:90], ms, c] for n, ms, c in sorted(nccl, key=lambda k: -k[1])],
            "fsdp_host_ms": fsdp}


def tp_meshes(world: int) -> list:
    """The tensor-parallel meshes of ``world`` ranks: fsdp 2 x tp 2 and
    dp x tp 2 (dp filling the world), where four divide it."""
    if world % 4:
        return []
    return [{"dp": world // 4, "fsdp": 2, "tp": 2}, {"dp": world // 2, "tp": 2}]


def resizes(world: int) -> dict:
    """The resizes, by name: (generation 1's mesh, generation 2's), two
    agents of ``world / 2`` ranks, then the first alone; the ``tp`` one
    where four divide the world."""
    out = {"fsdp": (f"dp={world // FSDP},fsdp={FSDP}", f"dp={world // 2}")}
    if tp_meshes(world):
        out["tp"] = (f"dp={world // 4},fsdp=2,tp=2", f"dp={world // 4},tp=2")
    return out


def rank_main(rank: int, work: Path) -> int:
    import faulthandler

    import torch.distributed as dist

    from easydl_tpu_torch.core.mesh import MeshSpec, init_distributed

    faulthandler.enable()
    spec = json.loads((work / "spec.json").read_text())
    world, size = spec["world"], spec["size"]
    if spec["device"] == "cpu":
        torch.set_num_threads(2)
    device = init_distributed(spec["device"], rank=rank, world_size=world, local_rank=rank,
                              store=dist.FileStore(str(work / "store"), world),
                              timeout=timedelta(seconds=DEADLINE_S))
    if device.type == "cuda":
        fa._lib()
    rows = slice(rank * gpt345m.GLOBAL_BATCH // world, (rank + 1) * gpt345m.GLOBAL_BATCH // world)
    out: dict = {}
    refs: dict = {}  # one process's parameters after STEPS_F32 and gpt345m.STEPS steps
    if rank == 0:  # one process on this card, the same batches
        bundle = bundle_for(size)
        trainer = gpt345m.trainer(bundle, device=device)
        state = trainer.init_state()
        losses, norms, step_s = train(
            trainer, state, iter(bundle.make_data(gpt345m.GLOBAL_BATCH, seed=0)), slice(None),
            after=lambda step, st: refs.__setitem__(step, snapshot(st))
            if step in (STEPS_F32, gpt345m.STEPS) else None)
        out["one"] = {"losses": losses, "grad_norms": norms, "step_s": step_s}
        del state, trainer
        if device.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()

    bundle = bundle_for(size)
    trainer = gpt345m.trainer(bundle, device=device,
                              mesh_spec=MeshSpec(dp=world // FSDP, fsdp=FSDP))
    state = trainer.init_state()
    data = iter(bundle.make_data(gpt345m.GLOBAL_BATCH, seed=0))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    fa.reset_launches()
    rel: dict = {}

    def after(step, st):
        if step in (STEPS_F32, gpt345m.STEPS):
            rel[step] = param_rel(st, refs.get(step), rank)

    losses, norms, step_s = train(trainer, state, data, rows, after=after)
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    batch = next(data)
    prof = profiled(trainer, state, {k: v[rows] for k, v in batch.items()}, device)
    mesh_shape = list(trainer.batch_mesh.shape)
    del state, trainer

    tp = {}  # the tensor-parallel meshes, against the same reference
    for spec_tp in tp_meshes(world):
        trainer = gpt345m.trainer(bundle, device=device, mesh_spec=MeshSpec(**spec_tp))
        state = trainer.init_state()
        share = gpt345m.GLOBAL_BATCH // trainer.ranks
        tp_rows = slice(trainer.rank * share, (trainer.rank + 1) * share)
        data = iter(bundle.make_data(gpt345m.GLOBAL_BATCH, seed=0))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        fa.reset_launches()
        tp_losses, _, tp_step_s = train(trainer, state, data, tp_rows)
        reading = {"losses": tp_losses, "step_s": tp_step_s, "launches": dict(fa.launches),
                   "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30
                   if device.type == "cuda" else None,
                   "param_rel": param_rel(state, refs.get(gpt345m.STEPS), rank)}
        batch = next(data)
        reading["profile"] = profiled(trainer, state, {k: v[tp_rows] for k, v in batch.items()},
                                      device)
        by_rank = [None] * world
        dist.all_gather_object(by_rank, reading)
        tp[MeshSpec(**spec_tp).key()] = by_rank
        del state, trainer
        if device.type == "cuda":
            torch.cuda.empty_cache()
    del refs

    # the same at f32 compute (the f32 kernels, no bf16 rounding): does the
    # NCCL path itself add error? (ROADMAP Queue C 1)
    f32, f32_ref = {}, None
    if rank == 0:
        bundle = bundle_for(size, "float32")
        trainer = gpt345m.trainer(bundle, device=device, config=F32_CONFIG)
        state = trainer.init_state()
        f32["one_losses"], _, _ = train(trainer, state, iter(bundle.make_data(
            gpt345m.GLOBAL_BATCH, seed=0)), slice(None), steps=STEPS_F32)
        f32_ref = snapshot(state)
        del state, trainer
        if device.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    bundle = bundle_for(size, "float32")
    trainer = gpt345m.trainer(bundle, device=device, config=F32_CONFIG,
                              mesh_spec=MeshSpec(dp=world // FSDP, fsdp=FSDP))
    state = trainer.init_state()
    f32["losses"], _, _ = train(trainer, state, iter(bundle.make_data(gpt345m.GLOBAL_BATCH, seed=0)),
                                rows, steps=STEPS_F32)
    f32["param_rel"] = param_rel(state, f32_ref, rank)
    del state, trainer
    mine = {"rank": rank, "launches": launches, "peak_gib": peak, "profile": prof,
            "losses": losses, "grad_norms": norms, "step_s": step_s}
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    if rank == 0:
        out.update({"mesh": mesh_shape, "ranks": ranks,
                    "param_rel": rel[gpt345m.STEPS], "param_rel_by_step": rel, "f32": f32,
                    "tp": tp,
                    "backend": dist.get_backend()})
        (work / "result.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_ranks(work: Path, world: int) -> None:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.setdefault("OMP_NUM_THREADS", "2")
    logs = [open(work / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", "easydl_tpu_torch.scripts.nccl_cards",
                               "--rank", str(r), str(work)], cwd=REPO, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + DEADLINE_S
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break  # a rank failed: the others would wait out their timeout
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    rcs = [p.returncode for p in procs]
    if rcs != [0] * world:
        for r in range(world):
            print(f"--- rank {r} (rc {rcs[r]}):\n{(work / f'rank{r}.log').read_text()[-4000:]}",
                  file=sys.stderr)
        raise SystemExit(f"ranks exited {rcs} (killed at the {DEADLINE_S}s deadline if -9)")


def resize(work: Path, world: int, device: str, size: str, pair: tuple) -> dict:
    """The elastic worker resized across NCCL (see the module docstring):
    generation 1 is two agents of ``world / 2`` ranks each at ``pair[0]``
    (dp x fsdp :data:`FSDP`, or fsdp 2 x tp 2), quiesced by SIGUSR1 to the
    second agent's worker alone; generation 2 is the first agent alone at
    ``pair[1]`` (dp ``world / 2``, or tp 2), restoring by reshard and
    training to ``DONE``. Returns the readings; raises on a failed check."""
    from easydl_tpu_torch.core.mesh import MeshSpec
    from easydl_tpu_torch.scripts import instrumented_worker as iw

    from easydl_tpu_torch.data import TokenFileDataset, write_token_shards

    half = world // 2
    meshes = {g: MeshSpec.parse(pair[g - 1]).key() for g in (1, 2)}
    tps = {g: MeshSpec.parse(meshes[g]).tp for g in (1, 2)}
    kwargs = model_kwargs(size)
    window, rows = kwargs["seq_len"] + 1, gpt345m.GLOBAL_BATCH
    write_token_shards(np.random.default_rng(0).integers(0, kwargs["vocab"],
                                                         2 * RESIZE_STEPS * rows * window),
                       str(work / "tokens"), shard_size=RESIZE_STEPS * rows * window + 7)
    job = {"model": "gpt", "model_kwargs": kwargs, "data_dir": str(work / "tokens"),
           "global_batch": rows, "grad_accum": gpt345m.MICROBATCHES, "lr": 2e-4,
           "seed": 0, "sync_every": 1, "ckpt_interval": -1, "total_steps": RESIZE_STEPS}
    (work / "job.json").write_text(json.dumps(job))
    counts = work / "counts"
    counts.mkdir()
    args = ["--device", device, "--nproc", str(half)]
    # each agent a host of its own: its own chunk cache (in RAM where there
    # is /dev/shm), so the second agent's chunks are not the first's to read
    shm = "/dev/shm" if os.access("/dev/shm", os.W_OK) else None
    caches = [tempfile.mkdtemp(prefix=f"nccl_cards_cache_a{a}_", dir=shm) for a in (0, 1)]

    def env(agent: int, mesh: str) -> dict:
        out = {"EASYDL_MESH": mesh, "EASYDL_CHUNK_CACHE": caches[agent]}
        if device == "cpu":
            return {**out, "OMP_NUM_THREADS": "2"}
        return {**out, "CUDA_VISIBLE_DEVICES": ",".join(str(agent * half + i)
                                                        for i in range(half))}

    t0 = time.perf_counter()
    try:
        for gen, agents, mesh in ((1, 2, meshes[1]), (2, 1, meshes[2])):
            iw.run_generation(counts, work, gen=gen, agents=agents, args=args,
                              env=lambda a: env(a, mesh), deadline_s=RESIZE_DEADLINE_S,
                              quiesce_at=RESIZE_QUIESCE_AT if gen == 1 else None)
        seconds = time.perf_counter() - t0
        # the chunks only the second agent's host holds: what its ranks wrote
        # and the first agent's did not
        moved = {str(p.relative_to(caches[1])).split("/", 2)[-1]
                 for p in Path(caches[1]).rglob("*.npy")} - {
                     str(p.relative_to(caches[0])).split("/", 2)[-1]
                     for p in Path(caches[0]).rglob("*.npy")}
    finally:
        for cache in caches:
            shutil.rmtree(cache, ignore_errors=True)
    metrics = {a: iw.read_jsonl(work / f"metrics-{a}.jsonl") for a in ("a0", "a1")}
    quiesced = {a: [e["step"] for e in iw.read_jsonl(work / f"timeline-{a}.jsonl")
                    if e["phase"] == "quiesce_exit"] for a in ("a0", "a1")}
    states = {g: iw.read_jsonl(counts / f"states-g{g}.jsonl") for g in (1, 2)}
    launches = {f.stem: json.loads(f.read_text()) for f in sorted(counts.glob("launches-*"))}
    gen1 = [r for r in metrics["a0"] if r["generation"] == 1]
    gen2 = [r for r in metrics["a0"] if r["generation"] == 2]
    q = gen1[-1]["step"]
    saved = [h for h in states[1] if h["kind"] == "saved" and h["step"] == q]
    restored = [h for h in states[2] if h["kind"] == "restored"]
    failures = []
    if quiesced != {"a0": [q], "a1": [q]} or metrics["a1"][-1]["step"] != q:
        failures.append(f"the agents quiesced at {quiesced}, last steps {q} and "
                        f"{metrics['a1'][-1]['step']}")
    if [r["step"] for r in gen2] != list(range(q + 1, RESIZE_STEPS + 1)):
        failures.append(f"generation 2 trained {[r['step'] for r in gen2]} after step {q}")
    if {(r["world_size"], r["mesh"]) for r in gen1} != {(world, meshes[1])} \
            or {(r["world_size"], r["mesh"]) for r in gen2} != {(half, meshes[2])}:
        failures.append("world sizes or meshes: "
                        f"{sorted({(r['world_size'], r['mesh']) for r in gen1 + gen2})}")
    if (work / "DONE").read_text() != str(RESIZE_STEPS):
        failures.append("no DONE")
    if not (saved and [h["step"] for h in restored] == [q]
            and iw.hashed_state(restored[0]) == iw.hashed_state(saved[0])):
        failures.append(f"the state restored at step {q} is not the one saved ({len(saved)} "
                        f"saves, restores at {[h['step'] for h in restored]})")
    want = {1: SIZES[size][0] * gpt345m.MICROBATCHES * q,
            2: SIZES[size][0] * gpt345m.MICROBATCHES * (RESIZE_STEPS - q)}
    if device == "cuda":
        for name, c in launches.items():
            if c != fa.expected_launches(bf16=want[int(name.split("-")[1][1:])]):
                failures.append(f"{name}: {c}, want {want}")
    if len(launches) != world + half:
        failures.append(f"{len(launches)} ranks reported launches, want {world + half}")
    # the data: the agents' cursor rescaled to one agent at the same global
    # position; global rank 0's rows (the first share of the first agent's)
    # of every step against an uninterrupted reader's
    def state(step: int) -> dict:
        manifest = work / "ckpt" / f"step_{step:08d}" / "manifest.json"
        return json.loads(manifest.read_text())["metadata"]["data_state"]

    if (state(q), state(RESIZE_STEPS)) != (
            {"epoch": 0, "cursor": q, "world": 2, "batch": rows // 2},
            {"epoch": 0, "cursor": RESIZE_STEPS, "world": 1, "batch": rows}):
        failures.append(f"data cursors {state(q)} at step {q}, {state(RESIZE_STEPS)} at the end")
    tokens, seq = str(work / "tokens"), kwargs["seq_len"]
    resumed = TokenFileDataset(tokens, batch_size=rows, seq_len=seq)
    resumed.restore_state(state(q))
    readers = {1: iter(TokenFileDataset(tokens, batch_size=rows // 2, seq_len=seq, rank=0,
                                        world=2)),
               2: iter(resumed)}
    # global rank 0's: its agent's rows over the agent's batch ranks
    want_rows = {1: rows // 2 // (half // tps[1]), 2: rows // (half // tps[2])}
    got = {g: [r for r in iw.read_jsonl(counts / f"batches-g{g}.jsonl") if not r["preflight"]]
           for g in (1, 2)}
    for g in (1, 2):
        for rec in got[g]:
            batch = next(readers[g])
            want = {k: hashlib.sha256(np.ascontiguousarray(v[:want_rows[g]]).tobytes()).hexdigest()
                    for k, v in batch.items()}
            if {k: rec[k] for k in want} != want:
                failures.append(f"generation {g} step {rec['step']}: global rank 0's rows are "
                                "not an uninterrupted reader's")
    reads = {f.stem: json.loads(f.read_text()) for f in sorted(counts.glob("reads-g2-*"))}
    if len(reads) != half or any(r["cache"] == 0 for r in reads.values()) \
            or (not moved and any(r["storage"] for r in reads.values())):
        failures.append(f"restore chunk reads {reads}, {len(moved)} chunks only the second "
                        "agent's host holds")
    out = {"meshes": meshes, "quiesce_step": q, "losses": [r["loss"] for r in gen1 + gen2],
           "reads": reads, "moved_chunks": len(moved),
           "step_s": [r["step_time_s"] for r in gen1 + gen2],
           "hashes": len(iw.hashed_state(saved[0])) - 1 if saved else 0,
           "hash_s": [(h["kind"], h["step"], h["hash_s"]) for h in states[1] + states[2]],
           "launches": launches, "seconds": seconds,
           "switch": iw.switch(work / "timeline-a0.jsonl")}
    if failures:
        raise SystemExit("resize: " + "; ".join(failures) + f" ({out})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--size", default="345m")
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("no CUDA GPU: run on a machine with several cards, or pass --device cpu")
    world = torch.cuda.device_count() if cuda else CPU_RANKS
    if world < FSDP or world % FSDP:
        raise SystemExit(f"{world} cards visible: the mesh needs a multiple of {FSDP}")
    cards = []  # each card's name and power limit
    if cuda:
        cards = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
        t0 = time.perf_counter()
        fa._lib()
        log(f"build: {time.perf_counter() - t0:.1f}s | torch {torch.__version__} "
            f"cuda {torch.version.cuda}")
    with tempfile.TemporaryDirectory(prefix="nccl_cards_") as tmp:
        work = Path(tmp)
        (work / "spec.json").write_text(json.dumps(
            {"world": world, "size": args.size, "device": args.device}))
        t0 = time.perf_counter()
        run_ranks(work, world)
        seconds = time.perf_counter() - t0
        res = json.loads((work / "result.json").read_text())
    elastic = {}
    for kind, pair in resizes(world).items():
        with tempfile.TemporaryDirectory(prefix=f"nccl_cards_resize_{kind}_") as tmp:
            elastic[kind] = resize(Path(tmp), world, args.device, args.size, pair)

    one, ranks = res["one"], res["ranks"]
    r0 = ranks[0]
    step_one = sum(one["step_s"][1:]) / len(one["step_s"][1:])
    step_mesh = max(sum(r["step_s"][1:]) / len(r["step_s"][1:]) for r in ranks)
    failures = []
    worst = max(abs(a - b) for a, b in zip(r0["losses"], one["losses"]))
    log(f"mesh {res['mesh']} over {res['backend']}, {world} ranks, {args.size}: losses "
        f"{r0['losses']} (one process {one['losses']}, worst |diff| {worst:.3g}, bound "
        f"{LOSS_ABS}); grad norms {r0['grad_norms']} (one process {one['grad_norms']}); "
        f"parameters vs one process relative L2 {res['param_rel']:.4g} (bound {PARAM_REL})")
    if worst > LOSS_ABS:
        failures.append(f"losses {worst:.3g} from one process's")
    if not res["param_rel"] <= PARAM_REL:
        failures.append(f"parameters {res['param_rel']:.4g} from one process's")
    f32 = res["f32"]
    worst32 = max(abs(a - b) for a, b in zip(f32["losses"], f32["one_losses"]))
    log(f"parameters vs one process, relative L2, by step: {res['param_rel_by_step']} (bf16); "
        f"at f32 compute after {STEPS_F32} steps {f32['param_rel']:.4g}, losses {f32['losses']} "
        f"(one process {f32['one_losses']}, worst |diff| {worst32:.3g})")
    if worst32 > LOSS_ABS:
        failures.append(f"f32 losses {worst32:.3g} from one process's")
    for kind, e in elastic.items():
        log(f"elastic resize ({kind}): {world} ranks (2 agents, {e['meshes'][1]}) quiesced at "
            f"step {e['quiesce_step']} on SIGUSR1 to one agent; {world // 2} ranks "
            f"({e['meshes'][2]}) restored it ({e['hashes']} tensors and counts bit-equal to the "
            f"saved ones) and trained to step {RESIZE_STEPS}; losses {e['losses']}, step "
            f"seconds {e['step_s']}; switch (s from quiesce_ckpt_begin): {e['switch']}; "
            f"hashing (not the worker's own time) {e['hash_s']}; {e['seconds']:.1f}s for both "
            f"generations; restore chunk reads by rank {e['reads']}, chunks only the second "
            f"agent's host held {e['moved_chunks']}")
    want = gpt345m.MICROBATCHES * gpt345m.STEPS * SIZES[args.size][0]
    for r in ranks:
        p = r["profile"]
        step = sum(r["step_s"][1:]) / len(r["step_s"][1:])
        nccl_ms = sum(ms for _, ms, _ in p["nccl"])
        log(f"rank {r['rank']}: step {step:.4f}s ({r['step_s']}), peak "
            f"{r['peak_gib'] if r['peak_gib'] is None else round(r['peak_gib'], 2)} GiB, "
            f"launches {r['launches']}; traced step: kernels {p['kernel_ms']:.1f} ms "
            f"({p['kernel_ms'] / 1e3 / step:.3f} of the untraced step), NCCL kernels "
            f"{nccl_ms:.3f} ms in {sum(c for *_, c in p['nccl'])} launches: "
            + "; ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in p["nccl"][:6]))
        if r["losses"] != r0["losses"]:
            failures.append(f"rank {r['rank']} reports losses {r['losses']}, rank 0 {r0['losses']}")
        if cuda and r["launches"] != fa.expected_launches(bf16=want):
            failures.append(f"rank {r['rank']} launches {r['launches']}, want {want} of each")
        if cuda and not nccl_ms > 0:
            failures.append(f"rank {r['rank']}: no NCCL kernel with device time")
    for key, by_rank in res["tp"].items():
        losses = by_rank[0]["losses"]
        worst_tp = max(abs(a - b) for a, b in zip(losses, one["losses"]))
        log(f"mesh {key}: losses {losses} (one process, worst |diff| {worst_tp:.3g}, bound "
            f"{LOSS_ABS}); parameters vs one process relative L2 {by_rank[0]['param_rel']:.4g} "
            f"(bound {PARAM_REL})")
        if worst_tp > LOSS_ABS:
            failures.append(f"{key}: losses {worst_tp:.3g} from one process's")
        if not by_rank[0]["param_rel"] <= PARAM_REL:
            failures.append(f"{key}: parameters {by_rank[0]['param_rel']:.4g} from one process's")
        for r, reading in enumerate(by_rank):
            p = reading["profile"]
            step = sum(reading["step_s"][1:]) / len(reading["step_s"][1:])
            nccl_ms = sum(ms for _, ms, _ in p["nccl"])
            log(f"  {key} rank {r}: step {step:.4f}s ({reading['step_s']}), peak "
                f"{reading['peak_gib'] if reading['peak_gib'] is None else round(reading['peak_gib'], 2)}"
                f" GiB, launches {reading['launches']}; traced step: kernels "
                f"{p['kernel_ms']:.1f} ms, NCCL kernels {nccl_ms:.3f} ms in "
                f"{sum(c for *_, c in p['nccl'])} launches: "
                + "; ".join(f"{n} {ms:.3f} ms x{c}" for n, ms, c in p["nccl"][:6]))
            if reading["losses"] != losses:
                failures.append(f"{key} rank {r} reports losses {reading['losses']}")
            if cuda and reading["launches"] != fa.expected_launches(bf16=want):
                failures.append(f"{key} rank {r} launches {reading['launches']}, want {want}")
            if cuda and not nccl_ms > 0:
                failures.append(f"{key} rank {r}: no NCCL kernel with device time")
    log("rank 0 FSDP2 host ms (traced, with what they call): " + "; ".join(
        f"{n} {ms:.1f}" for n, ms in sorted(r0["profile"]["fsdp_host_ms"].items(),
                                            key=lambda kv: -kv[1])))
    tokens = gpt345m.GLOBAL_BATCH * seq_len(args.size)
    log(f"step {step_mesh:.4f}s on {world} ranks (slowest rank) vs {step_one:.4f}s one "
        f"process; tokens/s {tokens / step_mesh:.0f} vs {tokens / step_one:.0f}; ranks ran "
        f"{seconds:.1f}s in all")
    for i, card in enumerate(cards):
        log(f"card {i}: {card}")
    summary = {"ok": not failures, "world": world, "mesh": res["mesh"],
               "backend": res["backend"], "cards": cards, "losses": r0["losses"],
               "one_process_losses": one["losses"], "param_rel": res["param_rel"],
               "step_s": step_mesh, "one_process_step_s": step_one,
               "nccl_ms_by_rank": [sum(ms for _, ms, _ in r["profile"]["nccl"])
                                   for r in ranks],
               "peak_gib_by_rank": [r["peak_gib"] for r in ranks],
               "param_rel_by_step": res["param_rel_by_step"], "f32_param_rel": f32["param_rel"],
               "tp": {key: {"losses": by_rank[0]["losses"], "param_rel": by_rank[0]["param_rel"],
                            "step_s": max(sum(r["step_s"][1:]) / len(r["step_s"][1:])
                                          for r in by_rank),
                            "peak_gib_by_rank": [r["peak_gib"] for r in by_rank],
                            "nccl_ms_by_rank": [sum(ms for _, ms, _ in r["profile"]["nccl"])
                                                for r in by_rank]}
                      for key, by_rank in res["tp"].items()},
               "resize": {kind: {k: e[k] for k in ("meshes", "quiesce_step", "losses", "hashes",
                                                   "seconds", "reads", "moved_chunks")}
                          for kind, e in elastic.items()}}
    print(json.dumps(summary), flush=True)
    if failures:
        print("FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(int(sys.argv[2]), Path(sys.argv[3])))
    sys.exit(main())
