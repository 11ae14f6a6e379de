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
3. One more step under ``torch.profiler`` on every rank: each rank's NCCL
   kernels (device time and count), its kernel time over the untraced
   step, rank 0's FSDP2 ranges. On CUDA it fails unless every rank ran
   NCCL kernels with device time.

Prints step time, tokens/s and peak memory beside the one process's, the
card line, and one JSON object of the readings on the last line. Exits
non-zero if a check fails, a rank fails, or the ranks overrun
:data:`DEADLINE_S`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import torch

from easydl_tpu_torch.models.gpt import SIZES
from easydl_tpu_torch.models.registry import get_model
from easydl_tpu_torch.ops import flash_attention as fa
from easydl_tpu_torch.scripts import gpt345m

LOSS_ABS = 2e-3   # chip_smoke.DIST_LOSS_ABS
PARAM_REL = 2e-3  # chip_smoke.DIST_PARAM_REL
DEADLINE_S = 900  # the ranks, from their start to their exit
FSDP = 2
CPU_RANKS = 4  # the rehearsal's
REPO = Path(__file__).resolve().parents[2]


def log(msg: str) -> None:
    print(msg, flush=True)


def seq_len(size: str) -> int:
    return gpt345m.SEQ if size == "345m" else 64


def bundle_for(size: str):
    """``gpt345m``'s bundle, or a smaller size (seq 64, vocab 256) to rehearse."""
    if size == "345m":
        return gpt345m.bundle()
    return get_model("gpt", size=size, seq_len=seq_len(size), vocab=256, dtype="bfloat16")


def train(trainer, state, data, rows: slice):
    """``gpt345m.STEPS`` steps of this process's ``rows``: (losses, grad
    norms, seconds a step)."""
    losses, norms, step_s = [], [], []
    for _ in range(gpt345m.STEPS):
        batch = next(data)
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, {k: v[rows] for k, v in batch.items()})
        losses.append(float(m["loss"]))  # syncs
        norms.append(float(m["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
    return losses, norms, step_s


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
    ref = None
    if rank == 0:  # one process on this card, the same batches
        bundle = bundle_for(size)
        trainer = gpt345m.trainer(bundle, device=device)
        state = trainer.init_state()
        losses, norms, step_s = train(trainer, state, iter(bundle.make_data(
            gpt345m.GLOBAL_BATCH, seed=0)), slice(None))
        ref = {n: p.detach().clone() for n, p in state.model.named_parameters()}
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
    losses, norms, step_s = train(trainer, state, data, rows)
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    diff = norm = 0.0
    for name, p in state.model.named_parameters():
        full = p.full_tensor().detach()  # every rank gathers together
        if rank == 0:
            diff += (full.float() - ref[name].float()).square().sum().item()
            norm += ref[name].float().square().sum().item()
    batch = next(data)
    prof = profiled(trainer, state, {k: v[rows] for k, v in batch.items()}, device)
    mine = {"rank": rank, "launches": launches, "peak_gib": peak, "profile": prof,
            "losses": losses, "grad_norms": norms, "step_s": step_s}
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    if rank == 0:
        out.update({"mesh": trainer.batch_mesh.shape, "ranks": ranks,
                    "param_rel": math.sqrt(diff / norm),
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
        if cuda and r["launches"] != {k: want for k in r["launches"]}:
            failures.append(f"rank {r['rank']} launches {r['launches']}, want {want} of each")
        if cuda and not nccl_ms > 0:
            failures.append(f"rank {r['rank']}: no NCCL kernel with device time")
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
               "peak_gib_by_rank": [r["peak_gib"] for r in ranks]}
    print(json.dumps(summary), flush=True)
    if failures:
        print("FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(int(sys.argv[2]), Path(sys.argv[3])))
    sys.exit(main())
