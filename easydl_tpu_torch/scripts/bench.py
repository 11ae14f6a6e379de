"""The port's training benchmark: the counterpart of ``bench.py``'s
measurement, on one CUDA GPU.

    python -m easydl_tpu_torch.scripts.bench
    # rehearsal on the CPU (the test size, seq 32, vocab 256):
    python -m easydl_tpu_torch.scripts.bench --device cpu --size test
    # on a mesh, one process a card (``bench.py --mesh``'s counterpart):
    python -m torch.distributed.run --nproc-per-node 4 \
        -m easydl_tpu_torch.scripts.bench --mesh dp=2,tp=2

``bench.py``'s accelerator configuration: GPT-2 345M at seq 1024
(``gpt345m``'s sizes and its ``BENCH`` options: remat of every block under
the "dots" policy), bf16 model dtype over f32 masters, the logits loss
(``fused_loss=False``), AdamW(2e-4, weight decay 0.01), global batch 256 in
32 microbatches of 8. 2 warm-up steps, then 3 timed steps that end in a
sync. Prints one JSON line with ``bench.py``'s fields; MFU is
``core/mfu``'s (model FLOPs over the card's peak, remat's recompute not
counted). There is no baseline to compare with: ``bench_baseline.json``
holds TPU numbers. Without a GPU it fails, unless ``--device cpu`` asks for
the rehearsal, whose card fields are null.

``--mesh`` (``dp=2,tp=2``; its size is the world's) trains on that mesh,
one rank a card (``cuda:LOCAL_RANK``; gloo ranks with ``--device cpu``),
at ``bench.py``'s global batch for as many chips (256 a chip, 32
microbatches); each rank takes its batch coordinate's rows. Rank 0 prints
the record, per chip, with ``n_chips`` and ``mesh`` set.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import torch

GLOBAL_BATCH, GRAD_ACCUM = 256, 32
WARMUP, TIMED = 2, 3
LR, WEIGHT_DECAY = 2e-4, 0.01


def measure(device: str = "cuda", size: str = "345m", mesh: str = "") -> dict:
    """Trains the configuration above (on ``mesh`` when given, after
    ``core.mesh.init_distributed``) and returns ``bench.py``'s record."""
    from easydl_tpu_torch.core.mesh import MeshSpec
    from easydl_tpu_torch.core.mfu import peak_flops_per_chip
    from easydl_tpu_torch.core.train_loop import TrainConfig, Trainer
    from easydl_tpu_torch.models.registry import get_model
    from easydl_tpu_torch.scripts import gpt345m
    from easydl_tpu_torch.utils.device import require_device

    dev = require_device(device)
    seq, vocab = (gpt345m.SEQ, gpt345m.VOCAB) if size == "345m" else (32, 256)
    spec = MeshSpec.parse(mesh) if mesh else None
    chips = spec.size if spec else 1
    global_batch = GLOBAL_BATCH * chips
    bundle = get_model("gpt", size=size, seq_len=seq, vocab=vocab, dtype="bfloat16",
                       fused_loss=False, **gpt345m.BENCH)
    trainer = Trainer(init_fn=bundle.init_fn, loss_fn=bundle.loss_fn,
                      optimizer=functools.partial(torch.optim.AdamW, lr=LR,
                                                  weight_decay=WEIGHT_DECAY),
                      config=TrainConfig(global_batch=global_batch, grad_accum=GRAD_ACCUM),
                      device=dev, jax_layout=bundle.jax_layout, mesh_spec=spec,
                      param_axes=bundle.param_axes)
    state = trainer.init_state()
    data = iter(bundle.make_data(global_batch, seed=0))
    if spec is not None:  # this rank's rows of each global batch
        share = global_batch // trainer.ranks
        rows = slice(trainer.rank * share, (trainer.rank + 1) * share)
        data = ({k: v[rows] for k, v in batch.items()} for batch in data)
    for _ in range(WARMUP):
        state, metrics = trainer.train_step(state, next(data))
    float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(TIMED):
        state, metrics = trainer.train_step(state, next(data))
    float(metrics["loss"])  # the last loss depends on every timed step
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    samples_per_sec = TIMED * global_batch / dt / chips
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
    peak = peak_flops_per_chip(kind) if kind else None
    record = {
        "metric": f"gpt-{size} seq{seq} samples/sec/chip ({dev.type}, {chips} chip)",
        "value": round(samples_per_sec, 3),
        "unit": "samples/sec/chip",
        "tokens_per_sec": round(samples_per_sec * seq, 1),
        "step_time_s": round(dt / TIMED, 4),
        "mfu": round(samples_per_sec * bundle.flops_per_sample_hint / peak, 8) if peak else None,
        "peak_tflops_per_chip": round(peak / 1e12, 1) if peak else None,
        "device_kind": kind,
        "loss": float(metrics["loss"]),
    }
    if spec is not None:
        record.update(n_chips=chips, mesh=spec.key())
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; fails without a GPU) or cpu (a rehearsal)")
    ap.add_argument("--size", default="345m", help="gpt size; 'test' to rehearse")
    ap.add_argument("--mesh", default="",
                    help="a mesh such as dp=2,tp=2, one rank a card: launch under "
                         "python -m torch.distributed.run with as many processes")
    args = ap.parse_args(argv)
    if args.device == "cuda" and args.size != "345m":
        ap.error("on the card the benchmark is GPT-2 345M")
    from easydl_tpu_torch.utils.device import require_device

    try:
        require_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    if not args.mesh:
        print(json.dumps(measure(args.device, args.size)), flush=True)
        return
    import torch.distributed as dist

    from easydl_tpu_torch.core.mesh import init_distributed

    dev = init_distributed(args.device)
    try:
        record = measure(dev, args.size, args.mesh)
        if dist.get_rank() == 0:
            print(json.dumps(record), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
