"""How closely the chunked loss keeps the f32 sums of its head product, and
what that product costs, on GPT-2 345M on one CUDA GPU.

    python -m easydl_tpu_torch.scripts.fused_xent_precision

1. Precision. On one microbatch of ``gpt345m``'s set-up (8 sequences of
   1024, random weights from seed 1):
   - the chunked loss (``fused_loss``, as the port runs it),
   - the chunked loss with its head product taken in bf16, so that the f32
     sums are rounded to bf16 (a planted fault),
   - the logits path (``F.linear`` in bf16 rounds the same sums),
   each against the head product in f32 over the full logits: the relative
   loss difference, the relative L2 of the gradients with respect to the
   hidden states and the head (``gpt345m.head_loss_grads``), and the
   largest relative L2 of a parameter's gradient through the whole model
   (``gpt345m.f32_head_loss``; key biases apart as in ``chip_smoke.py``).
   Phase 6b of ``chip_smoke.py`` bounds the first reading; its bounds on
   the loss and the hidden states' gradient lie between the first and the
   second.
2. The product. One chunk's ``[8, 128, 1024] x [1024, 50304]`` head product,
   device time by CUDA events: as the port takes it (both operands upcast,
   an f32 GEMM with TF32 off), the same with TF32 allowed (bf16 values are
   exact in TF32), bf16 (its output rounded), and ``torch.mm(...,
   out_dtype=torch.float32)`` where the installed torch has it; beside each,
   its largest difference from the port's product.

Prints each reading and the card.
"""

from __future__ import annotations

import statistics
import subprocess
from unittest import mock

import torch

from easydl_tpu_torch.ops import fused_xent
from easydl_tpu_torch.scripts import gpt345m

CHUNK = 128


def bf16_product_chunk_loss(hidden, head, targets, ignore_id):
    """``fused_xent._chunk_loss`` with the head product in the operands'
    dtype: the logits are the f32 sums rounded to bf16."""
    logits = torch.matmul(hidden, head.t()).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.clamp_min(0).long()[..., None])[..., 0]
    mask = (targets != ignore_id).float()
    return ((lse - tgt) * mask).sum()


def loss_and_grads(model, batch, loss_fn):
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, batch)[0]
    loss.backward()
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def against(got, want):
    """(relative loss difference, largest relative L2 of a gradient, its
    parameter), key biases left out."""
    (loss, grads), (ref_loss, ref_grads) = got, want
    rel = {n: ((grads[n] - g).norm() / g.norm()).item() for n, g in ref_grads.items()
           if not n.endswith(".k.bias")}
    worst = max(rel, key=rel.get)
    return abs(loss - ref_loss) / abs(ref_loss), rel[worst], worst


def precision() -> None:
    model = gpt345m.bundle().init_fn(1, "cuda")
    host = next(iter(gpt345m.bundle().make_data(gpt345m.GLOBAL_BATCH, seed=0)))
    micro = gpt345m.GLOBAL_BATCH // gpt345m.MICROBATCHES
    batch = {k: torch.as_tensor(v[:micro]).cuda() for k, v in host.items()}
    ref = loss_and_grads(model, batch, gpt345m.f32_head_loss)
    head_ref = gpt345m.head_loss_grads(model, batch, gpt345m.HEAD_LOSSES["f32 head"])[1]
    print(f"f32-head reference loss {ref[0]!r}")
    fused = gpt345m.bundle(fused_loss=True).loss_fn
    cases = (("fused (the port)", fused, "fused", fused_xent._chunk_loss),
             ("fused, bf16 product (planted)", fused, "fused", bf16_product_chunk_loss),
             ("logits path", gpt345m.logits_loss, "logits", fused_xent._chunk_loss))
    for name, model_loss, head_loss, chunk_loss in cases:
        with mock.patch.object(fused_xent, "_chunk_loss", chunk_loss):
            got = loss_and_grads(model, batch, model_loss)
            head = gpt345m.head_loss_grads(model, batch, gpt345m.HEAD_LOSSES[head_loss])[1]
        loss_rel, grad_rel, worst = against(got, ref)
        head_rel = {k: ((head[k] - g).norm() / g.norm()).item() for k, g in head_ref.items()}
        print(f"{name}: loss {got[0]!r}, relative {loss_rel:.3g}; gradients: hidden "
              f"{head_rel['hidden']:.3g}, head {head_rel['head']:.3g} relative L2; through "
              f"the model, largest relative L2 {grad_rel:.3g} ({worst})")


def device_ms(fn, calls: int = 5, windows: int = 7) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def product() -> None:
    micro = gpt345m.GLOBAL_BATCH // gpt345m.MICROBATCHES
    gen = torch.Generator(device="cuda").manual_seed(0)
    hidden = torch.randn(micro, CHUNK, 1024, device="cuda", generator=gen).bfloat16()
    head = (torch.randn(gpt345m.VOCAB, 1024, device="cuda", generator=gen) * 0.02).bfloat16()
    variants = {
        "f32 upcast, TF32 off (the port)": lambda: torch.matmul(hidden.float(),
                                                                head.float().t()),
        "f32 upcast, TF32 on": lambda: torch.matmul(hidden.float(), head.float().t()),
        "bf16 (rounded)": lambda: torch.matmul(hidden, head.t()).float(),
        "bf16, torch.mm out_dtype=float32": lambda: torch.mm(
            hidden.view(-1, hidden.shape[-1]), head.t(),
            out_dtype=torch.float32).view(micro, CHUNK, -1),
    }
    flops = 2 * micro * CHUNK * 1024 * gpt345m.VOCAB
    want = None
    for name, fn in variants.items():
        torch.backends.cuda.matmul.allow_tf32 = "TF32 on" in name
        try:
            got = fn()
        except (TypeError, RuntimeError) as e:
            print(f"product {name}: not available on torch {torch.__version__}: "
                  f"{type(e).__name__}: {str(e).splitlines()[0]}")
            continue
        want = got if want is None else want
        ms = device_ms(fn)
        print(f"product {name}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), dtype "
              f"{got.dtype}, largest |difference| from the port's "
              f"{(got - want).abs().max().item():.3g}")
    torch.backends.cuda.matmul.allow_tf32 = False


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fused_xent_precision: no CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    precision()
    product()


if __name__ == "__main__":
    main()
