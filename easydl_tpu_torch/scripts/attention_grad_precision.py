"""How close each attention backward brings GPT-2 345M's gradients to an f32
model's, on one CUDA GPU.

    python -m easydl_tpu_torch.scripts.attention_grad_precision

Trains the bf16 model as ``chip_smoke.py`` does (``gpt345m``'s set-up and
step count), then takes one backward of the next microbatch with the same
weights through:

- an f32 model with reference attention (the yardstick);
- the bf16 model with the flash kernels, with the flash forward kernel and
  the plain backward (Δ = rowsum(dO∘O) from the bf16 O, as the kernels and
  the JAX package take it), with a plain backward whose Δ is Σ P∘dP in f32
  (consistent with the P it recomputes), with the reference einsum, and
  with ``F.scaled_dot_product_attention`` (cuDNN; a yardstick, not part of
  the port).

Prints, per parameter kind, the largest relative L2 error over the 24
blocks against the f32 model and against the bf16 reference, and the card.
"""

from __future__ import annotations

import subprocess
from unittest import mock

import torch
import torch.nn.functional as F

from easydl_tpu_torch.models import transformer
from easydl_tpu_torch.ops import flash_attention as fa
from easydl_tpu_torch.scripts import gpt345m

KINDS = ("q.weight", "q.bias", "k.weight", "v.weight", "out.weight", "up.weight")


def bwd_dq_consistent(q, k, v, o, do, lse, causal, scale):
    """``flash_bwd_dq_plain`` with Δ = Σ_j P∘dP in f32 instead of rowsum(dO∘O)."""
    p, _ = fa._probs_and_dscores(q, k, v, do, lse, torch.zeros_like(lse), causal, scale)
    delta = (p * torch.matmul(do.float(), v.float().transpose(1, 2))).sum(-1)
    _, ds = fa._probs_and_dscores(q, k, v, do, lse, delta, causal, scale)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype), delta


def sdpa(q, k, v, *, causal, impl=None, scale=None):
    out = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in (q, k, v)),
                                         is_causal=causal)
    return out.transpose(1, 2)


def grads(state_dict, batch, dtype: str, impl: str) -> dict:
    model = gpt345m.bundle(dtype, impl).init_fn(1, "cuda")
    model.load_state_dict(state_dict)
    out = gpt345m.grads(model, batch)
    del model
    torch.cuda.empty_cache()
    return out


def worst_by_kind(got: dict, want: dict, n_blocks: int) -> str:
    parts = []
    for kind in KINDS:
        names = [f"blocks.{i}.{kind}" for i in range(n_blocks)]
        worst = max(((got[n] - want[n]).norm() / want[n].norm()).item() for n in names)
        parts.append(f"{kind} {worst:.3g}")
    return ", ".join(parts)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("attention_grad_precision: no CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    bundle = gpt345m.bundle()
    trainer = gpt345m.trainer(bundle)
    state = trainer.init_state()
    data = iter(bundle.make_data(gpt345m.GLOBAL_BATCH, seed=0))
    for _ in range(gpt345m.STEPS):
        state, metrics = trainer.train_step(state, next(data))
    print(f"trained {gpt345m.STEPS} steps, last loss {float(metrics['loss']):.6f}")
    micro = gpt345m.GLOBAL_BATCH // gpt345m.MICROBATCHES
    batch = {k: v[:micro] for k, v in trainer.to_device(next(data)).items()}
    sd = state.model.state_dict()
    n_blocks = len(state.model.blocks)

    truth = grads(sd, batch, "float32", "reference")
    sets = {"flash kernels": grads(sd, batch, "bfloat16", "flash")}
    with mock.patch.multiple(fa, flash_bwd_dq=fa.flash_bwd_dq_plain,
                             flash_bwd_dkv=fa.flash_bwd_dkv_plain):
        sets["flash fwd kernel, plain bwd, Δ from bf16 O"] = grads(sd, batch, "bfloat16", "flash")
    with mock.patch.multiple(fa, flash_bwd_dq=bwd_dq_consistent,
                             flash_bwd_dkv=fa.flash_bwd_dkv_plain):
        sets["flash fwd kernel, plain bwd, Δ = Σ P∘dP in f32"] = grads(sd, batch, "bfloat16",
                                                                      "flash")
    sets["reference einsum"] = grads(sd, batch, "bfloat16", "reference")
    with mock.patch.object(transformer, "multihead_attention", sdpa):
        sets["scaled_dot_product_attention (cuDNN)"] = grads(sd, batch, "bfloat16", "reference")

    print("f32 model's gradient norms, largest over the blocks: " + ", ".join(
        f"{kind} {max(truth[f'blocks.{i}.{kind}'].norm().item() for i in range(n_blocks)):.3g}"
        for kind in KINDS))
    for want_name, want in (("the f32 model", truth), ("the bf16 reference einsum",
                                                       sets["reference einsum"])):
        for name, got in sets.items():
            print(f"bf16 {name} vs {want_name}, relative L2, largest over the blocks: "
                  + worst_by_kind(got, want, n_blocks))
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
