"""Chunked softmax cross-entropy from the final hidden states.

Counterpart of ``easydl_tpu/ops/fused_xent.py``. The logits path builds the
whole ``[B, S, V]`` logits tensor and its f32 upcast (GPT-2 345M at
microbatch 8, seq 1024: 8·1024·50304·4 B ≈ 1.65 GB each). Here the tied-head
product, the log-sum-exp and the target pick run one sequence chunk at a
time, and each chunk runs under ``torch.utils.checkpoint``, so

- the forward holds one ``[B, chunk, V]`` f32 buffer at a time;
- the backward recomputes each chunk's logits from the hidden states and the
  head instead of keeping them (the counterpart of ``jax.checkpoint(body)``
  inside the JAX ``lax.scan``).

The product: JAX asks for ``preferred_element_type=float32``, so its logits
are f32 sums of the (bf16) products, never rounded to bf16. ``torch.matmul``
on bf16 operands returns bf16. Both operands are upcast to f32 instead: a
product of two bf16 values is exact in f32, so the sums are the same f32
sums, computed as an f32 product (on the GPU, an f32 GEMM, not a tensor-core
bf16 one). The backward of the upcast matches JAX's transpose rule as well:
an f32 product, then rounded to the operand's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_loss(hidden: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                ignore_id: int) -> torch.Tensor:
    """Sum over the chunk of lse(logits) − logits[target], masked."""
    logits = torch.matmul(hidden.float(), head.float().t())  # [B, C, V] f32
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.clamp_min(0).long()[..., None])[..., 0]
    mask = (targets != ignore_id).float()
    return ((lse - tgt) * mask).sum()


def fused_softmax_xent(
    hidden: torch.Tensor,
    head: torch.Tensor,
    targets: torch.Tensor,
    *,
    ignore_id: int = -1,
    chunk_size: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token cross-entropy from final hidden states.

    Args:
      hidden: ``[B, S, D]`` post-LayerNorm hidden states, any float dtype.
      head: ``[V, D]`` head in embedding layout (the tied ``tok_emb.weight``).
      targets: ``[B, S]`` int token ids; positions equal to ``ignore_id``
        count in neither the loss nor the denominator.
      chunk_size: sequence positions per chunk; the peak is ``B·chunk·V`` f32.

    Returns:
      ``(loss, denom)``: the f32 mean over unmasked positions and their f32
      count (at least 1), as ``models.gpt.lm_loss`` returns them.
    """
    if hidden.dim() != 3:
        raise ValueError(f"hidden must be [B,S,D], got {tuple(hidden.shape)}")
    if head.dim() != 2 or head.shape[1] != hidden.shape[2]:
        raise ValueError(f"head must be [V,D] with D={hidden.shape[2]}, "
                         f"got {tuple(head.shape)}")
    seq = hidden.shape[1]
    chunk_size = min(chunk_size, seq)
    pad = (-seq) % chunk_size
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=ignore_id)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, hidden.shape[1], chunk_size):
        h = hidden[:, start:start + chunk_size]
        t = targets[:, start:start + chunk_size]
        total = total + checkpoint(_chunk_loss, h, head, t, ignore_id, use_reentrant=False)
    denom = (targets != ignore_id).float().sum().clamp_min(1.0)
    return total / denom, denom
