"""Multi-head attention with swappable implementations.

Counterpart of ``easydl_tpu/ops/attention.py``. ``impl="auto"`` takes the
flash kernels for CUDA tensors and the reference path for CPU tensors;
models call :func:`multihead_attention` and never care which runs.

Shapes follow the [batch, seq, heads, head_dim] convention throughout.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = torch.finfo(torch.float32).min


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    scale: float,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """einsum → mask → softmax → einsum, with an f32 softmax whatever the
    input dtype.

    The causal mask is bottom-right aligned (``tril(k=s_k-s_q)``), which
    ``F.scaled_dot_product_attention(is_causal=True)`` is not; rows with no
    visible key output zero, as the flash kernels define them."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    fully_masked = None
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril(s_k - s_q)
        logits = logits.masked_fill(~mask, NEG_INF)
        fully_masked = ~mask.any(dim=-1)  # [s_q]
    if segment_ids is not None:
        seg_mask = segment_ids[:, :, None] == segment_ids[:, None, :]  # [b, q, k]
        logits = logits.masked_fill(~seg_mask[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    if fully_masked is not None:
        out = out.masked_fill(fully_masked[None, :, None, None], 0.0)
    return out


def multihead_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    impl: str = "auto",
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over [batch, seq, heads, head_dim] tensors.

    Args:
      impl: "auto" | "flash" (the CUDA kernels; their plain versions on a
        CPU tensor) | "reference" (einsum).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "auto":
        impl = "flash" if q.is_cuda else "reference"
    if impl == "flash":
        from easydl_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, scale=scale,
                               segment_ids=segment_ids)
    if impl != "reference":
        raise ValueError(f"impl must be 'auto', 'flash' or 'reference', got {impl!r}")
    return reference_attention(q, k, v, causal=causal, scale=scale,
                               segment_ids=segment_ids)
