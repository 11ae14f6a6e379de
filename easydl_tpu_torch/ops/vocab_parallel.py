"""Softmax cross-entropy and argmax over logits split on the vocab.

With ``tp`` the tied head is a column-parallel product: each rank of the
``tp`` group holds the logits of its slice of the vocab, ``[..., V/tp]``,
and the model hands them back as a ``DTensor`` sharded on the last
dimension (``models/transformer.py``). The JAX package keeps such logits
sharded too, and GSPMD reduces over the shards. Here the reductions are
explicit, in :func:`cross_entropy` and :func:`argmax`, which take either
such a ``DTensor`` or a plain tensor (then they are ``F.cross_entropy`` and
``Tensor.argmax``, unchanged):

- the loss of a position is ``lse − logit[target]``: the max over the vocab
  (all-reduce MAX), the sum of exponentials below it (all-reduce SUM), and
  the target's logit from the rank that holds it (all-reduce SUM). The
  backward is local: ``softmax − onehot`` on the rank's slice;
- the argmax is the largest value over the ranks (all-reduce MAX) and,
  among the ranks that hold it, the lowest global index (all-reduce MIN):
  ``jnp.argmax`` breaks ties so.

``torch.distributed.tensor.parallel.loss_parallel`` covers
``F.cross_entropy`` only, not the argmax that BERT's accuracy takes nor the
log-sum-exp of the chunked loss (``ops/fused_xent.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard


def vocab_shard(t: torch.Tensor, dim: int) -> Tuple[torch.Tensor, Optional[dist.ProcessGroup],
                                                     int]:
    """``(local block, tp group, first vocab index of the block)`` of ``t``
    split on ``dim`` over a ``tp`` group; ``(t, None, 0)`` for a tensor
    that is whole."""
    if not isinstance(t, DTensor):
        return t, None, 0
    mesh, dim = t.device_mesh, dim % t.dim()
    split = [m for m, pl in enumerate(t.placements)
             if isinstance(pl, Shard) and pl.dim == dim and mesh.size(m) > 1]
    if not split:
        return t.to_local(), None, 0
    if len(split) > 1 or mesh.mesh_dim_names[split[0]] != "tp":
        raise ValueError(f"vocab split over {[mesh.mesh_dim_names[m] for m in split]}, "
                         "not over tp alone")
    local = t.to_local()
    return local, mesh.get_group(split[0]), mesh.get_local_rank(split[0]) * local.shape[dim]


def _in_slice(targets: torch.Tensor, start: int, size: int):
    """(the targets as indices into the slice, clamped; whether each lies in it)"""
    local = targets.long() - start
    inside = (local >= 0) & (local < size)
    return local.clamp(0, size - 1), inside


class _VocabParallelXent(torch.autograd.Function):
    """``lse − logit[target]`` of each position over the ``tp`` group's
    slices of the f32 logits."""

    @staticmethod
    def forward(ctx, logits, targets, group, start):
        index, inside = _in_slice(targets, start, logits.shape[-1])
        top = logits.amax(-1)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        shifted = logits - top[..., None]
        exp = shifted.exp()
        total = exp.sum(-1)
        dist.all_reduce(total, group=group)
        picked = torch.where(inside, shifted.gather(-1, index[..., None])[..., 0], 0.0)
        dist.all_reduce(picked, group=group)
        exp.div_(total[..., None])  # the softmax on this rank's slice
        ctx.save_for_backward(exp, index, inside)
        return total.log() - picked

    @staticmethod
    def backward(ctx, grad):
        softmax, index, inside = ctx.saved_tensors
        out = softmax * grad[..., None]
        out.scatter_add_(-1, index[..., None], torch.where(inside, -grad, 0.0)[..., None])
        return out, None, None, None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position ``-log softmax(logits)[target]`` in f32, ``[...]`` for
    logits ``[..., V]`` (whole, or a ``DTensor`` split on the vocab over
    ``tp``) and int targets ``[...]`` in ``[0, V)``."""
    local, group, start = vocab_shard(logits, -1)
    local = local.float()
    if group is None:
        return F.cross_entropy(local.reshape(-1, local.shape[-1]), targets.reshape(-1).long(),
                               reduction="none").view(targets.shape)
    return _VocabParallelXent.apply(local, targets, group, start)


def shard_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                        group: Optional[dist.ProcessGroup], start: int) -> torch.Tensor:
    """:func:`cross_entropy` of f32 logits that are this rank's slice of the
    vocab from ``start`` on, over ``group`` (None: the whole vocab, as
    ``lse − logit[target]``)."""
    if group is None:
        tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
        return torch.logsumexp(logits, dim=-1) - tgt
    return _VocabParallelXent.apply(logits, targets, group, start)


@torch.no_grad()
def argmax(logits: torch.Tensor) -> torch.Tensor:
    """The index of the largest logit of each position over the whole vocab,
    the lowest one on a tie (``jnp.argmax``'s rule), for logits whole or
    split on the vocab over ``tp``."""
    local, group, start = vocab_shard(logits, -1)
    if group is None:
        return local.argmax(-1)
    top, index = local.max(-1)
    best = top.clone()
    dist.all_reduce(best, op=dist.ReduceOp.MAX, group=group)
    first = torch.where(top == best, index + start, torch.iinfo(torch.int64).max)
    dist.all_reduce(first, op=dist.ReduceOp.MIN, group=group)
    return first
