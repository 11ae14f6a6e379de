"""Shared transformer stack (pre-LN decoder), in PyTorch.

Counterpart of ``easydl_tpu/models/transformer.py``, matching flax's
numerics rather than torch's defaults:

- LayerNorm eps is 1e-6, statistics in f32 as ``E[x²] − E[x]²`` (flax's
  fast variance), output cast to the compute dtype;
- GELU is the tanh approximation (``flax.linen.gelu``);
- every layer computes in ``cfg.dtype``: inputs and parameters are cast to it
  first, as flax's ``dtype=`` does, so an f32 model run on bf16-rounded
  parameters computes in f32 on those rounded values;
- the LM head is tied: ``x @ tok_emb.T`` in the compute dtype;
  ``forward(tokens, return_hidden=True)`` returns the post-``ln_f`` hidden
  states instead, the input of the chunked loss (``ops/fused_xent.py``);
- ``remat=True`` recomputes each block in the backward
  (``torch.utils.checkpoint``): ``remat_policy="full"`` keeps only the
  block's input, ``"dots"`` also keeps the outputs of its matrix products
  (:data:`SAVED_PRODUCTS`) and recomputes the rest, the counterpart of
  ``jax.checkpoint_policies.dots_saveable``. The flash forward is not a
  product, so it runs again in the backward, as the JAX package's
  ``pallas_call`` does. A block that FSDP2 shards (``core/train_loop.py``
  with a mesh) checkpoints inside its own forward, within FSDP2's hooks;
  any other block is checkpointed by the stack, its parameters passed in;
- init: normal(0.02) for kernels and the token embedding, residual
  projections (``out``, ``down``) × (2·n_layers)^-0.5, ``pos_emb``
  normal(0.01), zero biases, unit LayerNorm scales;
- tensor parallelism (``tp``, Megatron's layout): when the trainer has split
  a weight over a ``tp`` group (a ``DTensor`` with a ``Shard`` on the mesh
  dimension ``tp``, ``core/sharding.py``), the layers compute on the
  rank's block (``to_local()``, whose backward hands the gradient back
  with the same placement) and place the collectives themselves
  (``core/mesh.py``): q, k, v and ``up`` are column-parallel, their input
  through ``copy_to_tp``; ``out`` and ``down`` row-parallel, their product
  through ``reduce_from_tp`` before the bias, which every rank holds whole.
  A block launches two all-reduces forward and two backward (and the
  recompute of ``remat`` reruns the forward's two). Attention runs on the
  rank's heads, ``n_heads / tp`` of them. The token embedding and the tied
  head are vocab-parallel: the lookup takes the ids of the rank's slice of
  the vocab (zeros elsewhere) and sums over ``tp``; the head gives the
  logits of that slice, returned as a ``DTensor`` split on the vocab, which
  ``ops/vocab_parallel.py`` reduces over.

Blocks are an ``nn.ModuleList``; the JAX package stacks them on a leading
``[n_layers]`` axis (``nn.scan``), and ``easydl_tpu_torch/convert.py`` maps
between the two layouts. Attention goes through
:func:`easydl_tpu_torch.ops.multihead_attention`, which takes the flash
kernels for CUDA tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.fsdp import FSDPModule
from torch.distributed.tensor import DTensor, Shard
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from easydl_tpu_torch.core.mesh import copy_to_tp, reduce_from_tp
from easydl_tpu_torch.core.sharding import tp_group_of
from easydl_tpu_torch.ops import multihead_attention

LN_EPS = 1e-6
REMAT_POLICIES = ("full", "dots")
#: the ops whose outputs ``remat_policy="dots"`` keeps: matrix products.
#: ``F.linear`` reaches ``addmm`` (through a 2-D view of a 3-D input), the
#: reference attention's einsums ``bmm``. Nothing else is kept: a buffer that
#: a flash kernel writes through ctypes comes from ``empty_like``, which is
#: recomputed, so the recomputed forward launches the kernel into a fresh one.
SAVED_PRODUCTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default})


def _save_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_kwargs(cfg: "TransformerConfig") -> dict:
    kwargs = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        kwargs["context_fn"] = partial(create_selective_checkpoint_contexts, _save_products)
    return kwargs


def _block_on(block: nn.Module, names, x: torch.Tensor, *params: torch.Tensor) -> torch.Tensor:
    """``block(x)`` on ``params``. The recompute must see the parameters the
    forward saw: under the trainer's ``functional_call`` those are its
    compute-dtype casts, and by the backward the block holds the f32 masters
    again, so they are passed to the checkpoint as inputs."""
    return functional_call(block, dict(zip(names, params)), (x,))


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 50304            # GPT-2 vocab padded to a multiple of 128
    d_model: int = 1024
    n_heads: int = 16
    n_layers: int = 24
    d_ff: int = 4096
    max_seq: int = 1024
    causal: bool = True
    #: recompute each block in the backward (torch.utils.checkpoint) under
    #: ``remat_policy`` ("full" or "dots")
    remat: bool = False
    remat_policy: str = "full"
    attention_impl: str = "auto"
    #: compute/activation dtype ("float32" | "bfloat16"); params stay f32
    dtype: str = "float32"

    def __post_init__(self) -> None:
        if self.remat and self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be 'full' or 'dots', "
                             f"got {self.remat_policy!r}")

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]

    @property
    def param_count(self) -> int:
        per_block = (
            4 * self.d_model * self.d_model      # qkv + out projections
            + 2 * self.d_model * self.d_ff       # FFN
            + 4 * self.d_model                   # biases-ish + 2 LN
        )
        emb = self.vocab * self.d_model + self.max_seq * self.d_model
        return emb + self.n_layers * per_block


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` numerics: f32 statistics, output in ``dtype``."""

    def __init__(self, d: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (x - mean) * (torch.rsqrt(var + LN_EPS) * self.weight.float())
        return (y + self.bias.float()).to(self.dtype)


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of a parameter split over ``tp``, or the parameter."""
    return t.to_local() if isinstance(t, DTensor) else t


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax DenseGeneral with ``dtype=``: input, kernel and bias in ``dtype``
    (column-parallel under ``tp``: the rank's block of outputs)."""
    return F.linear(x.to(dtype), _local(layer.weight).to(dtype), _local(layer.bias).to(dtype))


def _row_dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype,
               group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """:func:`_dense` of a row-parallel layer: the rank's inputs times its
    block of the kernel, summed over ``group``, then the whole bias."""
    if group is None:
        return _dense(x, layer, dtype)
    part = F.linear(x.to(dtype), _local(layer.weight).to(dtype))
    return reduce_from_tp(part, group) + layer.bias.to(dtype)


class Block(nn.Module):
    """Pre-LN transformer block (attention + MLP)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.torch_dtype
        self.ln_attn = LayerNorm(d, dt)
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)
        self.ln_mlp = LayerNorm(d, dt)
        self.up = nn.Linear(d, cfg.d_ff)
        self.down = nn.Linear(cfg.d_ff, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.remat and isinstance(self, FSDPModule):
            # FSDP2 gathers the block's parameters (in the compute dtype) in
            # its hooks, before the forward and again before the backward,
            # so a recompute inside them runs on what the forward ran on
            return checkpoint(self._forward, x, **_remat_kwargs(self.cfg))
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.torch_dtype
        b, s, _ = x.shape
        group = tp_group_of(self.q.weight)
        heads = (b, s, -1, cfg.head_dim)  # this rank's heads under tp
        h = copy_to_tp(self.ln_attn(x), group)
        q = _dense(h, self.q, dt).view(heads)
        k = _dense(h, self.k, dt).view(heads)
        v = _dense(h, self.v, dt).view(heads)
        attn = multihead_attention(q, k, v, causal=cfg.causal, impl=cfg.attention_impl)
        x = x + _row_dense(attn.reshape(b, s, -1), self.out, dt, group)
        h = copy_to_tp(self.ln_mlp(x), group)
        h = F.gelu(_dense(h, self.up, dt), approximate="tanh")
        return x + _row_dense(h, self.down, dt, group)


class Transformer(nn.Module):
    """Token-in, logits-out decoder stack with a tied head."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab, cfg.d_model)
        self.pos_emb = nn.Parameter(torch.empty(cfg.max_seq, cfg.d_model))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg.torch_dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers, drawn from ``generator`` (the
        numbers differ from JAX's; tests carry weights over instead)."""
        residual = (2 * self.cfg.n_layers) ** -0.5
        self.tok_emb.weight.normal_(0.0, 0.02, generator=generator)
        self.pos_emb.normal_(0.0, 0.01, generator=generator)
        for blk in self.blocks:
            for name in ("q", "k", "v", "out", "up", "down"):
                layer = getattr(blk, name)
                std = 0.02 * (residual if name in ("out", "down") else 1.0)
                layer.weight.normal_(0.0, std, generator=generator)
                layer.bias.zero_()
            for ln in (blk.ln_attn, blk.ln_mlp):
                ln.weight.fill_(1.0)
                ln.bias.zero_()
        self.ln_f.weight.fill_(1.0)
        self.ln_f.bias.zero_()

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False) -> torch.Tensor:
        """Logits ``[B, S, vocab]`` (under ``tp`` a ``DTensor`` split on the
        vocab), or the post-``ln_f`` hidden states ``[B, S, d_model]`` with
        ``return_hidden=True``."""
        cfg = self.cfg
        dt = cfg.torch_dtype
        weight = self.tok_emb.weight
        group = tp_group_of(weight)
        emb = _local(weight).to(dt)
        seq = tokens.shape[1]
        x = _embed(tokens, emb, group) + self.pos_emb.to(dt)[None, :seq]
        for blk in self.blocks:
            if cfg.remat and not isinstance(blk, FSDPModule):
                names, params = zip(*blk.named_parameters())
                x = checkpoint(_block_on, blk, names, x, *params, **_remat_kwargs(cfg))
            else:
                x = blk(x)
        x = self.ln_f(x)
        if return_hidden:
            return x
        if group is None:
            return F.linear(x, emb)
        logits = F.linear(copy_to_tp(x, group), emb)
        return DTensor.from_local(logits, weight.device_mesh,
                                  [Shard(logits.dim() - 1) if isinstance(pl, Shard) else pl
                                   for pl in weight.placements], run_check=False)


def _embed(tokens: torch.Tensor, emb: torch.Tensor,
           group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The rows of ``emb`` for ``tokens``; under ``tp`` ``emb`` is the rank's
    slice of the vocab: the ids outside it look up zeros, and the ranks'
    lookups are summed (one of them holds each id's row)."""
    if group is None:
        return F.embedding(tokens, emb)
    start = dist.get_rank(group) * emb.shape[0]
    local = tokens - start
    inside = (local >= 0) & (local < emb.shape[0])
    rows = F.embedding(local.clamp(0, emb.shape[0] - 1), emb)
    return reduce_from_tp(rows.masked_fill(~inside[..., None], 0), group)
