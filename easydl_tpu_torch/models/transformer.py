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
- init: normal(0.02) for kernels and the token embedding, residual
  projections (``out``, ``down``) × (2·n_layers)^-0.5, ``pos_emb``
  normal(0.01), zero biases, unit LayerNorm scales.

Blocks are an ``nn.ModuleList``; the JAX package stacks them on a leading
``[n_layers]`` axis (``nn.scan``), and ``easydl_tpu_torch/convert.py`` maps
between the two layouts. Attention goes through
:func:`easydl_tpu_torch.ops.multihead_attention`, which takes the flash
kernels for CUDA tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from easydl_tpu_torch.ops import multihead_attention

LN_EPS = 1e-6


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 50304            # GPT-2 vocab padded to a multiple of 128
    d_model: int = 1024
    n_heads: int = 16
    n_layers: int = 24
    d_ff: int = 4096
    max_seq: int = 1024
    causal: bool = True
    #: recompute each block in the backward (torch.utils.checkpoint); only
    #: the "full" policy is ported
    remat: bool = False
    remat_policy: str = "full"
    attention_impl: str = "auto"
    #: compute/activation dtype ("float32" | "bfloat16"); params stay f32
    dtype: str = "float32"

    def __post_init__(self) -> None:
        if self.remat and self.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy={self.remat_policy!r} is not ported yet (only 'full')")

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


def _dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax DenseGeneral with ``dtype=``: input, kernel and bias in ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


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
        cfg = self.cfg
        dt = cfg.torch_dtype
        b, s, _ = x.shape
        heads = (b, s, cfg.n_heads, cfg.head_dim)
        h = self.ln_attn(x)
        q = _dense(h, self.q, dt).view(heads)
        k = _dense(h, self.k, dt).view(heads)
        v = _dense(h, self.v, dt).view(heads)
        attn = multihead_attention(q, k, v, causal=cfg.causal, impl=cfg.attention_impl)
        x = x + _dense(attn.reshape(b, s, cfg.d_model), self.out, dt)
        h = self.ln_mlp(x)
        h = F.gelu(_dense(h, self.up, dt), approximate="tanh")
        return x + _dense(h, self.down, dt)


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

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.torch_dtype
        emb = self.tok_emb.weight.to(dt)
        seq = tokens.shape[1]
        x = F.embedding(tokens, emb) + self.pos_emb.to(dt)[None, :seq]
        for blk in self.blocks:
            if cfg.remat:
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
        x = self.ln_f(x)
        return F.linear(x, emb)
