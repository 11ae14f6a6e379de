"""The port's GPT weights in the JAX package's layout.

Weights: the input of :func:`params_from_jax` is the UNBOXED flax parameter
tree of ``easydl_tpu/models/transformer.py`` as numpy arrays (unbox it with
``flax.linen.meta.unbox`` on the JAX side). Its layout:

- ``blocks/*`` stacked on a leading ``[n_layers]`` axis (``nn.scan``);
- ``q/k/v.kernel [L, D, H, hd]``, ``q/k/v.bias [L, H, hd]``;
- ``out.kernel [L, H, hd, D]``, ``out.bias [L, D]``;
- ``up.kernel [L, D, F]``, ``down.kernel [L, F, D]`` and their biases;
- ``ln_*.{scale, bias} [L, D]``;
- ``tok_emb.embedding [V, D]``, ``pos_emb [max_seq, D]``, ``ln_f.{scale, bias}``.

Torch's ``nn.Linear`` keeps ``weight [out, in]``, so kernels are flattened
over the head axes and transposed. Both directions only reshape and
transpose: a round trip is bit-exact. :func:`to_jax_tree` and
:func:`from_jax_tree` are the GPT bundle's ``JaxLayout``, which checkpoints
use to lay out the weights and the Adam moments.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_PROJ = ("q", "k", "v")
_NORMS = ("ln_attn", "ln_mlp")


def to_jax_tree(sd: Mapping[str, torch.Tensor], n_heads: int) -> Dict[str, Any]:
    """``state_dict``-keyed tensors -> the flax tree's layout, as torch
    tensors on the input's device (any device, ``meta`` included)."""
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))

    def stack(suffix):
        return torch.stack([sd[f"blocks.{i}.{suffix}"] for i in range(n_layers)])

    blocks: Dict[str, Dict[str, torch.Tensor]] = {}
    for name in _PROJ:
        w = stack(name + ".weight")  # [L, H*hd, D]
        blocks[name] = {
            "kernel": w.transpose(1, 2).reshape(n_layers, w.shape[2], n_heads, -1).contiguous(),
            "bias": stack(name + ".bias").reshape(n_layers, n_heads, -1),
        }
    w = stack("out.weight")  # [L, D, H*hd]
    blocks["out"] = {
        "kernel": w.transpose(1, 2).reshape(n_layers, n_heads, -1, w.shape[1]).contiguous(),
        "bias": stack("out.bias"),
    }
    for name in ("up", "down"):
        blocks[name] = {"kernel": stack(name + ".weight").transpose(1, 2).contiguous(),
                        "bias": stack(name + ".bias")}
    for name in _NORMS:
        blocks[name] = {"scale": stack(name + ".weight"), "bias": stack(name + ".bias")}
    return {
        "blocks": blocks,
        "tok_emb": {"embedding": sd["tok_emb.weight"]},
        "pos_emb": sd["pos_emb"],
        "ln_f": {"scale": sd["ln_f.weight"], "bias": sd["ln_f.bias"]},
    }


def from_jax_tree(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`to_jax_tree`, on torch tensors."""
    blocks = tree["blocks"]
    sd = {
        "tok_emb.weight": tree["tok_emb"]["embedding"],
        "pos_emb": tree["pos_emb"],
        "ln_f.weight": tree["ln_f"]["scale"],
        "ln_f.bias": tree["ln_f"]["bias"],
    }
    for i in range(blocks["q"]["kernel"].shape[0]):
        pre = f"blocks.{i}."
        for name in _PROJ:
            kernel = blocks[name]["kernel"][i]  # [D, H, hd]
            sd[pre + name + ".weight"] = kernel.reshape(kernel.shape[0], -1).t()
            sd[pre + name + ".bias"] = blocks[name]["bias"][i].reshape(-1)
        out = blocks["out"]["kernel"][i]  # [H, hd, D]
        sd[pre + "out.weight"] = out.reshape(-1, out.shape[-1]).t()
        for name in ("up", "down"):
            sd[pre + name + ".weight"] = blocks[name]["kernel"][i].t()
        for name in ("out", "up", "down"):
            sd[pre + name + ".bias"] = blocks[name]["bias"][i]
        for name in _NORMS:
            sd[pre + name + ".weight"] = blocks[name]["scale"][i]
            sd[pre + name + ".bias"] = blocks[name]["bias"][i]
    return {k: v.contiguous() for k, v in sd.items()}


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, Mapping) else fn(tree)


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Unboxed flax GPT params (numpy) -> ``Transformer.state_dict()``."""
    return from_jax_tree(_map(lambda x: torch.from_numpy(np.array(x)), tree))


def params_to_jax(state_dict: Dict[str, torch.Tensor], n_heads: int) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax`: a flax-layout tree of numpy arrays."""
    tree = to_jax_tree({k: v.detach() for k, v in state_dict.items()}, n_heads)
    return _map(lambda t: t.cpu().numpy(), tree)
