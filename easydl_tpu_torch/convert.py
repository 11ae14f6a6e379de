"""Weights between the JAX package's flax tree and the port's ``state_dict``.

The input of :func:`params_from_jax` is the UNBOXED flax parameter tree of
``easydl_tpu/models/transformer.py`` as numpy arrays (unbox it with
``flax.linen.meta.unbox`` on the JAX side). Its layout:

- ``blocks/*`` stacked on a leading ``[n_layers]`` axis (``nn.scan``);
- ``q/k/v.kernel [L, D, H, hd]``, ``q/k/v.bias [L, H, hd]``;
- ``out.kernel [L, H, hd, D]``, ``out.bias [L, D]``;
- ``up.kernel [L, D, F]``, ``down.kernel [L, F, D]`` and their biases;
- ``ln_*.{scale, bias} [L, D]``;
- ``tok_emb.embedding [V, D]``, ``pos_emb [max_seq, D]``, ``ln_f.{scale, bias}``.

Torch's ``nn.Linear`` keeps ``weight [out, in]``, so kernels are flattened
over the head axes and transposed. Both directions only reshape and
transpose: a round trip is bit-exact.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_PROJ = ("q", "k", "v")
_DENSE = ("out", "up", "down")
_NORMS = ("ln_attn", "ln_mlp")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable, contiguous copy


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Unboxed flax GPT params (numpy) -> ``Transformer.state_dict()``."""
    blocks = tree["blocks"]
    sd = {
        "tok_emb.weight": _t(tree["tok_emb"]["embedding"]),
        "pos_emb": _t(tree["pos_emb"]),
        "ln_f.weight": _t(tree["ln_f"]["scale"]),
        "ln_f.bias": _t(tree["ln_f"]["bias"]),
    }
    n_layers = np.asarray(blocks["q"]["kernel"]).shape[0]
    for i in range(n_layers):
        pre = f"blocks.{i}."
        for name in _PROJ:
            kernel = np.asarray(blocks[name]["kernel"][i])  # [D, H, hd]
            sd[pre + name + ".weight"] = _t(kernel.reshape(kernel.shape[0], -1).T)
            sd[pre + name + ".bias"] = _t(np.asarray(blocks[name]["bias"][i]).reshape(-1))
        out = np.asarray(blocks["out"]["kernel"][i])  # [H, hd, D]
        sd[pre + "out.weight"] = _t(out.reshape(-1, out.shape[-1]).T)
        for name in _DENSE:
            if name != "out":
                sd[pre + name + ".weight"] = _t(np.asarray(blocks[name]["kernel"][i]).T)
            sd[pre + name + ".bias"] = _t(blocks[name]["bias"][i])
        for name in _NORMS:
            sd[pre + name + ".weight"] = _t(blocks[name]["scale"][i])
            sd[pre + name + ".bias"] = _t(blocks[name]["bias"][i])
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor], n_heads: int) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax`: a flax-layout tree of numpy arrays."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))

    def stack(suffix):
        return np.stack([sd[f"blocks.{i}.{suffix}"] for i in range(n_layers)])

    blocks: Dict[str, Dict[str, np.ndarray]] = {}
    for name in _PROJ:
        w = stack(name + ".weight")  # [L, H*hd, D]
        d = w.shape[-1]
        blocks[name] = {
            "kernel": np.ascontiguousarray(w.transpose(0, 2, 1)).reshape(n_layers, d, n_heads, -1),
            "bias": stack(name + ".bias").reshape(n_layers, n_heads, -1),
        }
    w = stack("out.weight")  # [L, D, H*hd]
    blocks["out"] = {
        "kernel": np.ascontiguousarray(w.transpose(0, 2, 1)).reshape(n_layers, n_heads, -1, w.shape[1]),
        "bias": stack("out.bias"),
    }
    for name in ("up", "down"):
        blocks[name] = {
            "kernel": np.ascontiguousarray(stack(name + ".weight").transpose(0, 2, 1)),
            "bias": stack(name + ".bias"),
        }
    for name in _NORMS:
        blocks[name] = {"scale": stack(name + ".weight"), "bias": stack(name + ".bias")}
    return {
        "blocks": blocks,
        "tok_emb": {"embedding": sd["tok_emb.weight"]},
        "pos_emb": sd["pos_emb"],
        "ln_f": {"scale": sd["ln_f.weight"], "bias": sd["ln_f.bias"]},
    }
