"""The training state under the JAX ``TrainState``'s checkpoint keys.

The JAX ``TrainState`` (step, params, optax Adam/AdamW state, rng) flattens
to the leaf keys that its checkpoint manifest records
(``jax.tree_util.keystr``). :func:`to_leaves` and :func:`load_leaves` map a
model and its ``torch.optim.Adam``/``AdamW`` to those keys:

- ``.step``: the step, int32;
- ``.params[...].value``: the weights in the JAX model's layout (``.value``
  is flax's ``Partitioned`` box);
- ``.opt_state[0].count``: each parameter's Adam ``state["step"]``, int32;
- ``.opt_state[0].mu[...].value`` / ``.nu[...].value``: ``exp_avg`` /
  ``exp_avg_sq``, in the weights' layout;
- ``.rng``: ``jax.random.PRNGKey(seed)``, which is ``[0, seed]`` uint32.

What this module knows of the model is one :class:`JaxLayout`, which the
model's bundle supplies: how its parameters map to the JAX model's parameter
tree. ``optax.adamw`` and ``optax.adam`` both keep their moments at
``opt_state[0]``. Hyperparameters are in no checkpoint, in either package.

A model sharded by FSDP2 holds ``DTensor`` parameters and moments. Then
:func:`to_leaves` and :func:`load_leaves` take this rank's blocks: the
layout maps a parameter's local shard to a block of its JAX leaf,
:func:`leaf_regions` says where that block lies in the leaf, so that each
rank writes and reads only its own chunks, and :func:`written_leaves` which
of its blocks a rank writes (one replica of each block is written).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.placement_types import _StridedShard

from easydl_tpu_torch.core import prng

_ADAM = (torch.optim.Adam, torch.optim.AdamW)
_MOMENTS = ((".opt_state[0].mu", "exp_avg"), (".opt_state[0].nu", "exp_avg_sq"))

Template = Dict[str, Tuple[Tuple[int, ...], np.dtype]]


@dataclass(frozen=True)
class JaxLayout:
    """A model's parameters in the JAX package's parameter tree.

    Attributes:
      to_jax: ``{parameter name: tensor}`` -> the flax tree (nested dicts of
        tensors) in the JAX model's shapes, on the input's device (``meta``
        included). Tensors that are not a parameter's own may be new ones.
      from_jax: the inverse, on torch tensors.
    """

    to_jax: Callable[[Mapping[str, torch.Tensor]], Dict[str, Any]]
    from_jax: Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]]


def _flatten(tree: Mapping[str, Any], prefix: str, out: Dict[str, Any]) -> None:
    """``keystr`` keys of a boxed flax tree: dict keys in sorted order, as
    ``jax.tree_util`` flattens them, each leaf behind ``.value``."""
    for k in sorted(tree):
        if isinstance(tree[k], Mapping):
            _flatten(tree[k], f"{prefix}['{k}']", out)
        else:
            out[f"{prefix}['{k}'].value"] = tree[k]


def _unflatten(leaves: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, leaf in leaves.items():
        if not (key.startswith(prefix + "[") and key.endswith(".value")):
            continue
        path = key[len(prefix) + 2:-len("'].value")].split("']['")
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree


def _check_optimizer(optimizer: torch.optim.Optimizer) -> None:
    if type(optimizer) not in _ADAM or any(g.get("amsgrad") for g in optimizer.param_groups):
        raise NotImplementedError(
            f"checkpoints of optimizer {type(optimizer).__name__} (amsgrad: "
            f"{[g.get('amsgrad') for g in optimizer.param_groups]}) are not ported yet: "
            "torch.optim.Adam or AdamW without amsgrad (optax adam/adamw) only")


def _rng(seed: int) -> np.ndarray:
    return np.array(prng.PRNGKey(seed), np.uint32)


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``t``: the local shard of a ``DTensor``."""
    return t.to_local() if isinstance(t, DTensor) else t


def _like(param: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """``block`` (this rank's part) as a tensor placed like ``param``."""
    if not isinstance(param, DTensor):
        return block
    return DTensor.from_local(block, param.device_mesh, param.placements, run_check=False,
                              shape=param.shape, stride=param.stride())


def _params_by_name(model: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    params = dict(model.named_parameters())
    if set(params) != set(model.state_dict()):
        raise ValueError("the model's state_dict holds more than its parameters")
    return params


def to_leaves(step: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
              seed: int, layout: JaxLayout) -> Dict[str, torch.Tensor]:
    """The JAX ``TrainState``'s leaves by checkpoint key, as torch tensors in
    its layouts and dtypes, on the model's device (for a sharded model, this
    rank's blocks of them: see :func:`leaf_regions`). Leaves may share
    memory with the live state."""
    _check_optimizer(optimizer)
    params = _params_by_name(model)
    state = optimizer.state
    steps = {int(state[p]["step"]) for p in params.values() if p in state}
    if len(steps) > 1 or (steps and len(state) != len(params)):
        raise ValueError(f"parameters are at different optimizer steps: {sorted(steps)}")
    local = {n: _local(p.detach()) for n, p in params.items()}
    device = next(iter(local.values())).device

    out = {".step": torch.tensor(step, dtype=torch.int32, device=device)}
    _flatten(layout.to_jax(local), ".params", out)
    out[".opt_state[0].count"] = torch.tensor(steps.pop() if steps else 0, dtype=torch.int32,
                                              device=device)
    for prefix, key in _MOMENTS:
        moments = {n: _local(state[p][key]).detach() if p in state else torch.zeros_like(local[n])
                   for n, p in params.items()}
        _flatten(layout.to_jax(moments), prefix, out)
    out[".rng"] = torch.from_numpy(_rng(seed)).to(device)
    return out


def leaf_shapes(model: torch.nn.Module, layout: JaxLayout) -> Template:
    """(shape, dtype) of every leaf :func:`to_leaves` gives for ``model``
    with an Adam-family optimizer, without allocating them."""
    meta = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
            for n, p in _params_by_name(model).items()}
    tree = layout.to_jax(meta)
    leaves: Dict[str, Any] = {}
    for prefix in (".params", *(p for p, _ in _MOMENTS)):
        _flatten(tree, prefix, leaves)
    out = {k: (tuple(t.shape), np.dtype(str(t.dtype)[len("torch."):]))
           for k, t in leaves.items()}
    out[".step"] = out[".opt_state[0].count"] = ((), np.dtype(np.int32))
    out[".rng"] = ((2,), np.dtype(np.uint32))
    return out


def load_leaves(leaves: Mapping[str, np.ndarray], model: torch.nn.Module,
                optimizer: torch.optim.Optimizer, seed: int, layout: JaxLayout) -> int:
    """Loads the leaves of :func:`to_leaves` (numpy, as a checkpoint
    restores them; this rank's blocks for a sharded model) into ``model``
    and ``optimizer`` in place; returns the step. The optimizer takes its
    state through its own ``load_state_dict``, so ``state["step"]`` gets the
    dtype and device that the installed torch gives it."""
    _check_optimizer(optimizer)
    if not np.array_equal(np.asarray(leaves[".rng"]), _rng(seed)):
        raise ValueError(f"checkpoint rng {leaves['.rng']} is not PRNGKey({seed}) = "
                         f"{_rng(seed)}: it was saved by a run with another seed")
    params = _params_by_name(model)
    device = _local(next(iter(params.values()))).device

    def load(prefix):  # laid out on the model's device, placed like the parameters
        tree = _unflatten({k: torch.from_numpy(np.array(v)).to(device)
                           for k, v in leaves.items() if k.startswith(prefix + "[")}, prefix)
        return {n: _like(params[n], t) for n, t in layout.from_jax(tree).items()}

    model.load_state_dict(load(".params"))
    mu, nu = (load(prefix) for prefix, _ in _MOMENTS)
    count = float(leaves[".opt_state[0].count"])
    index = {p: i for i, p in enumerate(p for g in optimizer.param_groups for p in g["params"])}
    name_of = {p: n for n, p in params.items()}
    sd = optimizer.state_dict()
    sd["state"] = {index[p]: {"step": torch.tensor(count), "exp_avg": mu[name_of[p]],
                              "exp_avg_sq": nu[name_of[p]]} for p in index}
    optimizer.load_state_dict(sd)
    return int(leaves[".step"])


def splits(param: torch.Tensor) -> Dict[int, List[Tuple[str, int, int]]]:
    """How ``param`` is split: for each tensor dimension it splits, the
    ``(mesh axis, parts, this rank's index)`` of every cut, outer first.
    ``Shard`` placements cut in mesh order; FSDP2's ``_StridedShard`` cuts
    inside the ``Shard`` cuts it strides over (FSDP2 shards the ``tp``
    block). Each cut takes ``torch.chunk``'s sizes, as FSDP2 pads them."""
    if not isinstance(param, DTensor):
        return {}
    mesh = param.device_mesh
    outer: Dict[int, List[Tuple[str, int, int]]] = {}
    inner: Dict[int, List[Tuple[str, int, int, int]]] = {}
    for m, pl in enumerate(param.placements):
        cut = (mesh.mesh_dim_names[m], mesh.size(m), mesh.get_local_rank(m))
        if isinstance(pl, _StridedShard):
            inner.setdefault(pl.dim, []).append((*cut, pl.split_factor))
        elif isinstance(pl, Shard):
            outer.setdefault(pl.dim, []).append(cut)
        elif not isinstance(pl, Replicate):
            raise NotImplementedError(f"placements {param.placements}: Shard, _StridedShard "
                                      "or Replicate only")
    for dim, cuts in inner.items():
        for axis, parts, index, factor in cuts:
            if factor != math.prod(c[1] for c in outer.get(dim, [])):
                raise NotImplementedError(f"placements {param.placements}: a _StridedShard "
                                          "that does not stride over the cuts before it")
            outer.setdefault(dim, []).append((axis, parts, index))
    return {d: [c for c in cuts if c[1] > 1] for d, cuts in outer.items()
            if any(c[1] > 1 for c in cuts)}


def _block(param: torch.Tensor) -> List[Tuple[int, int]]:
    """``[(start, stop)]`` per dimension: where this rank's block of
    ``param`` lies in the whole parameter."""
    bounds = [(0, d) for d in param.shape]
    for dim, cuts in splits(param).items():
        start, stop = bounds[dim]
        for _, parts, index in cuts:
            size = -(-(stop - start) // parts)
            start, stop = (start + min(index * size, stop - start),
                           start + min((index + 1) * size, stop - start))
        if start == stop:
            raise NotImplementedError(f"an empty block of a {tuple(param.shape)} parameter")
        bounds[dim] = (start, stop)
    return bounds


def leaf_regions(model: torch.nn.Module, layout: JaxLayout) -> Dict[str, List[Tuple[int, int]]]:
    """Where this rank's block of each parameter and moment leaf lies in the
    leaf, as ``[(start, stop)]`` per dimension, for the chunk names of the
    checkpoint format. Reckoned from shapes alone: the layout is applied to
    empty tensors whose one dimension is cut to the block's length, and to
    its stop; the leaf dimension that follows is the one the block splits,
    and the leaf's sizes give the leaf block's. A parameter may be split on
    up to as many dimensions as it has (``tp`` and ``fsdp`` on two). Raises
    if the layout does not keep a block whole."""
    params = _params_by_name(model)
    blocks = {n: _block(p) for n, p in params.items()}

    def shapes(dim: Optional[int] = None, to_stop: bool = False) -> Dict[str, Tuple[int, ...]]:
        meta = {}
        for n, p in params.items():
            shape = list(p.shape)
            if dim is not None and dim < len(shape):
                start, stop = blocks[n][dim]
                shape[dim] = stop if to_stop else stop - start
            meta[n] = torch.empty(shape, device="meta")
        flat: Dict[str, Any] = {}
        _flatten(layout.to_jax(meta), "", flat)
        return {k: tuple(t.shape) for k, t in flat.items()}

    full = shapes()
    bounds = {k: [(0, d) for d in shape] for k, shape in full.items()}
    for dim in range(max(p.dim() for p in params.values())):
        length, stop = shapes(dim), shapes(dim, to_stop=True)
        for key, shape in full.items():
            split = [d for d in range(len(shape)) if length[key][d] != shape[d]]
            if len(split) > 1 or any(bounds[key][d] != (0, shape[d]) for d in split):
                raise ValueError(f"leaf {key}: the layout splits a block over dims {split}")
            for d in split:
                bounds[key][d] = (stop[key][d] - length[key][d], stop[key][d])
    return {prefix + key: b for key, b in bounds.items()
            for prefix in (".params", *(p for p, _ in _MOMENTS))}


def written_leaves(model: torch.nn.Module, layout: JaxLayout, coordinate: Mapping[str, int]):
    """The parameter and moment leaves whose block this rank writes: those
    of whose replicas it holds the first, its coordinate (``coordinate``:
    mesh axis -> this rank's index on the whole mesh) being 0 on every axis
    that does not split the parameter. Decided leaf by leaf: under ``tp``
    the LayerNorms are whole on every ``tp`` rank, the embedding is not."""
    params = _params_by_name(model)
    # the layout keeps dtypes: f64 marks what another rank writes
    meta = {}
    for n, p in params.items():
        split = {axis for cuts in splits(p).values() for axis, _, _ in cuts}
        mine = all(i == 0 for axis, i in coordinate.items() if axis not in split)
        meta[n] = torch.empty(p.shape, dtype=torch.float32 if mine else torch.float64,
                              device="meta")
    flat: Dict[str, Any] = {}
    _flatten(layout.to_jax(meta), "", flat)
    return {prefix + k for k, t in flat.items() if t.dtype == torch.float32
            for prefix in (".params", *(p for p, _ in _MOMENTS))}
