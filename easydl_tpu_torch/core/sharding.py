"""Sharding rules: logical parameter axes -> mesh axes, for FSDP2 and ``tp``.

Counterpart of ``easydl_tpu/core/sharding.py``. The JAX models annotate each
parameter with logical axis names and one rule table (:data:`DEFAULT_RULES`,
the same table) maps them onto mesh axes. Here :func:`gpt_param_axes` gives
each parameter of the port's GPT its logical axes, carried through the
port's layout: ``nn.Linear`` keeps ``weight [out, in]`` and merges the
heads, so ``q.weight [heads·kv, embed]`` has ``embed`` at dim 1 and
``out.weight [embed, heads·kv]`` at dim 0.

:func:`fsdp_placement` turns axes and rules into the dimension that FSDP2
shards (``fully_shard(..., shard_placement_fn=...)``): the one the rules
put on ``fsdp``. FSDP2 must shard every parameter it manages, so a
parameter that the rules replicate (the q/k/v and ``up`` biases, whose axes
carry no ``fsdp``) is sharded on dim 0 anyway; the JAX package keeps those
whole on every device. The ``dp`` axis replicates everything (HSDP).

:func:`tp_dim` is the dimension that the rules put on ``tp``: the heads of
q/k/v (dim 0) and ``out`` (dim 1), the hidden units of ``up`` (dim 0) and
``down`` (dim 1), the vocab of ``tok_emb`` (dim 0), and dim 0 of the
q/k/v and ``up`` biases. The trainer splits those over ``tp`` before FSDP2
splits them again over ``fsdp``; the rest (the LayerNorms, ``out.bias``,
``down.bias``, ``pos_emb``) stays whole on every ``tp`` rank. A q/k/v or
``up`` bias then has ``tp`` and FSDP2's fallback on the same dimension:
FSDP2 cuts each ``tp`` block again (``_StridedShard``), so a rank's block
stays contiguous, whole heads of the JAX ``(heads, kv)`` leaf.

The mesh is ``dp`` x ``fsdp`` x ``tp``: :func:`check_mesh` raises for
``sp``, ``ep`` or ``pp`` > 1, and for a ``tp`` that does not divide the
heads, the hidden units or the vocab.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Tuple

from easydl_tpu_torch.core.mesh_shapes import MeshSpec

#: logical axis -> mesh axis (or tuple of mesh axes, or None = replicated);
#: the JAX package's table, entry for entry.
DEFAULT_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", ("dp", "fsdp")),
    ("embed", "fsdp"),          # d_model dim of weights: sharded for FSDP
    ("mlp", "tp"),              # FFN hidden dim
    ("heads", "tp"),            # attention heads
    ("kv", None),               # per-head dim: replicated
    ("qkv", "tp"),
    ("vocab", "tp"),
    ("seq", "sp"),              # sequence dim of activations
    ("expert", "ep"),
    ("conv_in", None),
    ("conv_out", "fsdp"),
    ("stage", "pp"),
    ("layers", None),           # stacked layer params
    ("table", None),            # sparse embedding tables live on host PS
    ("table_vocab", "fsdp"),    # on-device embedding tables: shard the vocab dim
)

#: the ROADMAP.md item that brings each mesh axis the port cannot shard yet
UNPORTED_AXES = {"sp": "Queue A 7", "ep": "Queue A 7", "pp": "Queue A 7"}

#: logical axes of one dimension: a name, or the names a dimension merges
DimAxes = Tuple[str, ...]

_BLOCK = {
    # easydl_tpu/models/transformer.py: q/k/v kernel (embed, heads, kv) and
    # bias (heads, kv); out kernel (heads, kv, embed); up (embed, mlp);
    # down (mlp, embed); LayerNorm scale and bias (embed,)
    "q.weight": (("heads", "kv"), ("embed",)), "q.bias": (("heads", "kv"),),
    "k.weight": (("heads", "kv"), ("embed",)), "k.bias": (("heads", "kv"),),
    "v.weight": (("heads", "kv"), ("embed",)), "v.bias": (("heads", "kv"),),
    "out.weight": (("embed",), ("heads", "kv")), "out.bias": (("embed",),),
    "up.weight": (("mlp",), ("embed",)), "up.bias": (("mlp",),),
    "down.weight": (("embed",), ("mlp",)), "down.bias": (("embed",),),
    "ln_attn.weight": (("embed",),), "ln_attn.bias": (("embed",),),
    "ln_mlp.weight": (("embed",),), "ln_mlp.bias": (("embed",),),
}
_ROOT = {
    "tok_emb.weight": (("vocab",), ("embed",)),
    "pos_emb": (("seq",), ("embed",)),
    "ln_f.weight": (("embed",),), "ln_f.bias": (("embed",),),
}
_BLOCK_NAME = re.compile(r"^blocks\.\d+\.(.+)$")


def gpt_param_axes(name: str) -> Tuple[DimAxes, ...]:
    """The logical axes of each dimension of the port's GPT parameter
    ``name`` (a ``Transformer.named_parameters()`` key)."""
    m = _BLOCK_NAME.match(name)
    axes = _BLOCK.get(m.group(1)) if m else _ROOT.get(name)
    if axes is None:
        raise KeyError(f"no logical axes for GPT parameter {name!r}")
    return axes


def _mesh_axes(logical: str) -> Tuple[str, ...]:
    for name, target in DEFAULT_RULES:
        if name == logical:
            if target is None:
                return ()
            return (target,) if isinstance(target, str) else tuple(target)
    return ()


def mesh_axes(axes: Tuple[DimAxes, ...]) -> Tuple[Tuple[str, ...], ...]:
    """The mesh axes that :data:`DEFAULT_RULES` put each dimension on
    (``()`` = replicated), as ``nn.logical_to_mesh_sharding`` reads them."""
    return tuple(tuple(a for logical in dim for a in _mesh_axes(logical)) for dim in axes)


def fsdp_dim(axes: Tuple[DimAxes, ...]) -> Optional[int]:
    """The dimension that the rules shard over ``fsdp``, or None."""
    dims = [i for i, on in enumerate(mesh_axes(axes)) if "fsdp" in on]
    if len(dims) > 1:
        raise ValueError(f"axes {axes} put fsdp on dims {dims}")
    return dims[0] if dims else None


def tp_dim(axes: Tuple[DimAxes, ...]) -> Optional[int]:
    """The dimension that the rules split over ``tp``, or None (the
    parameter stays whole on every ``tp`` rank)."""
    dims = [i for i, on in enumerate(mesh_axes(axes)) if "tp" in on]
    if len(dims) > 1:
        raise ValueError(f"axes {axes} put tp on dims {dims}")
    return dims[0] if dims else None


def fsdp_placement(axes: Tuple[DimAxes, ...]) -> int:
    """The dimension FSDP2 shards: :func:`fsdp_dim`, else dim 0 (FSDP2
    shards every parameter it manages; the JAX package replicates these)."""
    dim = fsdp_dim(axes)
    return 0 if dim is None else dim


def shard_placement_fn(names: Dict[Any, str], param_axes: Callable[[str], Tuple[DimAxes, ...]]):
    """``fully_shard``'s ``shard_placement_fn``: ``Shard(dim)`` of each
    parameter (``names``: parameter -> its name, taken before sharding)."""
    from torch.distributed.tensor import Shard

    def placement(param) -> Shard:
        return Shard(fsdp_placement(param_axes(names[param])))

    return placement


def tp_group_of(t):
    """The ``tp`` process group that ``t`` (a parameter, its gradient, or
    one as FSDP2 gathers it) is split over, or None when it is whole on
    every ``tp`` rank."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return None
    mesh = t.device_mesh
    for m, (name, pl) in enumerate(zip(mesh.mesh_dim_names, t.placements)):
        if name == "tp" and isinstance(pl, Shard) and mesh.size(m) > 1:
            return mesh.get_group(m)
    return None


def split_over_tp(model, param_axes: Callable[[str], Tuple[DimAxes, ...]], tp_mesh) -> None:
    """Replaces each parameter of ``model`` that the rules put on ``tp`` by
    this rank's block of it (``torch.chunk``'s, on :func:`tp_dim`), a
    ``DTensor`` on the 1-D ``tp`` mesh ``tp_mesh``; the others stay whole."""
    from torch import nn
    from torch.distributed.tensor import DTensor, Shard

    parts, index = tp_mesh.size(), tp_mesh.get_local_rank()
    for name, p in list(model.named_parameters()):
        dim = tp_dim(param_axes(name))
        if dim is None:
            continue
        if p.shape[dim] % parts:
            raise ValueError(f"{name} {tuple(p.shape)}: tp={parts} does not divide dim {dim}")
        block = p.detach().chunk(parts, dim)[index].contiguous()
        owner, _, attr = name.rpartition(".")
        setattr(model.get_submodule(owner), attr, nn.Parameter(
            DTensor.from_local(block, tp_mesh, [Shard(dim)], run_check=False),
            requires_grad=p.requires_grad))


def check_mesh(spec: MeshSpec, cfg: Any = None) -> None:
    """Raises ``NotImplementedError`` for a mesh axis the port cannot shard
    yet, naming the ROADMAP.md item that brings it, and ``ValueError`` when
    ``tp`` does not divide the model's heads, hidden units or vocab (``cfg``:
    a ``TransformerConfig``, or None to check the axes alone)."""
    for axis, item in UNPORTED_AXES.items():
        if getattr(spec, axis) > 1:
            raise NotImplementedError(
                f"mesh {spec.key()}: {axis} > 1 is not ported yet (ROADMAP.md {item}); "
                "the port trains on dp x fsdp x tp")
    if spec.tp > 1 and cfg is not None:
        for what in ("n_heads", "d_ff", "vocab"):
            if getattr(cfg, what) % spec.tp:
                raise ValueError(f"mesh {spec.key()}: tp={spec.tp} does not divide "
                                 f"{what}={getattr(cfg, what)}")
