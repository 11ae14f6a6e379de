"""Logical mesh shapes: the port's own copy of ``easydl_tpu/core/mesh_shapes.py``.

:class:`MeshSpec` describes a logical device mesh; this module adds the
elastic shape algebra that the control plane needs:

- a canonical string key (``"dp=8"``, ``"dp=2,fsdp=2,tp=2"``) that rides
  directives, metrics records and policy history — :meth:`MeshSpec.key`
  / :meth:`MeshSpec.parse` round-trip it;
- :class:`MeshConstraints`: the per-model divisibility/memory limits a
  candidate shape must satisfy (tp must divide the head count, pp the
  layer count, the model axes together must shard the model at least
  ``min_model`` ways to fit device memory);
- :func:`enumerate_shapes`: every valid (data x model [x pipeline])
  factorization of a world size under those constraints, in a
  deterministic order that leads with the widest data axis.

Stdlib only, as the JAX package's module is; it gives the same answers
(``tests/test_torch_mesh.py``). :mod:`easydl_tpu_torch.core.mesh` builds a
``DeviceMesh`` from a :class:`MeshSpec`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Mapping, Tuple

#: Canonical axis order, outermost (slowest links: across nodes) -> innermost
#: (fastest links: NVLink within a node).
AXES: Tuple[str, ...] = ("pp", "dp", "fsdp", "ep", "sp", "tp")

#: Axes a batch dimension is sharded over (pure data parallelism axes).
BATCH_AXES: Tuple[str, ...] = ("dp", "fsdp")

#: Key/display order for shape strings (data axes first — "dp=8xfsdp=2").
_KEY_ORDER: Tuple[str, ...] = ("dp", "fsdp", "tp", "sp", "ep", "pp")


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Unset axes default to 1 and collapse away in the
    physical mesh only if every axis is 1 (we keep all names so PartitionSpecs
    stay valid regardless of shape)."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp * self.ep * self.pp

    def axis_sizes(self) -> Tuple[int, ...]:
        m = {"pp": self.pp, "dp": self.dp, "fsdp": self.fsdp, "ep": self.ep,
             "sp": self.sp, "tp": self.tp}
        return tuple(m[a] for a in AXES)

    @classmethod
    def from_world(
        cls,
        world: int,
        *,
        tp: int = 1,
        sp: int = 1,
        ep: int = 1,
        pp: int = 1,
        fsdp: int = 1,
    ) -> "MeshSpec":
        """Fill the ``dp`` axis with whatever ``world`` leaves after the model
        axes — the elastic master uses this to rebuild the mesh at a new world
        size without touching the model-parallel layout."""
        denom = tp * sp * ep * pp * fsdp
        if world % denom:
            raise ValueError(
                f"world={world} not divisible by tp*sp*ep*pp*fsdp={denom}"
            )
        return cls(dp=world // denom, fsdp=fsdp, tp=tp, sp=sp, ep=ep, pp=pp)

    def describe(self) -> str:
        parts = [f"{a}={s}" for a, s in zip(AXES, self.axis_sizes()) if s > 1]
        return "x".join(parts) if parts else "single-device"

    # ------------------------------------------------------- canonical key
    def key(self) -> str:
        """Canonical shape string: non-unit axes in ``dp,fsdp,tp,sp,ep,pp``
        order (``"dp=2,fsdp=2,tp=2"``); the all-unit shape is ``"dp=1"`` so
        a key is never empty (empty = "no shape decided" on the wire)."""
        parts = [f"{a}={getattr(self, a)}" for a in _KEY_ORDER
                 if getattr(self, a) > 1]
        return ",".join(parts) if parts else "dp=1"

    @classmethod
    def parse(cls, key: str) -> "MeshSpec":
        """Inverse of :meth:`key` (any axis order, whitespace tolerated).
        Raises ValueError on unknown axes, non-positive sizes, duplicates,
        or an empty string."""
        axes: dict = {}
        for part in str(key).split(","):
            part = part.strip()
            if not part:
                continue
            name, _, val = part.partition("=")
            name = name.strip()
            if name not in AXES:
                raise ValueError(
                    f"unknown mesh axis {name!r} in {key!r} (known: {AXES})")
            if name in axes:
                raise ValueError(f"duplicate mesh axis {name!r} in {key!r}")
            try:
                n = int(val.strip())
            except ValueError:
                raise ValueError(
                    f"mesh axis {name} in {key!r} is not an integer") from None
            if n < 1:
                raise ValueError(f"mesh axis {name}={n} in {key!r} must be "
                                 ">= 1")
            axes[name] = n
        if not axes:
            raise ValueError(f"empty mesh shape {key!r}")
        return cls(**axes)


@dataclass(frozen=True)
class MeshConstraints:
    """Per-model limits a candidate mesh shape must satisfy.

    The defaults admit only pure data parallelism — turning model axes on
    is an explicit, per-job statement about the model's divisibility
    (heads, layers) and memory footprint. ``0`` means "unconstrained" for
    the ``*_divides`` fields and ``max_dp``.
    """

    #: tensor-parallel width ceiling (1 = tp off)
    max_tp: int = 1
    #: tp must divide this (attention head count); 0 = no divisibility tie
    tp_divides: int = 0
    #: fsdp width ceiling (1 = fsdp off)
    max_fsdp: int = 1
    #: pipeline-stage ceiling (1 = pp off)
    max_pp: int = 1
    #: pp must divide this (layer count); 0 = no divisibility tie
    pp_divides: int = 0
    #: the model axes together (fsdp*tp*pp) must shard the model at least
    #: this many ways — the memory floor: a model that does not fit one
    #: device's memory unsharded sets this > 1, and any world smaller than it
    #: has NO valid shape
    min_model: int = 1
    #: data-axis ceiling (0 = unbounded) — e.g. a batch size that caps dp
    max_dp: int = 0

    @classmethod
    def from_dict(cls, doc: Mapping[str, Any]) -> "MeshConstraints":
        """Build from a job-config mapping, ignoring unknown keys (job.json
        evolves; an old master must not crash on a newer job spec)."""
        fields = {f for f in cls.__dataclass_fields__}  # type: ignore[attr-defined]
        return cls(**{k: int(v) for k, v in dict(doc).items()
                      if k in fields})


def validate_shape(spec: MeshSpec, world: int,
                   constraints: MeshConstraints = MeshConstraints(),
                   ) -> List[str]:
    """Why ``spec`` is not a valid shape for ``world`` chips under
    ``constraints`` — empty list = valid. Used both by enumeration and to
    answer "why was my pinned shape rejected" legibly."""
    problems: List[str] = []
    if spec.size != world:
        problems.append(f"size {spec.size} != world {world}")
    if spec.sp > 1 or spec.ep > 1:
        problems.append("sp/ep axes are not elastic-shape candidates "
                        "(model-structural: set them in the job config)")
    if spec.tp > max(constraints.max_tp, 1):
        problems.append(f"tp={spec.tp} > max_tp={constraints.max_tp}")
    if constraints.tp_divides and spec.tp > 1 \
            and constraints.tp_divides % spec.tp:
        problems.append(f"tp={spec.tp} does not divide "
                        f"tp_divides={constraints.tp_divides} (heads)")
    if spec.fsdp > max(constraints.max_fsdp, 1):
        problems.append(f"fsdp={spec.fsdp} > max_fsdp={constraints.max_fsdp}")
    if spec.pp > max(constraints.max_pp, 1):
        problems.append(f"pp={spec.pp} > max_pp={constraints.max_pp}")
    if constraints.pp_divides and spec.pp > 1 \
            and constraints.pp_divides % spec.pp:
        problems.append(f"pp={spec.pp} does not divide "
                        f"pp_divides={constraints.pp_divides} (layers)")
    if spec.fsdp * spec.tp * spec.pp < max(constraints.min_model, 1):
        problems.append(
            f"model axes fsdp*tp*pp={spec.fsdp * spec.tp * spec.pp} < "
            f"min_model={constraints.min_model} (memory floor)")
    if constraints.max_dp and spec.dp > constraints.max_dp:
        problems.append(f"dp={spec.dp} > max_dp={constraints.max_dp}")
    return problems


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_shapes(world: int,
                     constraints: MeshConstraints = MeshConstraints(),
                     ) -> Tuple[MeshSpec, ...]:
    """Every valid (dp x fsdp x tp [x pp]) factorization of ``world``
    under ``constraints``, deterministically ordered widest-data-axis
    first; at equal dp, the cheaper model axes lead (fsdp before tp
    before pp — fsdp adds only param all-gathers, tp adds per-layer
    activation collectives, pp adds schedule bubbles). The order doubles
    as the mesh policy's cold-start preference AND its probe order.

    Returns an EMPTY tuple when no shape is valid (prime world with a
    mandatory model axis, world below the ``min_model`` memory floor):
    the caller decides the fallback; this function never invents one.
    """
    if world < 1:
        return ()
    out: List[MeshSpec] = []
    for pp in _divisors(world):
        for tp in _divisors(world // pp):
            for fsdp in _divisors(world // (pp * tp)):
                spec = MeshSpec(dp=world // (pp * tp * fsdp), fsdp=fsdp,
                                tp=tp, pp=pp)
                if not validate_shape(spec, world, constraints):
                    out.append(spec)
    out.sort(key=lambda s: (-s.dp, s.pp, s.tp, s.fsdp))
    return tuple(out)
