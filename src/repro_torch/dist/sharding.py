"""Logical-axis sharding rules and shard arithmetic over a
:class:`~repro_torch.dist.meshes.Mesh` (port of ``repro.dist.sharding``).

The model half: parameters declare *logical* axis names
(``("vocab", "fsdp")``); a :class:`ShardingRules` maps each logical name to
a mesh axis (or ``None``, replicated), and :func:`logical_to_spec` resolves
a logical tuple to a :class:`PartitionSpec` for a mesh, dropping any mapping
whose mesh axis is absent, already used by an earlier dim, or does not
divide the dim, so one rule set serves every (arch, shape, mesh) cell.
These functions read only ``mesh.shape``.

The selection half: ``axes_tuple`` and ``mesh_extent``, plus what
``shard_map`` does for the JAX engines and the port does by hand —

* ``flat_axis_index``: a position's row-major index along a set of axes
  (the JAX engines' ``_flat_axis_index``), which fixes the global ids a
  feature shard owns;
* ``grid_devices``: the device of every (observation shard, feature shard)
  pair, read off the mesh;
* ``shard_window``: a shard's rows (or columns) of a padded matrix, a view
  of the unpadded one wherever the shard lies inside it;
* ``psum``: the cross-shard sum, in mesh order, on one device;
* ``shard_slices`` and :class:`ShardedArray`: a tensor's blocks as a
  spec lays them out, and a tensor held as its blocks (what a training
  state on a model mesh checkpoints and restores).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

AxisSel = "str | tuple[str, ...] | None"  # a mesh axis, a tuple of them, or None


class PartitionSpec(tuple):
    """A tuple of per-dim entries, each ``None``, a mesh axis name, or a
    tuple of names (sharded over their product), normalised as JAX's
    ``PartitionSpec`` normalises: a one-name tuple is the name, an empty
    one ``None``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (list, tuple)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e

        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical parameter axis -> mesh axis.  The defaults replicate
    everything (the one-device rules); :func:`rules_for` builds the
    production mapping from a mesh."""

    fsdp: AxisSel = None        # weight shards spread over data parallelism
    ff: AxisSel = None          # MLP hidden (Megatron TP)
    heads: AxisSel = None       # attention query heads
    kv_heads: AxisSel = None    # attention kv heads
    ssm_heads: AxisSel = None   # mamba state heads
    vocab: AxisSel = None       # embed/unembed vocab dim
    experts: AxisSel = None     # MoE expert parallelism
    expert_ff: AxisSel = None   # weight-stationary second EP level
    act_seq: AxisSel = None     # sequence-sharded activations (Megatron-SP)

    def axis_for(self, logical: str) -> AxisSel:
        if logical == "none":
            return None
        return getattr(self, logical, None)


def rules_for(mesh, *, fsdp: bool = True, seq_shard: bool = False) -> ShardingRules:
    """Production rules for a mesh: tensor-parallel dims on ``model``, FSDP
    weight shards on ``data`` (when enabled and present)."""
    tp = "model" if "model" in mesh.shape else None
    dp = "data" if (fsdp and "data" in mesh.shape) else None
    return ShardingRules(
        fsdp=dp, ff=tp, heads=tp, kv_heads=tp, ssm_heads=tp, vocab=tp, experts=tp,
        # Expert matrices keep their d_ff shards in place (tokens move
        # instead): the ff_axis level of the expert-parallel MoE.
        expert_ff=dp,
        act_seq=(tp if seq_shard else None),
    )


def axes_tuple(axes) -> tuple:
    """Normalise a mesh-axis selection (None | str | sequence) to a tuple."""
    if axes is None:
        return ()
    if isinstance(axes, (list, tuple)):
        return tuple(axes)
    return (axes,)


def mesh_extent(mesh, axes) -> int:
    """Product of the mesh extents of ``axes`` (1 for no mesh)."""
    if mesh is None:
        return 1
    ext = 1
    for a in axes_tuple(axes):
        ext *= mesh.shape[a]
    return ext


def logical_to_spec(logical: tuple, shape: tuple, mesh, rules: ShardingRules) -> PartitionSpec:
    """Resolve a logical axis tuple to a :class:`PartitionSpec` for ``mesh``.

    Guards applied per dim, in order: a mapping exists, all its mesh axes
    are present, no mesh axis was used by an earlier dim, the dim divides
    by the shard extent.  A dim failing any guard is replicated.
    """
    used: set = set()
    entries = []
    for name, dim in zip(logical, shape):
        sel = rules.axis_for(name)
        axes = (sel,) if isinstance(sel, str) else tuple(sel or ())
        ok = (axes and all(a in mesh.shape for a in axes) and not (set(axes) & used)
              and dim % mesh_extent(mesh, axes) == 0)
        if ok:
            used.update(axes)
            entries.append(axes[0] if len(axes) == 1 else axes)
        else:
            entries.append(None)
    return PartitionSpec(*entries)


def flat_axis_index(coords: dict, axes, mesh) -> int:
    """Row-major index of the position at ``coords`` along ``axes``."""
    idx = 0
    for a in axes_tuple(axes):
        idx = idx * mesh.shape[a] + int(coords[a])
    return idx


def spec_axes(spec) -> set:
    """The mesh axes a :class:`PartitionSpec` shards over."""
    return {a for e in spec if e is not None for a in axes_tuple(e)}


def shard_slices(mesh, coords: dict, spec, shape) -> tuple:
    """The block of a tensor of ``shape`` laid out by ``spec`` that the
    position at ``coords`` holds: one slice a dim."""
    out = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            out.append(slice(None))
        else:
            n = dim // mesh_extent(mesh, entry)
            lo = flat_axis_index(coords, entry, mesh) * n
            out.append(slice(lo, lo + n))
    return tuple(out)


def _positions(mesh) -> list:
    """Each position's coordinates (axis name -> index), row-major."""
    return [dict(zip(mesh.axis_names, c)) for c in np.ndindex(mesh.devices.shape)]


class ShardedArray:
    """A tensor laid out over a mesh as ``spec`` lays it out (what a JAX
    array with a ``NamedSharding`` is): ``parts[i]`` is the block the
    position ``i`` (row-major) holds, on its device, or None where the
    position repeats a block an earlier position holds (only each block's
    first holder is needed to assemble the whole).  A checkpoint writes it
    whole (:meth:`whole`) and restores it block by block
    (:meth:`from_whole`)."""

    __slots__ = ("parts", "mesh", "spec", "shape")

    def __init__(self, parts: list, mesh, spec):
        self.parts, self.mesh, self.spec = list(parts), mesh, PartitionSpec(*spec)
        first = next(p for p in self.parts if p is not None)
        self.shape = tuple(d * mesh_extent(mesh, e) for d, e in zip(first.shape, self.spec))

    def whole(self, device="cpu") -> torch.Tensor:
        """The tensor assembled on ``device`` from each block's first holder."""
        first = next(p for p in self.parts if p is not None)
        out = torch.empty(self.shape, dtype=first.dtype, device=device)
        done = set()
        for part, coords in zip(self.parts, _positions(self.mesh)):
            sl = shard_slices(self.mesh, coords, self.spec, self.shape)
            key = tuple((s.start, s.stop) for s in sl)
            if part is not None and key not in done:
                out[sl] = part.to(device)
                done.add(key)
        return out

    @classmethod
    def from_whole(cls, t: torch.Tensor, mesh, spec) -> "ShardedArray":
        """``t`` laid out over ``mesh``: every position a fresh contiguous
        copy of its block on its device (``meta`` blocks for a ``meta``
        tensor)."""
        spec = PartitionSpec(*spec)
        if t.is_meta:  # every block has one shape: no slicing a position
            shape = tuple(d if e is None else d // mesh_extent(mesh, e)
                          for d, e in zip(t.shape, tuple(spec) + (None,) * t.dim()))
            return cls([torch.empty(shape, dtype=t.dtype, device="meta")
                        for _ in range(mesh.size)], mesh, spec)
        parts = []
        for dev, coords in zip(mesh.devices.flat, _positions(mesh)):
            block = t[shard_slices(mesh, coords, spec, t.shape)]
            part = torch.empty(block.shape, dtype=t.dtype, device="meta" if t.is_meta else dev)
            parts.append(part if t.is_meta else part.copy_(block))
        return cls(parts, mesh, spec)


def grid_devices(mesh, obs_axes, feat_axes) -> list:
    """``[i][j]``: the device holding observation shard ``i`` of feature
    shard ``j`` — the position whose flat index along ``obs_axes`` is ``i``
    and along ``feat_axes`` is ``j``, at coordinate 0 of every other axis
    (a JAX shard is replicated along those; here it is placed once)."""
    obs, feat = axes_tuple(obs_axes), axes_tuple(feat_axes)
    missing = [a for a in obs + feat if a not in mesh.shape]
    if missing:
        raise ValueError(
            f"axes {tuple(missing)} are not axes of the mesh {mesh.shape}"
        )
    if set(obs) & set(feat):
        raise ValueError(
            f"obs_axes {obs} and feat_axes {feat} share an axis"
        )
    out = [[None] * mesh_extent(mesh, feat) for _ in range(mesh_extent(mesh, obs))]
    for pos in np.ndindex(mesh.devices.shape):
        coords = dict(zip(mesh.axis_names, pos))
        if any(coords[a] for a in mesh.axis_names if a not in obs + feat):
            continue
        i, j = flat_axis_index(coords, obs, mesh), flat_axis_index(coords, feat, mesh)
        out[i][j] = mesh.devices[pos]
    return out


def shard_window(x: torch.Tensor, dim: int, index: int, width: int, fill) -> torch.Tensor:
    """Shard ``index`` of ``x`` split along ``dim`` into pieces of ``width``:
    ``x``'s slice ``[index * width, (index + 1) * width)``, a view where it
    lies inside ``x``, else padded up to ``width`` with ``fill`` (a shard
    past the end is all ``fill``)."""
    total = x.shape[dim]
    lo = min(index * width, total)
    hi = min(lo + width, total)
    part = x.narrow(dim, lo, hi - lo)
    if hi - lo == width:
        return part
    shape = list(x.shape)
    shape[dim] = width - (hi - lo)
    pad = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([part, pad], dim=dim)


def psum(parts, device) -> torch.Tensor:
    """Sum of the per-shard tensors ``parts``, in mesh order, on ``device``
    (exact for integer counts, whatever the order)."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


__all__ = [
    "PartitionSpec",
    "ShardedArray",
    "ShardingRules",
    "axes_tuple",
    "flat_axis_index",
    "grid_devices",
    "logical_to_spec",
    "mesh_extent",
    "psum",
    "rules_for",
    "shard_slices",
    "shard_window",
    "spec_axes",
]
