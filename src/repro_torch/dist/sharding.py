"""Shard arithmetic over a :class:`~repro_torch.dist.meshes.Mesh`.

The selection side's half of the JAX package's ``repro.dist.sharding``:
``axes_tuple`` and ``mesh_extent``, plus what ``shard_map`` does for the
JAX engines and the port does by hand —

* ``flat_axis_index``: a position's row-major index along a set of axes
  (the JAX engines' ``_flat_axis_index``), which fixes the global ids a
  feature shard owns;
* ``grid_devices``: the device of every (observation shard, feature shard)
  pair, read off the mesh;
* ``shard_window``: a shard's rows (or columns) of a padded matrix, a view
  of the unpadded one wherever the shard lies inside it;
* ``psum``: the cross-shard sum, in mesh order, on one device.

The model-sharding half (``ShardingRules``, ``rules_for``,
``logical_to_spec``: model parameters onto a mesh) comes with the
model-parallel serve path (ROADMAP item 6.3); nothing selection-side
calls it.
"""

from __future__ import annotations

import numpy as np
import torch


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


def flat_axis_index(coords: dict, axes, mesh) -> int:
    """Row-major index of the position at ``coords`` along ``axes``."""
    idx = 0
    for a in axes_tuple(axes):
        idx = idx * mesh.shape[a] + int(coords[a])
    return idx


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
    "axes_tuple",
    "flat_axis_index",
    "grid_devices",
    "mesh_extent",
    "psum",
    "shard_window",
]
