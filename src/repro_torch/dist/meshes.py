"""Named device meshes and the grid factorisation for the §III planners.

A :class:`Mesh` is a small value: an ``np.ndarray`` of ``torch.device``
shaped by the axis extents, plus the axis names.  It runs nothing by
itself; the mesh engines (:mod:`repro_torch.core.mrmr`,
:mod:`repro_torch.core.streaming`) keep one tensor per shard on its
position's device, launch the kernels once per shard and sum across
shards explicitly.  ``mesh.shape`` maps each axis name to its extent, as a
JAX mesh does, so ``mesh.shape[a]`` reads the same in both packages.

Positions may repeat a device: ``make_mesh((4,), ("data",),
devices=["cuda:0"] * 4)`` is four shards on one card, and
``devices=["cpu"] * 8`` the eight positions the CPU tests use (the
counterpart of the JAX package's forced host devices).

``factor_mesh`` splits a device or host count into a 2-D ``(obs, feat)``
grid.  The selector's both-large rule and the multi-host shard rule
(:func:`repro_torch.dist.multihost.resolve_host_shards`) both go through
it, as in the JAX package, so the two planners cannot drift.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


class Mesh:
    """Devices laid out on named axes.

    Args:
      devices: an array (or nested list) of devices, one per position,
        shaped by the axis extents; a position may repeat a device.
      axis_names: one name per array axis.

    All positions are CUDA devices or all are the CPU: a mesh that mixes
    the two raises, since nothing of the port moves a shard off its device
    or falls back to the CPU.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(
                f"devices of shape {arr.shape} and axes {names} length mismatch"
            )
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names must be distinct, got {names}")
        flat = [_indexed(resolve_device(d)) for d in arr.reshape(-1)]
        if len({d.type for d in flat}) > 1:
            raise ValueError(
                f"a mesh places every position on CUDA or every one on the "
                f"CPU; got {sorted({str(d) for d in flat})}"
            )
        out = np.empty(len(flat), dtype=object)
        out[:] = flat
        self.devices = out.reshape(arr.shape)
        self.axis_names = names

    @property
    def shape(self) -> dict:
        """Axis name -> extent, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Mesh)
            and self.axis_names == other.axis_names
            and self.devices.shape == other.devices.shape
            and list(self.devices.flat) == list(other.devices.flat)
        )

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.shape, tuple(self.devices.flat)))

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devs})"


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` without an index names the current card: spell it out, so
    two positions on one card compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def check_mesh_kind(mesh: Mesh, device) -> None:
    """A mesh runs where its data is: its positions are devices of
    ``device``'s kind (the selector's device, or the device of the tensors
    an engine is handed), so no shard moves between the CPU and a card."""
    kind = mesh.devices.flat[0].type
    if kind != torch.device(device).type:
        raise ValueError(
            f"mesh positions are {kind} devices but device={str(device)!r}; "
            "pass a device of the mesh's kind"
        )


def local_devices(device=None) -> list:
    """Every local CUDA device (``device``'s index first when one is given);
    ``[device]`` for the CPU.  Raises without a card, like every entry point."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type != "cuda":
        return [dev]
    first = dev.index if dev.index is not None else torch.cuda.current_device()
    order = [first] + [i for i in range(torch.cuda.device_count()) if i != first]
    return [torch.device("cuda", i) for i in order]


def make_mesh(
    shape: Sequence[int],
    axes: Sequence[str],
    *,
    devices=None,
) -> Mesh:
    """Build a named :class:`Mesh` of the given shape.

    Args:
      shape: extent per mesh axis, e.g. ``(2, 2)``.
      axes: axis name per extent, e.g. ``("data", "model")``.
      devices: devices to lay out (default: every local CUDA device; raises
        without a card).  The first ``prod(shape)`` are used, row-major.  A
        list may repeat a device to give one machine more positions than it
        has devices.
    """
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} length mismatch")
    n = math.prod(shape)
    if devices is None:
        devices = local_devices()
    devices = list(devices)
    if len(devices) < n:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} needs {n} devices, "
            f"have {len(devices)}"
        )
    return Mesh(np.asarray(devices[:n], dtype=object).reshape(shape), axes)


def host_mesh(
    shape: Sequence[int] | None = None,
    axes: Sequence[str] = ("hosts",),
    *,
    devices=None,
) -> Mesh:
    """A mesh with ONE representative device per process, process ``p`` at
    row-major position ``p`` (so shard coordinates equal mesh coordinates).

    Args:
      shape: extent per axis (default ``(num_processes,)``); must multiply
        out to the process count.
      axes: axis name per extent.
      devices: the representative devices, ordered by process index;
        default ``cuda:(p % cards)`` for process ``p`` of the
        ``torch.distributed`` group (one process without a group), the card
        ``repro_torch.launch.select_multihost`` gives worker ``p``.
    """
    if devices is None:
        from repro_torch.dist.multihost import process_count

        cards = len(local_devices())
        devices = [torch.device("cuda", p % cards) for p in range(process_count())]
    devices = list(devices)
    if shape is None:
        shape = (len(devices),)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if math.prod(shape) != len(devices):
        raise ValueError(
            f"host mesh shape {dict(zip(axes, shape))} needs "
            f"{math.prod(shape)} hosts, have {len(devices)}"
        )
    return Mesh(np.asarray(devices, dtype=object).reshape(shape), axes)


def factor_mesh(n_devices: int, *, bias: float = 1.0) -> tuple[int, int]:
    """Split ``n_devices`` into a 2-D grid ``(a, b)``, ``a*b == n_devices``.

    ``bias`` > 1 pushes devices toward the first axis (the planner gives the
    longer data axis more shards).  Prefers balanced factorisations; falls
    back to ``(n, 1)`` for primes.
    """
    if n_devices <= 0:
        raise ValueError(f"n_devices must be positive, got {n_devices}")
    target = math.sqrt(n_devices * bias)
    best = (n_devices, 1)
    best_err = float("inf")
    for a in range(1, n_devices + 1):
        if n_devices % a:
            continue
        err = abs(math.log(a / target)) if target > 0 else float(a)
        if err < best_err:
            best, best_err = (a, n_devices // a), err
    return best


__all__ = ["Mesh", "check_mesh_kind", "factor_mesh", "host_mesh", "local_devices",
           "make_mesh"]
