"""Sharded, deterministic, resumable token pipeline (port of
``repro.data.pipeline``).

The placement half of the LM data layer: a step-indexed source (an object
with ``block(step, lo, hi) -> np.ndarray``, pure in ``(seed, step)``, by
default :class:`~repro_torch.data.sources.SyntheticTokenSource`) is read
position by position over a :class:`~repro_torch.dist.meshes.Mesh`: the
positions along the batch axes split the global batch's rows into
contiguous parts, and each reads only its rows, onto its own device.  A
restart from step k replays the same stream with no loader state to keep.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.sources import SyntheticTokenSource
from repro_torch.dist.sharding import axes_tuple, grid_devices


@dataclasses.dataclass
class ShardedDataPipeline:
    """Token pipeline sharded over the mesh's batch axes.

    Args:
      mesh: the positions; batch rows are split over ``batch_axes``
        (positions along other axes hold the same rows, read once).
      global_batch: rows a step (divisible by the batch-axes extent).
      seq_len, vocab: token geometry.
      seed: stream seed; ``batch_at(step)`` is pure in (seed, step).
      source: a step-indexed block source; None builds the default
        :class:`SyntheticTokenSource` from the fields above.
    """

    mesh: object
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    batch_axes: tuple = ("pod", "data")
    source: object = None

    def __post_init__(self):
        axes = tuple(a for a in axes_tuple(self.batch_axes) if a in self.mesh.shape)
        self.batch_axes = axes
        self._devices = [row[0] for row in grid_devices(self.mesh, axes, ())]
        if self.global_batch % len(self._devices):
            raise ValueError(f"global_batch {self.global_batch} not divisible by "
                             f"batch-axes extent {len(self._devices)}")
        if self.source is None:
            self.source = SyntheticTokenSource(self.global_batch, self.seq_len, self.vocab,
                                               self.seed)

    def shards_at(self, step: int) -> list:
        """Each batch position's ``{"tokens", "targets"}`` (rows, S) int32 on
        its device, in mesh order: tokens are a row's first S ids, targets
        the S after the first.  A train step on a model mesh takes these
        shards as they are (each position's rows never pass through one
        device)."""
        per = self.global_batch // len(self._devices)
        out = []
        for i, dev in enumerate(self._devices):
            block = torch.from_numpy(np.ascontiguousarray(
                self.source.block(step, i * per, (i + 1) * per))).to(dev)
            out.append({"tokens": block[:, :self.seq_len], "targets": block[:, 1:]})
        return out

    def batch_at(self, step: int) -> dict:
        """The global batch at ``step``: ``tokens`` and ``targets`` (B, S)
        int32 on the first position's device, its rows assembled in mesh
        order from the positions' shards."""
        shards = self.shards_at(step)
        lead = self._devices[0]
        return {k: torch.cat([s[k].to(lead) for s in shards]) for k in ("tokens", "targets")}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


__all__ = ["ShardedDataPipeline"]
