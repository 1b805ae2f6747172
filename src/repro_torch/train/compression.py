"""Gradient compression: an int8 sum with a per-leaf scale and error
feedback (port of ``repro.train.compression``).

Before the data-parallel gradient sum each leaf is quantised to int8 with
a symmetric per-leaf scale (``max|g| -> 127``); the quantisation error is
kept in a residual and added back the next step (error feedback), so the
compression is unbiased over time.  Gradient trees are flat dicts
name -> tensor.  The sum runs over the port's explicit reductions:

* :func:`compressed_psum` — one process's call over a
  :class:`~repro_torch.dist.multihost.HostCollectives` (gloo): the scales
  reduced with ``pmax``, the int8 payloads widened to int32 and summed with
  ``psum``;
* :func:`compressed_psum_positions` — every position of an in-process
  :class:`~repro_torch.dist.meshes.Mesh` at once: the same reductions as
  explicit sums in mesh order (``dist.sharding.psum``).

Each leaf is requantised against the shared (largest) scale, so the
integer sum is exact and every position dequantises the same mean.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.sharding import psum


def _leaf_scale(g: torch.Tensor) -> torch.Tensor:
    """Symmetric per-leaf scale mapping max|g| -> 127 (1 for a zero leaf)."""
    m = torch.max(torch.abs(g))
    return torch.where(m > 0, m / 127.0, torch.ones_like(m)).to(torch.float32)


def _quantise(g: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)


@dataclasses.dataclass
class GradCompression:
    """Error-feedback residuals, one float32 tensor per gradient leaf."""

    residual: dict

    @classmethod
    def init(cls, params: dict) -> "GradCompression":
        return cls(residual={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                             for k, p in params.items()})

    def compress(self, grads: dict):
        """-> ((int8 leaves, float32 scales), the new state)."""
        q, s, r = {}, {}, {}
        for k, g in grads.items():
            g = g.to(torch.float32) + self.residual[k]
            s[k] = _leaf_scale(g)
            q[k] = _quantise(g, s[k])
            r[k] = g - q[k].to(torch.float32) * s[k]
        return (q, s), GradCompression(residual=r)


def _requant(q: dict, s: dict, s_max: dict) -> dict:
    """Each int8 payload re-expressed against the shared scale."""
    return {k: _quantise(q[k].to(torch.float32) * s[k], s_max[k]) for k in q}


def compressed_psum(grads: dict, collectives, state: GradCompression, world: int):
    """Quantise -> psum (int8 widened to int32) -> dequantise -> mean, for
    this process's ``grads`` over ``collectives`` (a ``HostCollectives``
    whose group holds ``world`` processes).  -> (mean gradients, new state).

    Wire payload per leaf: 1 byte an element plus one scale (against 4
    bytes an element for a float32 sum)."""
    (q, s), new_state = state.compress(grads)
    s_max = collectives.pmax(s)
    q = _requant(q, s, s_max)
    summed = collectives.psum({k: v.to(torch.int32) for k, v in q.items()})
    return {k: summed[k].to(torch.float32) * s_max[k] / world for k in summed}, new_state


def compressed_psum_positions(grads: list, states: list, device):
    """:func:`compressed_psum` for every position of an in-process mesh:
    ``grads[i]`` and ``states[i]`` are position ``i``'s.  -> (the mean
    gradients on ``device``, the new states)."""
    compressed = [st.compress(g) for g, st in zip(grads, states)]
    keys = list(grads[0])
    s_max = {k: torch.stack([c[0][1][k].to(device) for c in compressed]).amax(dim=0)
             for k in keys}
    parts = [_requant({k: c[0][0][k].to(device) for k in keys},
                      {k: c[0][1][k].to(device) for k in keys}, s_max) for c in compressed]
    world = len(grads)
    out = {k: psum([p[k].to(torch.int32) for p in parts], device).to(torch.float32)
           * s_max[k] / world for k in keys}
    return out, [c[1] for c in compressed]


__all__ = ["GradCompression", "compressed_psum", "compressed_psum_positions"]
