"""GPipe pipeline parallelism over a mesh axis (port of
``repro.dist.pipeline``).

``pipeline_apply`` runs a stack of S identical stages sharded over a
``stage`` mesh axis: the position at stage coordinate ``i`` holds the
consecutive stages ``[i * S/n, (i + 1) * S/n)`` on its device, microbatches
flow from one position to the next (the ``ppermute``: a ``.to`` of the
activation onto the next position's device), and the last position's
outputs are summed over the axis in mesh order (the ``psum``: the other
positions contribute zeros, so the sum is exact).  Each microbatch meets
the stages in the order a sequential fold applies them, so with one
microbatch the result is bitwise the fold's.

The JAX body runs every position at every tick and discards what a
position computes before its first microbatch arrives or after its last
has left (the pipeline's bubbles); here a position runs only the ticks
that carry a microbatch.  Positions along the mesh's other axes hold
replicas of the same stages and inputs (JAX's ``P(axis)`` and ``P()``), so
the pipeline runs once, at coordinate 0 of every other axis.
"""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import psum


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def pipeline_apply(stage_fn, params, x: torch.Tensor, *, mesh, axis: str = "stage",
                   microbatches: int = 1) -> torch.Tensor:
    """Apply ``S`` stacked stages to ``x`` with GPipe over ``mesh[axis]``.

    Args:
      stage_fn: ``(stage_params, h) -> h`` for ONE stage.
      params: a tensor or a (nested) dict of tensors, each with a leading
        stage axis of size S, divisible by the axis extent; each position
        applies its consecutive block of stages in order.
      x: (B, ...) the whole batch; B divisible by ``microbatches``.
      mesh: a :class:`~repro_torch.dist.meshes.Mesh` with ``axis``.
      axis: the pipeline's mesh axis.
      microbatches: microbatches in flight (the bubbles shrink as this
        grows; 1 is fully sequential).
    Returns:
      (B, ...) on ``x``'s device: the S stages folded over ``x``.
    """
    n_stages = mesh.shape[axis]
    s_total = _first_leaf(params).shape[0]
    if s_total % n_stages:
        raise ValueError(f"{s_total} stages over {n_stages}-way axis {axis!r}")
    per = s_total // n_stages
    b = x.shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} not divisible by {microbatches} microbatches")
    mb = b // microbatches
    at = mesh.axis_names.index(axis)
    devs = []
    for i in range(n_stages):
        pos = [0] * len(mesh.axis_names)
        pos[at] = i
        devs.append(mesh.devices[tuple(pos)])
    local = [_tree_map(lambda a, i=i: a[i * per:(i + 1) * per].to(devs[i]), params)
             for i in range(n_stages)]

    def local_apply(i, h):
        for j in range(per):
            h = stage_fn(_tree_map(lambda a, j=j: a[j], local[i]), h)
        return h

    mbs = x.reshape((microbatches, mb) + x.shape[1:])
    last = n_stages - 1
    carry = [None] * n_stages  # what each position receives this tick
    outs = [None] * microbatches
    for t in range(microbatches + last):
        hs = [None] * n_stages
        for i in range(n_stages):
            m = t - i  # the microbatch at position i this tick
            if 0 <= m < microbatches:
                hs[i] = local_apply(i, mbs[m].to(devs[0]) if i == 0 else carry[i])
        if t >= last:  # microbatch t - last drains from the last position
            outs[t - last] = hs[last]
        carry = [None] + [h if h is None else h.to(devs[i + 1]) for i, h in enumerate(hs[:-1])]
    out = torch.stack(outs)
    # The psum over the axis: every position but the last holds zeros.
    parts = [torch.zeros_like(out, device=devs[i]) for i in range(last)] + [out]
    return psum(parts, x.device).reshape((b,) + x.shape[1:])


__all__ = ["pipeline_apply"]
