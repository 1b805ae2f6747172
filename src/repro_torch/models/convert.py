"""Load the JAX package's parameters into a port model.

The JAX package draws its weights from ``jax.random`` keyed by an md5 of
each parameter path; the port cannot reproduce those bits.  Handing the
JAX parameter pytree over (nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, params)``) is the one way both packages compute
with the same weights.  Scanned stacks carry a leading layer axis:

* a :class:`DecoderLM`'s ``g0 .. g{P-1}``, one stack a position of the
  layer group (``P`` is 1 but for the hybrid): leaf ``i`` of ``g{j}`` is
  layer ``i * P + j``;
* an :class:`EncDecLM`'s ``enc_blocks`` and ``dec_blocks``: leaf ``i`` is
  encoder (decoder) layer ``i``.

Every other entry (``embed``, the final norms, ``unembed``) is a top-level
weight.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import group_pattern


def _flatten(tree: dict, prefix=()) -> dict:
    out = {}
    for name, leaf in tree.items():
        path = prefix + (name,)
        if isinstance(leaf, dict):
            out.update(_flatten(leaf, path))
        else:
            out[path] = leaf
    return out


def _stacks(model) -> dict:
    """JAX stack name -> (the model's layer list attribute, layers per group,
    position in the group)."""
    if isinstance(model, EncDecLM):
        return {"enc_blocks": ("enc_layers", 1, 0), "dec_blocks": ("dec_layers", 1, 0)}
    period = len(group_pattern(model.cfg))
    return {f"g{j}": ("layers", period, j) for j in range(period)}


def params_from_jax(model, tree: dict):
    """Copy ``tree`` into ``model`` (cast to its dtype and device); every
    parameter must be given exactly once with its shape.  Returns ``model``."""
    targets = {tuple(name.split(".")): p for name, p in model.named_parameters()}
    stacks = _stacks(model)
    seen = set()
    for path, leaf in _flatten(tree).items():
        leaf = np.asarray(leaf)
        if path[0] in stacks:
            attr, period, j = stacks[path[0]]
            n = len(getattr(model, attr)) // period
            if leaf.shape[0] != n:
                raise ValueError(f"{'/'.join(path)}: {leaf.shape[0]} layers, "
                                 f"the model has {n} in this stack")
            items = [((attr, str(i * period + j)) + path[1:], leaf[i]) for i in range(n)]
        else:
            items = [(("top",) + path, leaf)]
        for key, value in items:
            p = targets.get(key)
            if p is None:
                raise KeyError(f"{'/'.join(path)} has no counterpart in the model")
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{'.'.join(key)}: shape {value.shape}, want {tuple(p.shape)}")
            with torch.no_grad():
                p.copy_(torch.from_numpy(np.array(value)))  # a writable copy
            seen.add(key)
    missing = sorted(".".join(k) for k in set(targets) - seen)
    if missing:
        raise KeyError(f"parameters not in the JAX tree: {missing}")
    return model
