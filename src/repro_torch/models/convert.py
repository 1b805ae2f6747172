"""Load the JAX package's parameters into a :class:`DecoderLM`.

The JAX package draws its weights from ``jax.random`` keyed by an md5 of
each parameter path; the port cannot reproduce those bits.  Handing the
JAX parameter pytree over (nested dicts of numpy arrays, e.g.
``jax.tree.map(np.asarray, params)``) is the one way both packages compute
with the same weights.  The scanned stack ``g0`` carries a leading layer
axis; leaf ``i`` of it goes to layer ``i``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import DecoderLM


def _flatten(tree: dict, prefix=()) -> dict:
    out = {}
    for name, leaf in tree.items():
        path = prefix + (name,)
        if isinstance(leaf, dict):
            out.update(_flatten(leaf, path))
        else:
            out[path] = leaf
    return out


def params_from_jax(model: DecoderLM, tree: dict) -> DecoderLM:
    """Copy ``tree`` into ``model`` (cast to its dtype and device); every
    parameter must be given exactly once with its shape.  Returns ``model``."""
    targets = {tuple(name.split(".")): p for name, p in model.named_parameters()}
    seen = set()
    for path, leaf in _flatten(tree).items():
        leaf = np.asarray(leaf)
        if path[0] == "g0":
            if leaf.shape[0] != len(model.layers):
                raise ValueError(f"{'/'.join(path)}: {leaf.shape[0]} layers, "
                                 f"the model has {len(model.layers)}")
            items = [(("layers", str(i)) + path[1:], leaf[i]) for i in range(leaf.shape[0])]
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
