"""Move parameters and train states between the JAX package's layout and
the port's.

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
weight.  The port names a weight as ``named_parameters`` does
(``layers.3.attn.wq``, ``top.embed``): its flat dict is what a
``TrainState`` holds.

* :func:`params_from_jax` copies a JAX tree into a model;
* :func:`params_to_jax` restacks a flat port dict into the JAX tree
  (``train.train_step.state_to_jax`` / ``state_from_jax`` apply both to
  a whole ``TrainState``).
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


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.array(leaf))  # a writable copy


def jax_paths(model) -> dict:
    """port name -> (JAX path, layer index within its stack or None)."""
    by_attr: dict = {}  # layer list attribute -> {position in the group: stack}
    for stack, (attr, _, j) in _stacks(model).items():
        by_attr.setdefault(attr, {})[j] = stack
    out = {}
    for name, _ in model.named_parameters():
        head, *rest = name.split(".")
        if head in by_attr:
            layer, period = int(rest[0]), len(by_attr[head])
            out[name] = ((by_attr[head][layer % period],) + tuple(rest[1:]), layer // period)
        else:
            out[name] = (tuple(rest), None)
    return out


def jax_ndims(model) -> dict:
    """port name -> the number of axes of its leaf in the JAX layout (one
    more than here for a leaf of a layer stack)."""
    return {name: p.dim() + (paths[name][1] is not None)
            for paths in [jax_paths(model)] for name, p in model.named_parameters()}


def params_from_jax_tree(model, tree: dict, device=None) -> dict:
    """The JAX tree (numpy arrays or tensors) -> a flat port dict: per-layer
    slices of the stacks, dtypes kept, on ``device`` if given, in the
    order of ``model.named_parameters()``.  Every parameter must be given
    exactly once."""
    order = [name for name, _ in model.named_parameters()]
    names = set(order)
    stacks = _stacks(model)
    out = {}
    for path, leaf in _flatten(tree).items():
        leaf = _as_tensor(leaf)
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
            name = ".".join(key)
            if name not in names:
                raise KeyError(f"{'/'.join(path)} has no counterpart in the model")
            out[name] = value if device is None else value.to(device)
    missing = sorted(names - set(out))
    if missing:
        raise KeyError(f"parameters not in the JAX tree: {missing}")
    return {name: out[name] for name in order}


def params_from_jax(model, tree: dict):
    """Copy ``tree`` (numpy arrays or tensors) into ``model`` (cast to its
    dtype and device), each parameter with its shape.  Returns ``model``."""
    flat = params_from_jax_tree(model, tree)
    with torch.no_grad():
        for name, p in model.named_parameters():
            value = flat[name]
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(value.shape)}, want {tuple(p.shape)}")
            p.copy_(value)
    return model


def _host(t: torch.Tensor) -> torch.Tensor:
    """A checkpoint is a host snapshot; shape-only (``meta``) trees stay."""
    return t if t.is_meta else t.detach().cpu()


def params_to_jax(model, params: dict) -> dict:
    """A flat port dict (names of ``model.named_parameters()``) -> the JAX
    tree on the host: layer stacks restacked along a leading axis."""
    paths = jax_paths(model)
    if set(params) != set(paths):
        raise KeyError(f"params and the model differ in {sorted(set(params) ^ set(paths))[:5]}")
    groups: dict = {}
    for name, (path, idx) in paths.items():
        groups.setdefault(path, []).append((idx, _host(params[name])))
    out: dict = {}
    for path, items in groups.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if items[0][0] is None:
            node[path[-1]] = items[0][1]
        else:
            node[path[-1]] = torch.stack([t for _, t in sorted(items, key=lambda it: it[0])])
    return out
