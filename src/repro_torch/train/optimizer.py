"""AdamW with global-norm clipping, decoupled weight decay, LR schedules and
a configurable moment dtype (port of ``repro.train.optimizer``).

Plain functions on tensors, not ``torch.optim``, so every operation runs in
the JAX package's order: the same float32 expression per element, the
Python constants rounded to float32 where the JAX package's weak types
round them.  Parameter, gradient and moment trees are flat dicts name ->
tensor (the port's parameter names).  ``moment_dtype="bfloat16"`` stores the
moments in half the bytes; all update math runs in float32.

On a model mesh each position holds a flat dict of its blocks: the update
is elementwise, so it runs block by block (``adamw_update`` a position,
with the norm of :func:`shard_global_norm` passed in), as JAX's runs on
sharded arrays.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.dist.sharding import psum


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor * peak_lr``: a function of
    an integer step tensor -> float32 learning rate."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return schedule


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float | Callable = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    moment_dtype: str = "float32"

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.tensor(self.learning_rate, dtype=torch.float32, device=step.device)


def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, count 0."""
    dt = getattr(torch, cfg.moment_dtype)
    device = next(iter(params.values())).device

    def zeros():
        return {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()}

    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, summed in the
    sorted order of the names, whatever order the dict was built in (so a
    restored state clips by bitwise the same norm as the one it was saved
    from)."""
    leaves = [torch.sum(torch.square(tree[k].to(torch.float32))) for k in sorted(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def shard_global_norm(shards: list, owners: dict, device) -> torch.Tensor:
    """:func:`global_norm` of a tree held as blocks over a mesh:
    ``shards[i]`` is position ``i``'s flat dict, ``owners[name]`` the
    positions holding a distinct block of ``name`` (so a block replicated
    over positions is counted once).  One float32 sum of squares a block,
    the blocks summed in mesh order on ``device``, the names in sorted
    order."""
    leaves = [psum([torch.sum(torch.square(shards[i][k].to(torch.float32))) for i in owners[k]],
                   device) for k in sorted(shards[0])]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adamw_update(grads: dict, opt_state: dict, params: dict, cfg: AdamWConfig,
                 decay: dict | None = None, grad_norm: torch.Tensor | None = None,
                 donate: bool = False):
    """-> (new params, new optimizer state, ``{"grad_norm", "lr"}``).

    ``decay[name]`` says whether a parameter takes weight decay; by default
    a parameter of two or more dimensions does (matrices, not norms or
    biases).  The JAX package decides on its stacked layout, where a
    layer's norm weights and biases are ``(L, d)``: a train step passes
    that rule (``train_step.decay_mask``).  ``grad_norm`` (default: the
    :func:`global_norm` of ``grads``) is the norm the gradients are
    clipped by: a position of a mesh updates its blocks by the whole
    tree's norm.  ``donate`` consumes the inputs, as ``jax.jit(...,
    donate_argnums=0)`` does the JAX trainer's state: each leaf's
    parameter, moments and gradient leave their dicts as its update is
    made, so the old and the new state are never both whole."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    # A tensor numerator: ``float / tensor`` would be a reciprocal times the
    # float in torch, one rounding more than the JAX package's division.
    clip = torch.tensor(cfg.grad_clip_norm, dtype=torch.float32, device=gnorm.device)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    dt = getattr(torch, cfg.moment_dtype)
    lr = cfg.lr_at(count)
    b1c = 1 - cfg.b1 ** count.to(torch.float32)
    b2c = 1 - cfg.b2 ** count.to(torch.float32)
    new_p, new_m, new_v = {}, {}, {}
    take = dict.pop if donate else dict.__getitem__
    for name in list(params):
        p, m, v = (take(tree, name) for tree in (params, opt_state["m"], opt_state["v"]))
        g = take(grads, name).to(torch.float32) * scale
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        del m, v
        mhat = m32 / b1c
        vhat = v32 / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        wants_decay = p.dim() >= 2 if decay is None else decay[name]
        if wants_decay and cfg.weight_decay:
            step = step + cfg.weight_decay * p.to(torch.float32)
        new_p[name] = (p.to(torch.float32) - lr * step).to(p.dtype)
        new_m[name] = m32.to(dt)
        new_v[name] = v32.to(dt)
    return new_p, {"m": new_m, "v": new_v, "count": count}, {"grad_norm": gnorm, "lr": lr}


def shard_adamw_update(grads: list, opt_state: dict, params: list, cfg: AdamWConfig,
                       owners: dict, decay: dict | None = None, donate: bool = False):
    """:func:`adamw_update` of a tree held as blocks over a mesh: ``grads``
    and ``params`` one flat dict a position (every holder of a block with
    its whole gradient), ``opt_state = {"m": [...], "v": [...], "count"}``
    likewise, ``owners`` as :func:`shard_global_norm` takes it.  Every
    block is clipped by the whole tree's norm and updated on its device.
    Each position's gradients are released (``grads[i] = None``) once its
    blocks are updated, so the whole gradient and the whole new state are
    never held at once; ``donate`` consumes ``params`` and the moments as
    :func:`adamw_update` does.  -> (new params, new state, ``{"grad_norm",
    "lr"}``), the count and the metrics on the first position's device."""
    lead = opt_state["count"].device
    gnorm = shard_global_norm(grads, owners, lead)
    new_p, new_m, new_v = [], [], []
    for i, (g, p) in enumerate(zip(grads, params)):
        dev = next(iter(p.values())).device
        state_i = {"m": opt_state["m"][i], "v": opt_state["v"][i],
                   "count": opt_state["count"].to(dev)}
        p, o, metrics_i = adamw_update(g, state_i, p, cfg, decay, grad_norm=gnorm.to(dev),
                                       donate=donate)
        grads[i] = g = None
        new_p.append(p)
        new_m.append(o["m"])
        new_v.append(o["v"])
        if i == 0:
            count, metrics = o["count"].to(lead), {k: v.to(lead) for k, v in metrics_i.items()}
    return new_p, {"m": new_m, "v": new_v, "count": count}, metrics


__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "shard_adamw_update",
           "shard_global_norm", "warmup_cosine"]
