"""Train-step builder: the loss's gradient, AdamW and microbatch gradient
accumulation (port of ``repro.train.train_step``).

A :class:`TrainState` holds tensors the step owns: ``params`` and the AdamW
moments are flat dicts name -> tensor in the port's layout (the names of
``model.named_parameters()``), so the model is only the structure the loss
runs through (``model.train_loss(batch, params)``).  ``make_train_step``
returns ``train_step(state, batch) -> (new state, metrics)``, which builds
new tensors and leaves ``state`` as it was, as the JAX step does.

``cfg.microbatches = k`` splits the batch's rows into k contiguous parts,
sums their gradients into float32 zeros in order and divides by k, as the
JAX package's scan does.  ``mesh=`` runs data parallelism over a
:class:`~repro_torch.dist.meshes.Mesh`: the positions along its batch axes
each take their contiguous rows on their own device, and the gradients
(and losses) are summed in mesh order on the state's device
(``dist.sharding.psum``) and divided by the position count.  Two
positions on one device give bitwise the one-device step with
``microbatches=2``: the same per-part gradients, summed in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.dist.sharding import PartitionSpec, grid_devices, psum
from repro_torch.models.convert import jax_ndims, params_from_jax_tree, params_to_jax
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass
class TrainState:
    """``params`` and the AdamW state ``opt = {"m", "v", "count"}`` (the
    moments with the parameters' names), and ``step``, an int32 scalar."""

    params: Any
    opt: Any
    step: Any

    @classmethod
    def create(cls, params: dict, opt_cfg: AdamWConfig) -> "TrainState":
        device = next(iter(params.values())).device
        return cls(params=params, opt=adamw_init(params, opt_cfg),
                   step=torch.zeros((), dtype=torch.int32, device=device))


def decay_mask(model) -> dict:
    """name -> whether AdamW decays the parameter, decided as the JAX package
    decides it, on its stacked layout: a leaf of a layer stack has one more
    axis there than here, so every per-layer weight, norms and biases
    included, has two or more and is decayed; the top-level ones
    (``embed``, ``unembed``: yes; the final norms: no) go by their own."""
    return {name: ndim >= 2 for name, ndim in jax_ndims(model).items()}


def _rows(batch: dict, lo: int, hi: int, device=None) -> dict:
    """Rows [lo, hi) of every batched leaf (a 0-d leaf is shared)."""
    out = {}
    for k, v in batch.items():
        part = v if v.dim() == 0 else v[lo:hi]
        out[k] = part if device is None else part.to(device)
    return out


def _data_devices(mesh) -> list:
    axes = tuple(a for a in BATCH_AXES if a in mesh.shape)
    if not axes:
        raise ValueError(f"the mesh {mesh.shape} has none of the batch axes {BATCH_AXES}")
    others = {a: n for a, n in mesh.shape.items() if a not in axes and n > 1}
    if others:
        raise ValueError(f"mesh axes {others} would shard the model; the port trains data "
                         "parallel (training on a model mesh: ROADMAP.md §1 item 2b)")
    return [row[0] for row in grid_devices(mesh, axes, ())]


BATCH_AXES = ("pod", "data")  # the mesh axes a batch's rows are split over


def make_train_step(model, opt_cfg: AdamWConfig, *, mesh=None):
    """-> ``train_step(state, batch) -> (state, metrics)``; metrics hold
    ``loss``, ``aux_loss``, ``grad_norm``, ``lr`` and ``total_loss``."""
    micro = max(1, model.cfg.microbatches)
    decay = decay_mask(model)
    devices = None if mesh is None else _data_devices(mesh)

    def value_and_grad(params: dict, batch: dict):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, metrics = model.train_loss(batch, leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(leaves, grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def accumulate(params: dict, batch: dict):
        if micro == 1:
            return value_and_grad(params, batch)
        b = batch["targets"].shape[0]
        if b % micro:
            raise ValueError(f"batch {b} is not a multiple of microbatches={micro}")
        part = b // micro
        dev = next(iter(params.values())).device
        gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(micro):
            loss_i, _, g = value_and_grad(params, _rows(batch, i * part, (i + 1) * part))
            gsum = {k: gsum[k] + g[k] for k in gsum}
            lsum = lsum + loss_i
        loss = lsum / micro
        # As in the JAX package: no aux_loss is carried out of the microbatches.
        metrics = {"loss": loss, "aux_loss": torch.zeros((), dtype=torch.float32, device=dev)}
        return loss, metrics, {k: g / micro for k, g in gsum.items()}

    def data_parallel(params: dict, batch: dict):
        n = len(devices)
        b = batch["targets"].shape[0]
        if b % n:
            raise ValueError(f"batch {b} is not a multiple of the {n} data positions")
        lead = next(iter(params.values())).device
        replicas: dict = {}  # one copy of the weights a device, shared by its positions
        parts = []
        for i, dev in enumerate(devices):
            if dev not in replicas:
                replicas[dev] = {k: v.to(dev) for k, v in params.items()}
            parts.append(accumulate(replicas[dev], _rows(batch, i * b // n, (i + 1) * b // n, dev)))
        grads = {k: psum([p[2][k] for p in parts], lead) / n for k in params}
        loss = psum([p[0] for p in parts], lead) / n
        aux = psum([p[1]["aux_loss"] for p in parts], lead) / n
        return loss, {"loss": psum([p[1]["loss"] for p in parts], lead) / n,
                      "aux_loss": aux}, grads

    def train_step(state: TrainState, batch: dict):
        run = accumulate if devices is None else data_parallel
        loss, metrics, grads = run(state.params, batch)
        new_params, new_opt, opt_metrics = adamw_update(grads, state.opt, state.params,
                                                        opt_cfg, decay)
        metrics = dict(metrics, **opt_metrics, total_loss=loss)
        return TrainState(params=new_params, opt=new_opt, step=state.step + 1), metrics

    return train_step


def make_train_state_specs(model) -> TrainState:
    """The PartitionSpecs of a ``TrainState`` of ``model`` on its mesh: the
    moments inherit the parameters' specs (``model.specs()``), the counters
    are replicated.  A spec tree only: the port trains data parallel
    (training on a model mesh is ROADMAP.md §1 item 2b)."""
    specs = model.specs()
    return TrainState(params=specs, opt={"m": specs, "v": specs, "count": PartitionSpec()},
                      step=PartitionSpec())


def train_state_shapes(model, opt_cfg: AdamWConfig) -> TrainState:
    """A ``TrainState`` of ``meta`` tensors: the shapes and dtypes a state
    of ``model`` has, nothing allocated (what a restore is shaped like)."""
    mdt = getattr(torch, opt_cfg.moment_dtype)

    def like(dtype=None):
        return {k: torch.empty(p.shape, dtype=dtype or p.dtype, device="meta")
                for k, p in model.named_parameters()}

    count = torch.empty((), dtype=torch.int32, device="meta")
    return TrainState(params=like(), opt={"m": like(mdt), "v": like(mdt), "count": count},
                      step=torch.empty((), dtype=torch.int32, device="meta"))


def state_to_jax(model, state: TrainState) -> TrainState:
    """A port ``TrainState`` -> the JAX package's ``TrainState`` tree (on
    the host, ``meta`` leaves kept): ``params``, ``opt = {"count", "m",
    "v"}`` (the moments have the parameters' tree) and ``step``.  This is
    how the port's checkpoints keep the JAX package's on-disk layout."""

    def host(t):
        return t if t.is_meta else t.detach().cpu()

    opt = state.opt
    return TrainState(params=params_to_jax(model, state.params),
                      opt={"m": params_to_jax(model, opt["m"]),
                           "v": params_to_jax(model, opt["v"]),
                           "count": host(opt["count"])},
                      step=host(state.step))


def state_from_jax(model, tree, device=None) -> TrainState:
    """The JAX ``TrainState`` tree (either package's ``TrainState``: fields
    ``params``, ``opt``, ``step``) -> a port ``TrainState`` on ``device``."""

    def scalar(t):
        t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))
        return t.to(device) if device is not None else t

    opt = tree.opt
    return TrainState(params=params_from_jax_tree(model, tree.params, device),
                      opt={"m": params_from_jax_tree(model, opt["m"], device),
                           "v": params_from_jax_tree(model, opt["v"], device),
                           "count": scalar(opt["count"])},
                      step=scalar(tree.step))


__all__ = ["TrainState", "decay_mask", "make_train_step", "state_from_jax", "state_to_jax",
           "train_state_shapes"]
