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
JAX package's scan does.  ``mesh=`` trains over a
:class:`~repro_torch.dist.meshes.Mesh`:

* a mesh of batch axes only (``pod``, ``data``) runs data parallelism: the
  positions each take their contiguous rows on their own device, and the
  gradients (and losses) are summed in mesh order on the state's device
  (``dist.sharding.psum``) and divided by the position count.  Two
  positions on one device give bitwise the one-device step with
  ``microbatches=2``: the same per-part gradients, summed in the same
  order.
* a mesh with a ``model`` axis trains every family on the model mesh
  (:class:`~repro_torch.models.model.MeshLM`,
  :class:`~repro_torch.models.encdec.MeshEncDecLM`): the state holds each
  position's blocks of ``params``, ``m`` and ``v`` (one flat dict a
  position, laid out by :func:`make_train_state_specs`; a leaf replicated
  over positions is a copy a position), the loss runs through
  ``MeshLM.train_loss``, and each leaf's gradient is summed in mesh order
  over the positions holding the same block (its replica axes) before
  AdamW updates every block by the whole tree's norm
  (``optimizer.shard_global_norm``).  Microbatches split each batch
  shard's rows, as the data-parallel step does.  The batch is a global
  dict or ``ShardedDataPipeline.shards_at(step)``'s shards.
  :func:`init_train_state`, :func:`shard_train_state` and
  :func:`gather_train_state` build and move such states.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.dist.sharding import PartitionSpec, ShardedArray, grid_devices, psum
from repro_torch.models.convert import jax_ndims, jax_paths, params_from_jax_tree, params_to_jax
from repro_torch.models.model import gather_leaves, mesh_model, shard_leaves
from repro_torch.train.optimizer import (AdamWConfig, adamw_init, adamw_update,
                                         shard_adamw_update)


@dataclasses.dataclass
class TrainState:
    """``params`` and the AdamW state ``opt = {"m", "v", "count"}`` (the
    moments with the parameters' names), and ``step``, an int32 scalar."""

    params: Any
    opt: Any
    step: Any

    @classmethod
    def create(cls, params, opt_cfg: AdamWConfig) -> "TrainState":
        """A state at step 0 with zero moments: ``params`` a flat dict, or
        one flat dict a position of a model mesh (the counters on the
        first position's device)."""
        if isinstance(params, dict):
            device = next(iter(params.values())).device
            return cls(params=params, opt=adamw_init(params, opt_cfg),
                       step=torch.zeros((), dtype=torch.int32, device=device))
        opts = [adamw_init(p, opt_cfg) for p in params]
        return cls(params=params, opt={"m": [o["m"] for o in opts], "v": [o["v"] for o in opts],
                                       "count": opts[0]["count"]},
                   step=torch.zeros_like(opts[0]["count"]))


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


BATCH_AXES = ("pod", "data")  # the mesh axes a batch's rows are split over
MODEL_AXIS = "model"  # a mesh with this axis trains on the model mesh


def is_model_mesh(mesh) -> bool:
    """Whether ``mesh`` trains on the model mesh (it has a ``model`` axis,
    of any extent): the state is then held as blocks, one flat dict a
    position."""
    return mesh is not None and hasattr(mesh, "axis_names") and MODEL_AXIS in mesh.shape


def _data_devices(mesh) -> list:
    axes = tuple(a for a in BATCH_AXES if a in mesh.shape)
    if not axes:
        raise ValueError(f"the mesh {mesh.shape} has none of the batch axes {BATCH_AXES}")
    others = {a: n for a, n in mesh.shape.items() if a not in axes and n > 1}
    if others:
        raise ValueError(f"mesh axes {others} are neither batch axes {BATCH_AXES} nor "
                         f"{MODEL_AXIS!r}")
    return [row[0] for row in grid_devices(mesh, axes, ())]


def _grads_of(loss: torch.Tensor, leaves: list) -> list:
    """d loss / d leaf for every leaf (zeros where the loss does not reach it)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]


def make_train_step(model, opt_cfg: AdamWConfig, *, mesh=None, donate: bool = False):
    """-> ``train_step(state, batch) -> (state, metrics)``; metrics hold
    ``loss``, ``aux_loss``, ``grad_norm``, ``lr`` and ``total_loss``.
    ``model`` gives the structure only (it may be a ``meta`` skeleton on a
    model mesh).  ``donate`` lets the step consume ``state`` (its leaves
    leave their dicts as AdamW replaces them), as the JAX trainer jits its
    step with ``donate_argnums=0``: the old and the new state are then
    never both whole in memory."""
    if is_model_mesh(mesh):
        return _model_mesh_step(model, opt_cfg, mesh, donate)
    micro = max(1, model.cfg.microbatches)
    decay = decay_mask(model)
    devices = None if mesh is None else _data_devices(mesh)

    def value_and_grad(params: dict, batch: dict):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, metrics = model.train_loss(batch, leaves)
        grads = dict(zip(leaves, _grads_of(loss, list(leaves.values()))))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def accumulate(params: dict, batch: dict):
        """The microbatches one after another, each's gradients summed as
        the next runs: ``launch.dryrun._more_microbatches`` takes a
        microbatch's ops to be a forward run (the previous sum at its head)
        then a backward run, and checks two microbatches' backward runs
        equal."""
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
                                                        opt_cfg, decay, donate=donate)
        metrics = dict(metrics, **opt_metrics, total_loss=loss)
        return TrainState(params=new_params, opt=new_opt, step=state.step + 1), metrics

    return train_step


def mesh_value_and_grad(model, mesh):
    """-> ``value_and_grad(shards, batch) -> (loss, metrics, grads)`` on the
    model mesh ``mesh``: ``shards`` one flat dict of weights a position,
    ``batch`` as ``MeshLM.split_inputs`` takes it, ``grads`` one flat dict
    a position, each block's gradient summed in mesh order over the
    positions holding it (its replica axes), so every holder has the whole
    gradient of its block.  ``cfg.microbatches`` splits each batch shard's
    rows."""
    micro = max(1, model.cfg.microbatches)
    meshed = mesh_model(model, mesh)
    ctx = meshed.ctx
    replicas = {name: meshed.replica_axes(name) for name in meshed.specs}

    def one(shards: list, parts: list):
        leaves = [{k: v.detach().requires_grad_(True) for k, v in sh.items()} for sh in shards]
        loss, metrics = meshed.with_shards(leaves).train_loss_positions(parts)
        grads = iter(_grads_of(loss, [t for sh in leaves for t in sh.values()]))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                [{k: next(grads) for k in sh} for sh in leaves])

    def accumulate(shards: list, parts: list):
        """The microbatches one after another, each's gradients summed as
        the next runs: ``launch.dryrun._more_microbatches`` takes a
        microbatch's ops to be a forward run (the previous sum at its head)
        then a backward run, and checks two microbatches' backward runs
        equal."""
        if micro == 1:
            return one(shards, parts)
        rows = parts[0]["targets"].shape[0]
        if rows % micro:
            raise ValueError(f"a batch shard of {rows} rows is not a multiple of "
                             f"microbatches={micro}")
        part = rows // micro
        gsum = [{k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in sh.items()} for sh in shards]
        lsum = torch.zeros((), dtype=torch.float32, device=meshed.device)
        for j in range(micro):
            loss_j, _, g = one(shards, [_rows(p, j * part, (j + 1) * part) for p in parts])
            gsum = [{k: acc[k] + gi[k] for k in acc} for acc, gi in zip(gsum, g)]
            lsum = lsum + loss_j
        loss = lsum / micro
        # As on one device: no aux_loss is carried out of the microbatches.
        metrics = {"loss": loss, "aux_loss": torch.zeros_like(loss)}
        return loss, metrics, [{k: v / micro for k, v in acc.items()} for acc in gsum]

    def value_and_grad(shards: list, batch):
        loss, metrics, grads = accumulate(shards, meshed.split_inputs(batch))
        for name, axes in replicas.items():
            if axes:
                for g, total in zip(grads, ctx.psum([g[name] for g in grads], axes)):
                    g[name] = total
        return loss, metrics, grads

    return value_and_grad


def _model_mesh_step(model, opt_cfg: AdamWConfig, mesh, donate: bool):
    """The step on a model mesh (see the module's docstring)."""
    decay = decay_mask(model)
    meshed = mesh_model(model, mesh)
    owners = {name: meshed.owners(name) for name in meshed.specs}
    value_and_grad = mesh_value_and_grad(model, mesh)

    def train_step(state: TrainState, batch):
        loss, metrics, grads = value_and_grad(state.params, batch)
        new_p, new_opt, opt_metrics = shard_adamw_update(grads, state.opt, state.params, opt_cfg,
                                                         owners, decay, donate)
        metrics = dict(metrics, **opt_metrics, total_loss=loss)
        return TrainState(params=new_p, opt=new_opt, step=state.step + 1), metrics

    return train_step


def make_train_state_specs(model) -> TrainState:
    """The PartitionSpecs of a ``TrainState`` of ``model`` on its mesh: the
    moments inherit the parameters' specs (``model.specs()``), the counters
    are replicated.  A state on a model mesh holds each position's blocks
    as these specs lay them out (:func:`shard_train_state`: ``mesh_model``
    reads the same ``param_specs``)."""
    specs = model.specs()
    return TrainState(params=specs, opt={"m": specs, "v": specs, "count": PartitionSpec()},
                      step=PartitionSpec())


def shard_train_state(model, state: TrainState, mesh) -> TrainState:
    """A one-device ``TrainState`` -> the same state on the model mesh
    ``mesh``: each position's blocks of ``params``, ``m`` and ``v`` on its
    device (a copy a position where a leaf is replicated), the counters on
    the first position's device."""
    meshed = mesh_model(model, mesh)

    def lead(t):
        return t if t.is_meta else t.to(meshed.device)

    return TrainState(params=shard_leaves(meshed, state.params),
                      opt={"m": shard_leaves(meshed, state.opt["m"]),
                           "v": shard_leaves(meshed, state.opt["v"]),
                           "count": lead(state.opt["count"])},
                      step=lead(state.step))


def gather_train_state(model, state: TrainState, mesh, device=None) -> TrainState:
    """The inverse of :func:`shard_train_state`: every leaf whole on
    ``device`` (default the mesh's first), assembled from each block's
    first holder."""
    meshed = mesh_model(model, mesh)
    device = meshed.device if device is None else device
    return TrainState(params=gather_leaves(meshed, state.params, device),
                      opt={"m": gather_leaves(meshed, state.opt["m"], device),
                           "v": gather_leaves(meshed, state.opt["v"], device),
                           "count": state.opt["count"].to(device)},
                      step=state.step.to(device))


def init_train_state(model, opt_cfg: AdamWConfig, mesh=None) -> TrainState:
    """A state at step 0 from ``model``'s weights: flat on the model's
    device, or on a model mesh each position's blocks (zero moments made in
    place, never whole on one device)."""
    if not is_model_mesh(mesh):
        return TrainState.create(model.flat_params(), opt_cfg)
    return TrainState.create(shard_leaves(mesh_model(model, mesh), model.flat_params()),
                             opt_cfg)


def train_state_shapes(model, opt_cfg: AdamWConfig, mesh=None) -> TrainState:
    """A ``TrainState`` of ``meta`` tensors: the shapes and dtypes a state
    of ``model`` has, nothing allocated (what a restore is shaped like).
    On a model mesh: each position's blocks."""
    mdt = getattr(torch, opt_cfg.moment_dtype)

    def like(dtype=None):
        return {k: torch.empty(p.shape, dtype=dtype or p.dtype, device="meta")
                for k, p in model.named_parameters()}

    count = torch.empty((), dtype=torch.int32, device="meta")
    state = TrainState(params=like(), opt={"m": like(mdt), "v": like(mdt), "count": count},
                       step=torch.empty((), dtype=torch.int32, device="meta"))
    return shard_train_state(model, state, mesh) if is_model_mesh(mesh) else state


def _host(t):
    return t if t.is_meta else t.detach().cpu()


def _blocks_to_jax(model, meshed, shards: list) -> dict:
    """One flat dict a position -> the JAX tree whose leaves are
    :class:`ShardedArray` s (the layer stacks' blocks stacked a position,
    their spec led by the unsharded layer axis), each block once: a
    position repeating a block holds None."""
    groups: dict = {}
    for name, (path, idx) in jax_paths(model).items():
        groups.setdefault(path, []).append((-1 if idx is None else idx, name))
    out: dict = {}
    for path, items in groups.items():
        names = [n for _, n in sorted(items)]
        stacked = items[0][0] >= 0
        owners = set(meshed.owners(names[0]))
        parts = []
        for i, sh in enumerate(shards):
            if i not in owners:
                parts.append(None)
            elif stacked:
                parts.append(torch.stack([_host(sh[n]) for n in names]))
            else:
                parts.append(_host(sh[names[0]]))
        spec = meshed.spec(names[0])
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = ShardedArray(parts, meshed.mesh,
                                      PartitionSpec(None, *spec) if stacked else spec)
    return out


def state_to_jax(model, state: TrainState, mesh=None) -> TrainState:
    """A port ``TrainState`` -> the JAX package's ``TrainState`` tree (on
    the host, ``meta`` leaves kept): ``params``, ``opt = {"count", "m",
    "v"}`` (the moments have the parameters' tree) and ``step``.  This is
    how the port's checkpoints keep the JAX package's on-disk layout.  A
    state on the model mesh ``mesh`` gives :class:`ShardedArray` leaves,
    which a checkpoint writes whole."""
    opt = state.opt
    if is_model_mesh(mesh):
        meshed = mesh_model(model, mesh)

        def tree(shards):
            return _blocks_to_jax(model, meshed, shards)
    else:
        def tree(flat):
            return params_to_jax(model, flat)
    return TrainState(params=tree(state.params),
                      opt={"m": tree(opt["m"]), "v": tree(opt["v"]),
                           "count": _host(opt["count"])},
                      step=_host(state.step))


def _from_jax(model, tree: dict, device):
    leaves = list(_leaves(tree))
    if not any(isinstance(leaf, ShardedArray) for leaf in leaves):
        return params_from_jax_tree(model, tree, device)
    n = len(leaves[0].parts)
    return [params_from_jax_tree(model, _map(tree, lambda a: a.parts[i])) for i in range(n)]


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def state_from_jax(model, tree, device=None) -> TrainState:
    """The JAX ``TrainState`` tree (either package's ``TrainState``: fields
    ``params``, ``opt``, ``step``) -> a port ``TrainState`` on ``device``;
    a tree of :class:`ShardedArray` s (a checkpoint restored onto a model
    mesh) -> the state on that mesh, each block where it lies."""

    def scalar(t):
        t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))
        return t.to(device) if device is not None else t

    opt = tree.opt
    return TrainState(params=_from_jax(model, tree.params, device),
                      opt={"m": _from_jax(model, opt["m"], device),
                           "v": _from_jax(model, opt["v"], device),
                           "count": scalar(opt["count"])},
                      step=scalar(tree.step))


__all__ = ["TrainState", "decay_mask", "gather_train_state", "init_train_state",
           "is_model_mesh", "make_train_state_specs", "make_train_step", "mesh_value_and_grad",
           "shard_train_state",
           "state_from_jax", "state_to_jax", "train_state_shapes"]
