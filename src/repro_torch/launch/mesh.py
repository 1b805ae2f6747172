"""The meshes of the command lines and the multi-device tests.

``build_local_mesh`` is the JAX package's local mesh
(``repro.launch.train.build_local_mesh``): every local position on
``("data", "model")``, ``model_parallel`` of them on ``model``.  The
positions are ``mesh_positions``': ``REPRO_DEVICES=N`` positions cycled
over the local devices, so ``REPRO_DEVICES=4`` on one card is a mesh of
four positions of ``cuda:0`` (and of the CPU with ``--device cpu``).
``make_debug_mesh`` is the JAX package's small 2-D mesh; its positions
may repeat a device, so ``devices=["cpu"] * 4`` gives the CPU tests a
2 x 2 mesh and ``["cuda:0"] * 4`` runs it on one card.
``make_production_mesh`` is the dry run's mesh (:mod:`repro_torch.launch.dryrun`):
the JAX package's production topology, every position on the ``meta``
device.
"""

from __future__ import annotations

import os

from repro_torch.dist.meshes import local_devices, make_mesh


def mesh_positions(device) -> list:
    """The positions a command line lays its mesh over: ``REPRO_DEVICES=N``
    (N > 1) positions cycled over the local devices of ``device``, else
    those devices themselves."""
    devs = local_devices(device)
    n = int(os.environ.get("REPRO_DEVICES", "0"))
    return [devs[i % len(devs)] for i in range(n)] if n > 1 else devs


def build_local_mesh(model_parallel: int = 1, *, device=None):
    """``(n // model_parallel, model_parallel)`` on ``("data", "model")``
    over the ``n`` positions of ``mesh_positions(device)``."""
    devs = mesh_positions(device)
    if model_parallel < 1 or len(devs) % model_parallel:
        raise ValueError(f"{len(devs)} mesh positions do not split into "
                         f"{model_parallel}-way model parallelism (REPRO_DEVICES=N sets N)")
    return make_mesh((len(devs) // model_parallel, model_parallel), ("data", "model"),
                     devices=devs)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: ``(data=16, model=16)``, 256 cards, or with
    ``multi_pod`` ``(pod=2, data=16, model=16)``, 512 (the JAX package's
    ``make_production_mesh``; ``pod`` composes with ``data`` for data
    parallelism).

    Every position is the ``meta`` device: the dry run traces a step on
    shapes and dtypes alone, as the JAX dry run lowers and compiles without
    executing, so a production mesh is never allocated.  This is the one
    entry point that does not default to the card: no machine of one card
    holds 256 of them, and nothing here runs a kernel."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=["meta"] * (512 if multi_pod else 256))


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, devices=None):
    """A small ``(n_data, n_model)`` mesh on ``("data", "model")``
    (default devices: every local card)."""
    return make_mesh((n_data, n_model), ("data", "model"), devices=devices)


__all__ = ["build_local_mesh", "make_debug_mesh", "make_production_mesh", "mesh_positions"]
