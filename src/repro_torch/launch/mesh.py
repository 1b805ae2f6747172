"""The meshes of the command lines and the multi-device tests.

``build_local_mesh`` is the JAX package's local mesh
(``repro.launch.train.build_local_mesh``): every local position on
``("data", "model")``, ``model_parallel`` of them on ``model``.  The
positions are ``mesh_positions``': ``REPRO_DEVICES=N`` positions cycled
over the local devices, so ``REPRO_DEVICES=4`` on one card is a mesh of
four positions of ``cuda:0`` (and of the CPU with ``--device cpu``).
``make_debug_mesh`` is the JAX package's small 2-D mesh; its positions
may repeat a device, so ``devices=["cpu"] * 4`` gives the CPU tests a
2 x 2 mesh and ``["cuda:0"] * 4`` runs it on one card.  The production
mesh (``make_production_mesh``) comes with the dry-run (ROADMAP.md §1
item 3).
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


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, devices=None):
    """A small ``(n_data, n_model)`` mesh on ``("data", "model")``
    (default devices: every local card)."""
    return make_mesh((n_data, n_model), ("data", "model"), devices=devices)


__all__ = ["build_local_mesh", "make_debug_mesh", "mesh_positions"]
