"""The debug mesh of the multi-device tests.

``make_debug_mesh`` is the JAX package's small 2-D ``("data", "model")``
mesh; here its positions may repeat a device, so ``devices=["cpu"] * 4``
gives the CPU tests a 2 x 2 mesh and ``["cuda:0"] * 4`` runs it on one card.
The production mesh (``make_production_mesh``) comes with the dry-run
(ROADMAP.md §1 item 3).
"""

from __future__ import annotations

from repro_torch.dist.meshes import make_mesh


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *, devices=None):
    """A small ``(n_data, n_model)`` mesh on ``("data", "model")``
    (default devices: every local card)."""
    return make_mesh((n_data, n_model), ("data", "model"), devices=devices)


__all__ = ["make_debug_mesh"]
