"""The port's training loss and gradients vs ``jax.value_and_grad`` of the
JAX package's ``train_loss`` for the MoE, SSM, hybrid and encoder-decoder
smoke configs (tolerances as in ``test_torch_train_loss.py``).

MoE: the load-balance loss, summed over layers, within ``rtol=1e-5``, and
the loss that adds ``AUX_COEF`` times it.  jamba's 8-layer hybrid
superblock (Mamba, attention and MoE layers) drifts further in float32, as
its forward does (``test_torch_families.py``): its gradients are held at
``HYBRID_GRAD_REL`` beside a float64 witness, the port's float64 twin (the
router, dt and the decays float32 there too, as in JAX), that both
packages' float32 gradients lie within ``HYBRID_WITNESS`` of (measured:
the port 8.98e-5, JAX 4.91e-5, each other 4.99e-5 of a leaf's largest
gradient).  mamba2 alone is held at ``GRAD_REL`` (measured 5.8e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import AUX_COEF

from torch_train_cases import (
    batch_for,
    jax_pair,
    jax_value_and_grad,
    leaf_errors,
    port_value_and_grad,
)

ARCHS = ["dbrx-132b", "llama4-scout-17b-a16e", "mamba2-1.3b", "jamba-1.5-large-398b",
         "whisper-tiny"]
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
GRAD_FLOOR = 1e-8
HYBRID_GRAD_REL = 1e-4
HYBRID_WITNESS = 1e-4


def grad_rel(model):
    return HYBRID_GRAD_REL if model.cfg.family == "hybrid" else GRAD_REL


def hold_grads(got, want, rel):
    for name, (err, scale) in leaf_errors(got, want).items():
        assert err <= rel * scale + GRAD_FLOOR, f"{name}: {err} > {rel} * {scale}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_every_gradient_leaf(arch):
    bundle, params, model = jax_pair(arch)
    batch = batch_for(bundle.cfg, 2, 32, seed=3)
    want_loss, want_m, want_g = jax_value_and_grad(bundle, params, batch)
    loss, metrics, grads, _ = port_value_and_grad(model, batch)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["loss"], want_m["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["aux_loss"], want_m["aux_loss"], rtol=LOSS_RTOL)
    if model.cfg.num_experts:
        assert metrics["aux_loss"] > 0
        np.testing.assert_allclose(loss, metrics["loss"] + AUX_COEF * metrics["aux_loss"],
                                   rtol=1e-6)
    else:
        assert metrics["aux_loss"] == 0.0
    hold_grads(grads, want_g, grad_rel(model))
    if model.cfg.family == "hybrid":
        twin = build_model(dataclasses.replace(model.cfg, dtype="float64"), device="cpu")
        params_from_jax(twin, params)
        _, _, ref, raw = port_value_and_grad(twin, batch)
        assert raw["top.embed"].dtype == torch.float64
        hold_grads(grads, ref, HYBRID_WITNESS)
        hold_grads(want_g, ref, HYBRID_WITNESS)


@pytest.mark.parametrize("arch", ["dbrx-132b", "mamba2-1.3b", "whisper-tiny"])
def test_remat_modes_give_bitwise_equal_gradients(arch):
    bundle, params, _ = jax_pair(arch)
    batch = batch_for(bundle.cfg, 2, 32, seed=4)
    runs = {}
    for mode in ("none", "dots", "full"):
        _, _, model = jax_pair(arch, remat=mode)
        runs[mode] = port_value_and_grad(model, batch)
    loss, _, _, grads = runs["none"]
    for mode in ("dots", "full"):
        assert runs[mode][0] == loss
        for k, g in grads.items():
            assert torch.equal(runs[mode][3][k], g), (mode, k)
