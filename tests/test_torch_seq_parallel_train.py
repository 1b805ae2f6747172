"""The sequence-parallel residual on a model mesh, trained: the dense, VLM
and MoE families' loss and every gradient leaf against
``jax.value_and_grad`` of JAX's single-device bundle.

yi-6b, qwen2-vl (its ``embeds`` split by ``split_inputs`` into each
position's sequence slice, as JAX's ``input_shardings`` lay them out) and
dbrx smoke configs with ``seq_shard_activations=True`` on (1, 2), (1, 4)
and (2, 2) meshes of ``"cpu"`` positions.  The norms' gradients come from
each position's slice and are summed over ``model`` with the other
replicated leaves (Megatron-SP); the loss gathers the final normed slices
before the vocabulary-parallel cross-entropy.  Tolerances are
``test_torch_train_model_parallel.py``'s: ``LOSS_RTOL``, and each leaf
within ``GRAD_REL`` of its largest JAX value plus ``GRAD_FLOOR``.  dbrx's
loss without aux, and its gradients, at capacity 8 (no slot dropped)
against JAX's; at the config's 1.25 its loss, aux and every leaf against
the port's one-device model with ``moe_blockwise_reference`` over the
mesh's blocks (each position's sequence slice is its block).  Also the
remat modes bitwise under SP.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_train_loss import GRAD_FLOOR, GRAD_REL, LOSS_RTOL, hold_grads
from test_torch_train_model_parallel import as_jax, blockwise_value_and_grad, mesh_grads
from test_torch_train_model_parallel_families import _without_aux
from torch_sp_cases import MESHES, SP, mesh, sp_pair
from torch_train_cases import batch_for, jax_pair, jax_value_and_grad
from torch_train_cases import one_torch_thread  # noqa: F401  (autouse)

from repro_torch.models import build_model
from repro_torch.models.convert import params_to_jax

B, S = 4, 32
DENSE = ["yi-6b", "qwen2-vl-2b"]


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    bundle, params, model = sp_pair(request.param)
    batch = batch_for(bundle.cfg, B, S, seed=3)
    return model, batch, jax_value_and_grad(bundle, params, batch)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_loss_and_every_gradient_leaf_match_jax(dense, shape):
    model, batch, (want_loss, want_m, want_g) = dense
    loss, metrics, grads = mesh_grads(model, mesh(shape), batch)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["loss"], want_m["loss"], rtol=LOSS_RTOL)
    assert metrics["aux_loss"] == 0.0
    assert set(grads) == {n for n, _ in model.named_parameters()}
    hold_grads(as_jax(model, grads), want_g, GRAD_REL)


@pytest.fixture(scope="module")
def moe_roomy():
    bundle, params, model = sp_pair("dbrx-132b")
    batch = batch_for(bundle.cfg, B, S, seed=3)
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: bundle.train_loss(p, jbatch)[1]["loss"]))(params)
    return model, batch, float(loss), grads


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_moe_loss_without_aux_and_its_gradients_match_jax(moe_roomy, shape):
    model, batch, want_loss, want_g = moe_roomy
    loss, grads = _without_aux(model, mesh(shape), batch)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    tree = jax.tree.map(lambda t: t.float().numpy(), params_to_jax(model, grads))
    hold_grads(tree, want_g, GRAD_REL)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=str)
def test_moe_at_its_capacity_matches_the_blockwise_reference(shape, monkeypatch):
    """At capacity factor 1.25 slots are dropped a block: the sequence
    slices the positions hold are the blocks ``moe_blockwise_reference``
    routes one by one."""
    _, _, model = jax_pair("dbrx-132b", capacity_factor=1.25, microbatches=1, **SP)
    batch = batch_for(model.cfg, B, S, seed=4)
    want_loss, want_m, want_g = blockwise_value_and_grad(model, batch, shape, monkeypatch)
    loss, metrics, grads = mesh_grads(model, mesh(shape), batch)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["aux_loss"], want_m["aux_loss"], rtol=LOSS_RTOL)
    assert metrics["aux_loss"] > 0
    for name, g in grads.items():
        scale = float(want_g[name].abs().max())
        err = float((g - want_g[name]).abs().max())
        assert err <= GRAD_REL * scale + GRAD_FLOOR, f"{name}: {err} > {GRAD_REL} * {scale}"


def test_remat_modes_are_bitwise_under_sp():
    """remat none / dots / full recompute the gathers and reduce-scatters
    on the same inputs: the loss and every gradient bitwise."""
    _, _, model = jax_pair("yi-6b", **SP)
    batch = batch_for(model.cfg, B, S, seed=5)
    runs = []
    for mode in ("none", "dots", "full"):
        model.cfg = dataclasses.replace(model.cfg, remat=mode)
        runs.append(mesh_grads(model, mesh((2, 2)), batch))
    for loss, _, grads in runs[1:]:
        assert loss == runs[0][0]
        for name, g in grads.items():
            assert torch.equal(g, runs[0][2][name]), name


def test_sp_on_and_off_train_to_the_same_loss():
    """The same weights and batch with the flag on and off on (2, 2): the
    loss within float rounding (the sums run in another order)."""
    _, _, model = jax_pair("yi-6b", **SP)
    off = build_model(dataclasses.replace(model.cfg, seq_shard_activations=False),
                      device="cpu", dtype=torch.float32)
    off.load_state_dict(model.state_dict())
    batch = batch_for(model.cfg, B, S, seed=6)
    on_loss, _, on_g = mesh_grads(model, mesh((2, 2)), batch)
    off_loss, _, off_g = mesh_grads(off, mesh((2, 2)), batch)
    np.testing.assert_allclose(on_loss, off_loss, rtol=LOSS_RTOL)
    for name, g in on_g.items():
        scale = float(off_g[name].abs().max())
        assert float((g - off_g[name]).abs().max()) <= GRAD_REL * scale + GRAD_FLOOR, name
