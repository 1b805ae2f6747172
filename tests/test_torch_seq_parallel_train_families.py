"""The sequence-parallel residual on a model mesh, trained: the SSM, hybrid
and encoder-decoder families' loss and every gradient leaf against
``jax.value_and_grad`` of JAX's single-device bundle.

mamba2, jamba's superblock and whisper smoke configs with
``seq_shard_activations=True`` on (1, 2), (1, 4) and (2, 2) meshes of
``"cpu"`` positions: the Mamba mixer's gather and reduce-scatter, whisper's
encoder and decoder residuals each sliced by its own length, the
cross-attention's K/V projection reading the encoder output gathered over
``model`` (its backward a reduce-scatter).  Tolerances are
``test_torch_train_model_parallel_families.py``'s: ``LOSS_RTOL`` and
``GRAD_REL`` / ``GRAD_FLOOR``, jamba at ``1e-4``; jamba's loss without aux
and its gradients at capacity 8 (no slot dropped).
"""

import jax
import numpy as np
import pytest
from test_torch_train_loss import GRAD_REL, LOSS_RTOL, hold_grads
from test_torch_train_model_parallel import as_jax, mesh_grads
from test_torch_train_model_parallel_families import HYBRID_REL, _without_aux
from torch_sp_cases import MESHES, mesh, sp_pair
from torch_train_cases import batch_for, jax_value_and_grad
from torch_train_cases import one_torch_thread  # noqa: F401  (autouse)

from repro_torch.models.convert import params_to_jax

B, S = 4, 32  # S: one SSD chunk of the smoke configs


@pytest.fixture(scope="module", params=["mamba2-1.3b", "whisper-tiny"])
def case(request):
    bundle, params, model = sp_pair(request.param)
    batch = batch_for(bundle.cfg, B, S, seed=3)
    return model, batch, jax_value_and_grad(bundle, params, batch)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_loss_and_every_gradient_leaf_match_jax(case, shape):
    model, batch, (want_loss, want_m, want_g) = case
    loss, metrics, grads = mesh_grads(model, mesh(shape), batch)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["loss"], want_m["loss"], rtol=LOSS_RTOL)
    assert metrics["aux_loss"] == 0.0
    assert set(grads) == {n for n, _ in model.named_parameters()}
    hold_grads(as_jax(model, grads), want_g, GRAD_REL)


@pytest.fixture(scope="module")
def jamba_roomy():
    bundle, params, model = sp_pair("jamba-1.5-large-398b")
    batch = batch_for(bundle.cfg, B, S, seed=3)
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: bundle.train_loss(p, jbatch)[1]["loss"]))(params)
    return model, batch, float(loss), grads


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_jamba_loss_without_aux_and_its_gradients_match_jax(jamba_roomy, shape):
    model, batch, want_loss, want_g = jamba_roomy
    loss, grads = _without_aux(model, mesh(shape), batch)
    np.testing.assert_allclose(loss, want_loss, rtol=HYBRID_REL)
    tree = jax.tree.map(lambda t: t.float().numpy(), params_to_jax(model, grads))
    hold_grads(tree, want_g, HYBRID_REL)
