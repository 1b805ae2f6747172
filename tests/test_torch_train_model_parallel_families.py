"""Training the SSM, hybrid and encoder-decoder families on a model mesh:
repro_torch's meshed mamba2, jamba and whisper losses, gradients and steps
vs the JAX package.

The smoke configs in float32, the JAX weights loaded with
``params_from_jax``, laid out on meshes of ``"cpu"`` positions,
``(data, model)`` = (1, 2), (1, 4) and (2, 2).  The meshed gradient of each
leaf (every block summed over its holders: Mamba's ``in_b``, ``in_c``,
``conv_b`` and ``conv_c``, the norms and biases on every ``model``
position) is gathered, restacked with ``params_to_jax`` and held to
``jax.value_and_grad`` of JAX's single-device bundle at
``test_torch_train_loss.py``'s ``LOSS_RTOL`` and ``GRAD_REL`` /
``GRAD_FLOOR`` rule; jamba's eight-layer superblock at ``1e-4`` (its
tolerance in ``test_torch_train_loss_families.py``).

jamba's MoE layers route each (batch shard, sequence chunk) block with its
own capacity and average the blocks' load-balance losses, as the MoE archs
on a mesh do (``test_torch_train_model_parallel.py``): at
``capacity_factor=8.0`` (no slot dropped) the loss without aux and its
gradients are held to JAX's; at 1.25 the aux, the routers' gradients and
every leaf to the port's one-device model with ``moe_blockwise_reference``
in place of ``moe_einsum``.

Also: the remat modes bitwise, the ``ff`` / ``ssm_heads`` mismatch config
and whisper with six heads at tp = 4 against JAX, two AdamW steps on the
mesh against one device's, and the meshed state's shapes.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_train_loss import GRAD_FLOOR, GRAD_REL, LOSS_RTOL, hold_grads
from test_torch_train_model_parallel import as_jax, blockwise_value_and_grad, mesh_grads
from test_torch_train_step import hold_params
from torch_train_cases import batch_for, jax_pair, jax_value_and_grad, torch_batch
from torch_train_cases import one_torch_thread  # noqa: F401  (autouse)

from repro_torch.configs import smoke_config
from repro_torch.dist import make_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import params_to_jax
from repro_torch.models.model import gather_leaves, mesh_model, shard_leaves
from repro_torch.train import (AdamWConfig, gather_train_state, init_train_state,
                               make_train_step, make_train_state_specs, train_state_shapes,
                               warmup_cosine)

MESHES = [(1, 2), (1, 4), (2, 2)]
B, S = 4, 32  # S: one SSD chunk of the smoke configs
ROOMY = 8.0  # capacity factor at which no smoke MoE layer drops a slot
HYBRID_REL = 1e-4
# (arch, config overrides): the two smoke configs, the Mamba config whose
# d_inner divides by 4 but whose 6 SSM heads do not, whisper with 6 heads.
CASES = {"mamba2": ("mamba2-1.3b", {}), "whisper": ("whisper-tiny", {}),
         "mamba2-d96": ("mamba2-1.3b", dict(d_model=96)),
         "whisper-h6": ("whisper-tiny", dict(num_heads=6, num_kv_heads=6))}


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * 4)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    arch, over = CASES[request.param]
    bundle, params, model = jax_pair(arch, **over)
    batch = batch_for(bundle.cfg, B, S, seed=3)
    return model, batch, jax_value_and_grad(bundle, params, batch)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_loss_and_every_gradient_leaf_match_jax(case, shape):
    model, batch, (want_loss, want_m, want_g) = case
    loss, metrics, grads = mesh_grads(model, _mesh(shape), batch)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["loss"], want_m["loss"], rtol=LOSS_RTOL)
    assert metrics["aux_loss"] == 0.0
    assert set(grads) == {n for n, _ in model.named_parameters()}
    hold_grads(as_jax(model, grads), want_g, GRAD_REL)


def _without_aux(model, mesh, batch):
    """The meshed loss without aux and its gradients, gathered whole."""
    meshed = mesh_model(model, mesh)
    leaves = [{k: v.requires_grad_(True) for k, v in sh.items()}
              for sh in shard_leaves(meshed, model.flat_params())]
    _, metrics = meshed.with_shards(leaves).train_loss(torch_batch(batch))
    flat = [t for sh in leaves for t in sh.values()]
    grads = iter(torch.autograd.grad(metrics["loss"], flat))
    per_pos = [{k: next(grads) for k in sh} for sh in leaves]
    for name in meshed.specs:
        for g, total in zip(per_pos, meshed.ctx.psum([g[name] for g in per_pos],
                                                     meshed.replica_axes(name))):
            g[name] = total
    return float(metrics["loss"].detach()), gather_leaves(meshed, per_pos)


@pytest.fixture(scope="module")
def jamba_roomy():
    bundle, params, model = jax_pair("jamba-1.5-large-398b", capacity_factor=ROOMY,
                                     microbatches=1)
    batch = batch_for(bundle.cfg, B, S, seed=3)
    jbatch = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: bundle.train_loss(p, jbatch)[1]["loss"]))(params)
    return model, batch, float(loss), grads


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_jamba_loss_without_aux_and_its_gradients_match_jax(jamba_roomy, shape):
    model, batch, want_loss, want_g = jamba_roomy
    loss, grads = _without_aux(model, _mesh(shape), batch)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    hold_grads(as_jax(model, grads), want_g, HYBRID_REL)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_jamba_aux_router_and_every_leaf_match_the_blockwise_reference(shape, monkeypatch):
    """At capacity factor 1.25 (slots dropped a block), the aux averaged
    over each MoE layer's blocks and summed over jamba's four MoE layers."""
    _, _, model = jax_pair("jamba-1.5-large-398b", capacity_factor=1.25, microbatches=1)
    batch = batch_for(model.cfg, B, S, seed=4)
    want_loss, want_m, want_g = blockwise_value_and_grad(model, batch, shape, monkeypatch)
    loss, metrics, grads = mesh_grads(model, _mesh(shape), batch)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["aux_loss"], want_m["aux_loss"], rtol=LOSS_RTOL)
    assert metrics["aux_loss"] > 0
    routers = [k for k in grads if k.endswith("moe.router")]
    assert len(routers) == 4
    for name, g in grads.items():
        scale = float(want_g[name].abs().max())
        err = float((g - want_g[name]).abs().max())
        assert err <= HYBRID_REL * scale + GRAD_FLOOR, f"{name}: {err} > {HYBRID_REL} * {scale}"
        if name in routers:
            assert scale > 0


def test_remat_modes_give_bitwise_equal_meshed_gradients():
    batch = batch_for(smoke_config("mamba2-1.3b"), B, S, seed=5)
    runs = {}
    for mode in ("none", "dots", "full"):
        _, _, model = jax_pair("mamba2-1.3b", remat=mode)
        runs[mode] = mesh_grads(model, _mesh((2, 2)), batch)
    loss, _, grads = runs["none"]
    for mode in ("dots", "full"):
        assert runs[mode][0] == loss
        for k, g in grads.items():
            assert torch.equal(runs[mode][2][k], g), (mode, k)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "whisper-tiny"])
def test_two_meshed_steps_match_one_device(arch):
    """``make_train_step(mesh=)`` on (2, 2) against the one-device step:
    the loss and norm within ``LOSS_RTOL``, the weights by
    ``test_torch_train_step``'s AdamW sign-flip rule; whisper's
    ``enc_embeds`` split over ``data`` with the rest of the batch."""
    _, _, model = jax_pair(arch)
    cfg = AdamWConfig(learning_rate=warmup_cosine(1e-3, 1, 10))
    mesh = _mesh((2, 2))
    a, b = init_train_state(model, cfg, mesh), init_train_state(model, cfg)
    meshed, one = make_train_step(model, cfg, mesh=mesh), make_train_step(model, cfg)
    lrs = []
    for seed in (6, 7):
        batch = torch_batch(batch_for(model.cfg, B, S, seed=seed))
        a, ma = meshed(a, batch)
        b, mb = one(b, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(ma[key]), float(mb[key]), rtol=LOSS_RTOL)
        lrs.append(float(mb["lr"]))
    whole = gather_train_state(model, a, mesh)
    hold_params(params_to_jax(model, whole.params), as_jax(model, b.params), lrs)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b", "whisper-tiny"])
def test_train_state_shapes_on_a_mesh_are_each_positions_blocks(arch):
    _, _, model = jax_pair(arch)
    mesh = _mesh((2, 2))
    cfg = AdamWConfig(moment_dtype="bfloat16")
    like, real = train_state_shapes(model, cfg, mesh=mesh), init_train_state(model, cfg, mesh)
    assert len(like.params) == len(real.params) == 4
    for lp, rp, lm in zip(like.params, real.params, like.opt["m"]):
        assert list(lp) == list(rp)
        for k in rp:
            assert lp[k].is_meta and lp[k].shape == rp[k].shape and lp[k].dtype == rp[k].dtype
            assert lm[k].is_meta and lm[k].shape == rp[k].shape and lm[k].dtype == torch.bfloat16
    specs = make_train_state_specs(build_model(model.cfg, device="meta", mesh=mesh))
    assert specs.params == mesh_model(model, mesh).specs == specs.opt["m"]
    if model.cfg.family in ("ssm", "hybrid"):
        ssm = next(k for k in specs.params if k.endswith("ssm.in_x"))
        assert real.params[0][ssm].shape[1] == model.cfg.ssm_expand * model.cfg.d_model // 2
