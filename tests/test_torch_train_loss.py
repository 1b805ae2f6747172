"""The port's training loss and gradients vs ``jax.value_and_grad`` of the
JAX package's ``ModelBundle.train_loss`` (dense, VLM; the other families
are in ``test_torch_train_loss_families.py``).

Smoke configs in float32, the JAX weights loaded with ``params_from_jax``,
one batch of B=2, S=32 from a seed.  The loss and ``aux_loss`` within
``rtol=1e-5``; every gradient leaf (restacked with ``params_to_jax``)
within ``GRAD_REL`` of that leaf's largest JAX value plus ``GRAD_FLOOR``.
The floor covers gradients that are zero in exact arithmetic: a key bias
shifts every score of a query equally, which the softmax cancels, and both
packages leave rounding noise of ~1e-10 there.  Also here: the three remat
modes give bitwise the same gradients, bf16 compute with float32 masters
against JAX at a bf16 tolerance, and the training attention's full and
blockwise branches against JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn

from repro_torch.configs import smoke_config
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax

from torch_train_cases import (
    batch_for,
    jax_pair,
    jax_value_and_grad,
    leaf_errors,
    port_value_and_grad,
)

ARCHS = ["yi-6b", "qwen1.5-0.5b", "qwen1.5-110b", "minitron-4b", "qwen2-vl-2b"]
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
GRAD_FLOOR = 1e-8
# bf16 compute, float32 masters: ~8 significand bits a rounding, a few
# hundred roundings deep; measured 0.0196 of a leaf's largest value at worst.
BF16_GRAD_REL = 5e-2
BF16_LOSS_RTOL = 2e-3


def hold_grads(got, want, rel, floor=GRAD_FLOOR):
    for name, (err, scale) in leaf_errors(got, want).items():
        assert err <= rel * scale + floor, f"{name}: {err} > {rel} * {scale}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf(arch):
    bundle, params, model = jax_pair(arch)
    batch = batch_for(bundle.cfg, 2, 32, seed=3)
    want_loss, want_m, want_g = jax_value_and_grad(bundle, params, batch)
    loss, metrics, grads, _ = port_value_and_grad(model, batch)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["loss"], want_m["loss"], rtol=LOSS_RTOL)
    assert metrics["aux_loss"] == want_m["aux_loss"] == 0.0
    hold_grads(grads, want_g, GRAD_REL)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen2-vl-2b"])
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


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "yi-6b"])
def test_bf16_compute_with_float32_masters(arch):
    bundle, params, _ = jax_pair(arch, dtype="bfloat16")
    model = build_model(dataclasses.replace(smoke_config(arch), dtype="bfloat16"), device="cpu",
                        dtype=torch.float32, compute_dtype="bfloat16")
    params_from_jax(model, params)
    assert model.param_dtype == torch.float32 and model.dtype == torch.bfloat16
    batch = batch_for(bundle.cfg, 2, 32, seed=5)
    want_loss, _, want_g = jax_value_and_grad(bundle, params, batch)
    loss, _, grads, raw = port_value_and_grad(model, batch)
    assert all(g.dtype == torch.float32 for g in raw.values())
    np.testing.assert_allclose(loss, want_loss, rtol=BF16_LOSS_RTOL)
    hold_grads(grads, want_g, BF16_GRAD_REL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,t", [(32, 32), (16, 32)])
def test_training_attention_branches_match_jax(causal, s, t):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, t, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, t, 2, 16)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    full = attn.full_attention(tq, tk, tv, causal=causal).numpy()
    np.testing.assert_allclose(full, np.asarray(jattn.full_attention(jq, jk, jv, causal=causal)),
                               rtol=1e-5, atol=1e-6)
    blk = attn.blockwise_attention(tq, tk, tv, causal=causal, block_q=8, block_kv=8).numpy()
    want = np.asarray(jattn.blockwise_attention(jq, jk, jv, causal=causal, block_q=8,
                                                block_kv=8))
    np.testing.assert_allclose(blk, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(blk, full, rtol=1e-5, atol=1e-6)


def test_blockwise_branch_in_the_loss():
    """At or above ``blockwise_attn_threshold`` positions the loss attends
    blockwise, as the JAX dispatch does."""
    over = dict(blockwise_attn_threshold=16, attn_block_q=8, attn_block_kv=8)
    bundle, params, model = jax_pair("qwen1.5-0.5b", **over)
    batch = batch_for(bundle.cfg, 2, 32, seed=6)
    want_loss, _, want_g = jax_value_and_grad(bundle, params, batch)
    loss, _, grads, _ = port_value_and_grad(model, batch)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    hold_grads(grads, want_g, GRAD_REL)


def test_default_weights_are_the_trainable_parameters():
    """Without ``params`` the loss runs on the model's own parameters, whose
    ``.grad`` its backward fills with the functional step's gradients."""
    bundle, _, model = jax_pair("minitron-4b")
    batch = batch_for(bundle.cfg, 2, 16, seed=8)
    _, _, _, want = port_value_and_grad(model, batch)
    loss, _ = model.train_loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    for name, p in model.named_parameters():
        assert p.requires_grad and torch.equal(p.grad, want[name]), name


def test_cross_entropy_loss_matches_jax():
    from repro.models.layers import cross_entropy_loss as jax_ce

    from repro_torch.models.layers import cross_entropy_loss

    rng = np.random.default_rng(9)
    logits = (3 * rng.standard_normal((2, 5, 48))).astype(np.float32)
    targets = rng.integers(0, 48, (2, 5)).astype(np.int32)
    for mask in (None, (rng.random((2, 5)) < 0.6).astype(np.float32),
                 np.zeros((2, 5), np.float32)):
        want = float(jax_ce(jnp.asarray(logits), jnp.asarray(targets),
                            None if mask is None else jnp.asarray(mask)))
        got = float(cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                                       None if mask is None else torch.from_numpy(mask)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
