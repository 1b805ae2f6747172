"""Shared cases of the port's training tests (imported by the
``test_torch_train_*`` files, which hold the port to the JAX package).

``jax_pair(case)``: a smoke config's JAX bundle, its parameters (biases and
norm weights perturbed off their zero/one init, so every weight matters) as
numpy, and the port model loaded with them; a case is an arch's id or
``JAMBA_CUT_CASE`` (``smoke_configs``).  ``batch_for``: JAX's
``input_specs`` batch for the config, made from a seed with numpy.
``port_value_and_grad`` / ``jax_value_and_grad``: the loss, its metrics
and every gradient leaf, the port's restacked into the JAX tree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.model import build_model as jax_build_model

from repro_torch.configs import smoke_config
from repro_torch.configs.jamba_1_5_large_398b import JAMBA_CUT
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, params_to_jax

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module's tests on one intra-op thread, the count restored after.
    Under pytest-xdist several workers share the machine's cores: at
    torch's default of a thread a core, their small CPU kernels spin
    against each other.  Imported by the model-mesh test files, whose
    meshed runs launch thousands of small kernels."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PERTURBED = {"bq", "bk", "bv", "b_in", "b_out", "w", "b", "dt_bias", "a_log", "d_skip",
             "norm"}


def perturbed(params, seed=7):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", None) in PERTURBED:
            x = x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


# jamba's smoke config cut as the card serves the published one
# (``JAMBA_CUT``: an attention layer, then a Mamba-2 layer with the MoE)
JAMBA_CUT_CASE = "jamba-cut"


def smoke_configs(case, **overrides):
    """-> (JAX's smoke config, the port's) of ``case`` (an arch's id, or
    ``JAMBA_CUT_CASE``: jamba's with ``JAMBA_CUT``) with ``overrides``."""
    arch, over = case, overrides
    if case == JAMBA_CUT_CASE:
        arch, over = "jamba-1.5-large-398b", {**JAMBA_CUT, **overrides}
    return (dataclasses.replace(jax_smoke_config(arch), **over),
            dataclasses.replace(smoke_config(arch), **over))


def jax_pair(case, **overrides):
    """(JAX bundle, JAX params as numpy, port model with those weights)."""
    jax_cfg, cfg = smoke_configs(case, **overrides)
    bundle = jax_build_model(jax_cfg, None)
    params = perturbed(bundle.init(jax.random.PRNGKey(1)))
    model = build_model(cfg, device="cpu")
    params_from_jax(model, params)
    return bundle, params, model


def batch_for(cfg, b, s, seed):
    """The train batch of JAX's ``input_specs`` as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        return {"enc_embeds": (0.5 * rng.standard_normal((b, s, cfg.d_model))).astype(np.float32),
                "dec_tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    out = {"targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.input_mode == "embeddings":
        out["embeds"] = (0.5 * rng.standard_normal((b, s, cfg.d_model))).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.mrope_sections:  # text time ids, an image-like (h, w) grid
        grid = rng.integers(0, 8, (b, s, 2))
        out["positions"] = np.concatenate(
            [np.broadcast_to(np.arange(s), (b, s))[..., None], grid], -1).astype(np.int32)
    return out


def torch_batch(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def jax_value_and_grad(bundle, params, batch):
    """-> (loss, metrics, grads) of ``jax.value_and_grad(bundle.train_loss)``."""
    (loss, metrics), grads = jax.jit(jax.value_and_grad(bundle.train_loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def port_value_and_grad(model, batch, params=None):
    """-> (loss, metrics, grads as the JAX tree of numpy arrays)."""
    flat = model.flat_params() if params is None else params
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    loss, metrics = model.train_loss(torch_batch(batch), leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(leaves, grads)}
    tree = jax.tree.map(lambda t: t.float().numpy(), params_to_jax(model, grads))
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, tree, grads


def leaf_errors(got, want) -> dict:
    """JAX path -> (max |got - want|, max |want|) over every leaf of ``want``."""
    out = {}
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for p in path:
            node = node[p.key]
        w = np.asarray(w, np.float64)
        out["/".join(p.key for p in path)] = (float(np.abs(np.asarray(node, np.float64) - w).max()),
                                             float(np.abs(w).max()))
    return out
