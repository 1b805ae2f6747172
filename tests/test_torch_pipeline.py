"""GPipe ``pipeline_apply`` of the port against the JAX package.

The stages of ``tests/multidevice/md_pipeline.py`` (``tanh(h @ W + b)``,
drawn from a seed with numpy) on a ``(4, 2)`` mesh of ``"cpu"`` positions
on ``("stage", "data")``, with 1, 2, 4 and 8 microbatches: held to the
JAX sequential fold of the same stages within ``1e-6`` (``md_pipeline``'s
tolerance; its 8-device run fails in the driver's runs, so the oracle is
the fold on one device, and JAX's ``pipeline_apply`` itself on a
one-device mesh), each microbatch bitwise the port's own fold of its rows
(so one microbatch is bitwise the fold); and JAX's two ``ValueError``s,
message for message.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.meshes import make_mesh as jax_make_mesh
from repro.dist.pipeline import pipeline_apply as jax_pipeline_apply

from repro_torch.dist import make_mesh, pipeline_apply

B, D = 16, 32


def _stages(s, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((s, D, D)) * D ** -0.5).astype(np.float32),
            "b": (0.1 * rng.standard_normal((s, D))).astype(np.float32)}, \
        rng.standard_normal((B, D)).astype(np.float32)


def _torch_stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _jax_stage(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _fold(stage, params, x, n):
    for s in range(n):
        x = stage({k: v[s] for k, v in params.items()}, x)
    return x


@pytest.mark.parametrize("n_stages", [4, 8])
@pytest.mark.parametrize("microbatches", [1, 2, 4, 8])
def test_pipeline_matches_the_fold(n_stages, microbatches):
    params, x = _stages(n_stages)
    want = np.asarray(_fold(_jax_stage, {k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(x), n_stages))
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    mesh = make_mesh((4, 2), ("stage", "data"), devices=["cpu"] * 8)
    got = pipeline_apply(_torch_stage, tparams, torch.from_numpy(x), mesh=mesh,
                         microbatches=microbatches)
    assert got.shape == (B, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # Each microbatch meets the fold's operations on its own rows.
    folds = [_fold(_torch_stage, tparams, h, n_stages)
             for h in torch.from_numpy(x).chunk(microbatches)]
    assert torch.equal(got, torch.cat(folds))


def test_one_position_matches_jax_pipeline_apply():
    """JAX's own ``pipeline_apply`` on its one device (a one-stage mesh)."""
    params, x = _stages(4, seed=1)
    jmesh = jax_make_mesh((1, 1), ("stage", "data"))
    mesh = make_mesh((1, 1), ("stage", "data"), devices=["cpu"])
    for mb in (1, 4):
        want = jax_pipeline_apply(_jax_stage, jax.tree.map(jnp.asarray, params),
                                  jnp.asarray(x), mesh=jmesh, microbatches=mb)
        got = pipeline_apply(_torch_stage, {k: torch.from_numpy(v) for k, v in params.items()},
                             torch.from_numpy(x), mesh=mesh, microbatches=mb)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stages,mesh_stages,microbatches", [(6, 4, 1), (4, 4, 3)])
def test_the_errors_of_jax(stages, mesh_stages, microbatches):
    params, x = _stages(stages)
    with pytest.raises(ValueError) as want:
        jax_pipeline_apply(_jax_stage, params, x, mesh=types.SimpleNamespace(
            shape={"stage": mesh_stages}), microbatches=microbatches)
    mesh = make_mesh((mesh_stages,), ("stage",), devices=["cpu"] * mesh_stages)
    with pytest.raises(ValueError) as got:
        pipeline_apply(_torch_stage, {k: torch.from_numpy(v) for k, v in params.items()},
                       torch.from_numpy(x), mesh=mesh, microbatches=microbatches)
    assert str(got.value) == str(want.value)
