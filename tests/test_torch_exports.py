"""Every public name of the JAX package's subpackages that the port has
imports from the port's subpackage of the same name
(``from repro_torch.core import MRMRSelector`` as ``from repro.core
import MRMRSelector``), and ``MIScore.redundancy_conditional`` against
JAX's on the same counts.

``WAITING`` lists the names the port does not have, each with its reason:
what is not ported by design (ROADMAP.md §1 item 3's "Not to port": XLA's
jit builders and ``shard_map`` shims).
A name that lands in the port must be struck from it (the test fails
until it is).
"""

import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MIScore as JaxMIScore

from repro_torch.core import MIScore

NOT_PORTED = "XLA only, not ported (ROADMAP.md §1 item 3, 'Not to port')"
WAITING = {
    "core": {"build_engine_fn": NOT_PORTED, "make_alternative_fn": NOT_PORTED,
             "make_conventional_fn": NOT_PORTED, "make_grid_fn": NOT_PORTED},
    "data": {},
    "runtime": {},
    "train": {},
    "dist": {"pvary": NOT_PORTED, "shard_map": NOT_PORTED},
    "analysis": {},
}


def _public(mod) -> set:
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


@pytest.mark.parametrize("sub", sorted(WAITING))
def test_subpackage_exports_mirror_jax(sub):
    jax_mod = importlib.import_module(f"repro.{sub}")
    port = importlib.import_module(f"repro_torch.{sub}")
    names = _public(jax_mod)
    waiting = WAITING[sub]
    assert set(waiting) <= names, sorted(set(waiting) - names)
    missing = sorted(n for n in names - set(waiting) if not hasattr(port, n))
    assert not missing, f"repro_torch.{sub} lacks {missing}"
    landed = sorted(n for n in waiting if hasattr(port, n))
    assert not landed, f"strike {landed} from WAITING[{sub!r}]"


def test_import_from_the_subpackages():
    from repro_torch.core import MRMRSelector, mrmr_streaming  # noqa: F401
    from repro_torch.core.selector import get_engine
    from repro_torch.data import ShardedDataPipeline, SyntheticTokenSource  # noqa: F401
    from repro_torch.runtime import CheckpointManager  # noqa: F401
    from repro_torch.dist import ShardingRules, logical_to_spec, pipeline_apply  # noqa: F401
    from repro_torch.train import TrainState, make_train_state_specs, make_train_step  # noqa: F401

    assert get_engine("streaming") is not None  # core imports streaming last


def test_launch_mesh_mirrors_jax():
    from repro.launch import mesh as jax_mesh

    from repro_torch.launch import mesh

    for name in ("make_production_mesh", "make_debug_mesh"):
        assert callable(getattr(jax_mesh, name)) and callable(getattr(mesh, name)), name
        assert name in mesh.__all__


@pytest.mark.parametrize("v,c", [(2, 2), (3, 4)])
def test_redundancy_conditional_matches_jax(v, c):
    rng = np.random.default_rng(v * 10 + c)
    cands = rng.integers(0, v, (7, 500)).astype(np.int32)  # feature-major
    other = rng.integers(0, v, 500).astype(np.int32)
    cls = rng.integers(0, c, 500).astype(np.int32)
    want = np.asarray(JaxMIScore(v, c, use_pallas=False).redundancy_conditional(
        jnp.asarray(cands), jnp.asarray(other), jnp.asarray(cls)))
    got = MIScore(v, c).redundancy_conditional(
        torch.from_numpy(cands), torch.from_numpy(other), torch.from_numpy(cls))
    assert got.shape == (7,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    terms = MIScore(v, c).redundancy_terms(torch.from_numpy(cands), torch.from_numpy(other),
                                           torch.from_numpy(cls), conditional=True)
    np.testing.assert_allclose(terms["conditional"].numpy(), got.numpy(), rtol=0, atol=0)
