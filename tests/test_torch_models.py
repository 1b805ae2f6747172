"""repro_torch dense decoders vs the JAX package's ``ModelBundle``.

For the smoke configs of yi-6b (GQA), qwen1.5-0.5b (QKV bias) and
minitron-4b (GELU MLP with biases), in float32: the JAX parameters (biases
and norm weights perturbed away from their zero/one init, so every weight
matters) are loaded into the port with ``params_from_jax``, and prefill
logits, KV caches and one decode step must agree within
``rtol=1e-5, atol=1e-5``.  On the CPU prefill attention runs the kernel's
plain version.  The other families are held in ``test_torch_families.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.model import build_model as jax_build_model

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import layer_norm, rms_norm

ARCHS = ["yi-6b", "qwen1.5-0.5b", "minitron-4b"]
TOL = dict(rtol=1e-5, atol=1e-5)
PERTURBED = {"bq", "bk", "bv", "b_in", "b_out", "w", "b"}


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", None) in PERTURBED:
            x = x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX bundle, JAX params as numpy, port model with those weights)."""
    arch = request.param
    bundle = jax_build_model(jax_smoke_config(arch), mesh=None)
    params = _perturbed(bundle.init(jax.random.PRNGKey(1)), seed=7)
    model = build_model(smoke_config(arch), device="cpu")
    params_from_jax(model, params)
    return arch, bundle, params, model


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def test_configs_are_the_jax_configs():
    from repro.configs import get_config as jax_get_config
    from repro.configs import list_archs as jax_list_archs

    assert list_archs() == jax_list_archs()
    for arch in list_archs():
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_get_config(arch))
        assert (dataclasses.asdict(smoke_config(arch))
                == dataclasses.asdict(jax_smoke_config(arch)))


def test_param_count_matches_jax(pair):
    _, bundle, _, model = pair
    assert model.num_params() == bundle.num_params()


def test_prefill_logits_and_caches(pair):
    _, bundle, params, model = pair
    tokens = _tokens(model.cfg, 2, 19, seed=3)
    want_logits, want_caches = jax.jit(bundle.prefill)(params, {"tokens": tokens})
    logits, caches = model.prefill(torch.from_numpy(tokens))
    assert logits.shape == (2, model.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    for name in ("k", "v"):
        want = np.asarray(want_caches["g0"]["attn"][name])  # (L, B, S, KV, D)
        got = np.stack([c[name].numpy() for c in caches])
        np.testing.assert_allclose(got, want, **TOL)


def test_serve_step_at_a_cursor(pair):
    _, bundle, params, model = pair
    b, s, extra = 2, 13, 4
    tokens = _tokens(model.cfg, b, s + 1, seed=5)
    _, jcaches = jax.jit(bundle.prefill)(params, {"tokens": tokens[:, :s]})
    jcaches = jax.tree.map(
        lambda c: np.pad(np.asarray(c), [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)]),
        jcaches)
    want_logits, want_caches = jax.jit(bundle.serve_step)(
        params, {"tokens": tokens[:, s:], "pos": np.int32(s), "caches": jcaches})
    _, caches = model.prefill(torch.from_numpy(tokens[:, :s]), cache_len=s + extra)
    logits, caches = model.serve_step(torch.from_numpy(tokens[:, s:]), s, caches)
    assert logits.shape == (b, 1, model.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    for name in ("k", "v"):
        got = np.stack([c[name].numpy() for c in caches])
        np.testing.assert_allclose(got, np.asarray(want_caches["g0"]["attn"][name]), **TOL)


def test_prefill_then_decode_consistency(pair):
    """Prefill of s-1 tokens and one decode step == prefill of s tokens
    (the JAX package's own check, ``tests/test_arch_smoke.py``)."""
    _, _, _, model = pair
    s = 16
    tokens = torch.from_numpy(_tokens(model.cfg, 2, s, seed=4))
    full, _ = model.prefill(tokens)
    _, caches = model.prefill(tokens[:, : s - 1], cache_len=s)
    step, _ = model.serve_step(tokens[:, s - 1:], s - 1, caches)
    np.testing.assert_allclose(step[:, 0].numpy(), full.numpy(), rtol=2e-4, atol=2e-4)


def test_build_model_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(smoke_config("yi-6b"))


def test_weights_from_the_generator_with_the_jax_scales():
    cfg = smoke_config("yi-6b")
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name
    wq = a.layers[0]["attn"]["wq"]
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1) < 0.05
    assert torch.equal(a.layers[1]["ln2"]["w"], torch.ones(cfg.d_model))
    bf = build_model(cfg, device="cpu", dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(5))
    assert torch.equal(bf.top["embed"], a.top["embed"].to(torch.bfloat16))


def test_params_from_jax_checks_the_tree(pair):
    _, _, params, model = pair
    bad = dict(params, embed=params["embed"][:, :3])
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(model, bad)
    with pytest.raises(KeyError, match="not in the JAX tree"):
        params_from_jax(model, {k: v for k, v in params.items() if k != "final_norm"})
    with pytest.raises(KeyError, match="no counterpart"):
        params_from_jax(model, dict(params, extra=np.zeros(3, np.float32)))
    params_from_jax(model, params)  # the fixture's weights, restored


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_norms_match_jax_in_bf16(norm):
    from repro.models import layers as jlayers
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = 1 + 0.1 * rng.standard_normal(64).astype(np.float32)
    b = 0.1 * rng.standard_normal(64).astype(np.float32)
    xj, wj, bj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, b))
    xt, wt, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b))
    if norm == "rms":
        want, got = jlayers.rms_norm(xj, wj), rms_norm(xt, wt)
    else:
        want, got = jlayers.layer_norm(xj, wj, bj), layer_norm(xt, wt, bt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    from repro.models.rope import apply_rope as jax_apply_rope
    import jax.numpy as jnp

    from repro_torch.models.rope import apply_rope

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 128)).astype(np.float32)
    positions = np.stack([np.arange(9), np.arange(100, 109)])
    want = jax_apply_rope(jnp.asarray(x).astype(dtype), jnp.asarray(positions), theta=5e6)
    got = apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                     torch.from_numpy(positions), theta=5e6)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
