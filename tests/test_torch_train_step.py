"""The port's AdamW and train step vs the JAX package's
(``repro.train.optimizer``, ``repro.train.train_step``), and the port's
data-parallel step vs its own microbatched step.

Tolerances.  ``warmup_cosine`` and one ``adamw_update`` on the same numpy
trees agree within float32 rounding (``rtol=1e-6``; bfloat16 moments to
one bf16 rounding).  Over several steps AdamW moves a weight by about
``±lr`` whatever its gradient's size, so a near-zero gradient whose sign
the two packages round differently moves it by up to ``2 lr`` apart: every
element is held to ``2 * sum(lr)`` over the steps (``sign_flip_bound``), and
all but ``OFF_FRACTION`` of each leaf's elements to ``PARAM_ATOL``.  The key
biases are exempt from the second rule: their gradient is zero in exact
arithmetic (the softmax cancels a key bias), so AdamW normalises rounding
noise there (measured: 19.5% of qwen's ``bk`` beyond 1e-6, at most 2.3e-5).
Losses within ``rtol=1e-5``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.sources import SyntheticTokenSource as JaxTokenSource
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.optimizer import adamw_update as jax_adamw_update
from repro.train.optimizer import warmup_cosine as jax_warmup_cosine
from repro.train.train_step import TrainState as JaxTrainState
from repro.train.train_step import make_train_step as jax_make_train_step

from repro_torch.dist import make_mesh
from repro_torch.models.convert import params_to_jax
from repro_torch.train import (
    AdamWConfig,
    TrainState,
    adamw_init,
    adamw_update,
    make_train_step,
    train_state_shapes,
    warmup_cosine,
)
from repro_torch.train.train_step import decay_mask

from torch_train_cases import jax_pair

PARAM_ATOL = 1e-6
OFF_FRACTION = 1e-3
LOSS_RTOL = 1e-5


def test_warmup_cosine_matches_jax():
    steps = np.arange(0, 40, dtype=np.int32)
    for peak, warm, total in ((3e-4, 5, 30), (1e-3, 0, 10), (2e-3, 20, 20)):
        want = np.asarray(jax_warmup_cosine(peak, warm, total)(jnp.asarray(steps)))
        got = warmup_cosine(peak, warm, total)(torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _tree(seed):
    rng = np.random.default_rng(seed)
    # keys in sorted order: JAX's leaf order, the global norm's sum order
    return {"a_matrix": rng.standard_normal((16, 8)).astype(np.float32),
            "b_bias": rng.standard_normal((8,)).astype(np.float32),
            "c_stack": rng.standard_normal((2, 4, 4)).astype(np.float32) * 3,
            "d_norm": (1 + 0.1 * rng.standard_normal((16,))).astype(np.float32)}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment_dtype):
    params, grads = _tree(0), _tree(1)
    jcfg = JaxAdamWConfig(learning_rate=jax_warmup_cosine(1e-2, 2, 10),
                          moment_dtype=moment_dtype, grad_clip_norm=5.0)
    tcfg = AdamWConfig(learning_rate=warmup_cosine(1e-2, 2, 10), moment_dtype=moment_dtype,
                       grad_clip_norm=5.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jopt, topt = jax_adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for step in range(3):  # the moments and the count carry across steps
        g = _tree(10 + step)
        jp, jopt, jm = jax_adamw_update({k: jnp.asarray(v) for k, v in g.items()}, jopt, jp, jcfg)
        tp, topt, tm = adamw_update({k: torch.from_numpy(v) for k, v in g.items()}, topt, tp,
                                    tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])
        assert int(topt["count"]) == int(jopt["count"]) == step + 1
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            for mom in ("m", "v"):
                got, want = topt[mom][k], jopt[mom][k]
                assert str(got.dtype) == f"torch.{moment_dtype}"
                rtol = 1e-6 if moment_dtype == "float32" else 2 ** -8
                np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                           rtol=rtol, atol=1e-12)


def test_decay_mask_follows_the_jax_stacked_layout():
    _, _, model = jax_pair("qwen1.5-0.5b")
    mask = decay_mask(model)
    assert mask["layers.0.ln1.w"] and mask["layers.1.attn.bq"]  # (L, d) in JAX
    assert mask["top.embed"] and mask["top.unembed"] and mask["layers.0.mlp.up"]
    assert not mask["top.final_norm.w"]


def _batches(vocab, b, s, steps):
    src = JaxTokenSource(b, s, vocab, seed=0)
    return [{"tokens": src.block(i, 0, b)[:, :s], "targets": src.block(i, 0, b)[:, 1:]}
            for i in range(steps)]


def sign_flip_bound(lrs):
    return 2 * sum(lrs) + PARAM_ATOL


def hold_params(got, want, lrs):
    bound = sign_flip_bound(lrs)
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for p in path:
            node = node[p.key]
        name = "/".join(p.key for p in path)
        d = np.abs(node.numpy() - np.asarray(w))
        assert d.max() <= bound, (name, d.max(), bound)
        if not name.endswith("bk"):
            assert (d > PARAM_ATOL).mean() <= OFF_FRACTION, (name, (d > PARAM_ATOL).mean())


def _run_both(arch, steps, **overrides):
    bundle, params, model = jax_pair(arch, **overrides)
    jcfg = JaxAdamWConfig(learning_rate=jax_warmup_cosine(1e-3, 2, 10))
    tcfg = AdamWConfig(learning_rate=warmup_cosine(1e-3, 2, 10))
    jstep = jax.jit(jax_make_train_step(bundle, jcfg))
    tstep = make_train_step(model, tcfg)
    js = JaxTrainState.create(jax.tree.map(jnp.asarray, params), jcfg)
    ts = TrainState.create(model.flat_params(), tcfg)
    lrs = []
    for batch in _batches(bundle.cfg.vocab_size, 4, 32, steps):
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("total_loss", "loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=LOSS_RTOL,
                                       err_msg=key)
        assert float(tm["lr"]) == float(jm["lr"])
        lrs.append(float(jm["lr"]))
    assert int(ts.step) == int(js.step) == steps
    hold_params(params_to_jax(model, ts.params), js.params, lrs)
    for mom in ("m", "v"):
        got = params_to_jax(model, ts.opt[mom])
        for path, w in jax.tree_util.tree_flatten_with_path(js.opt[mom])[0]:
            node = got
            for p in path:
                node = node[p.key]
            w = np.asarray(w)
            np.testing.assert_allclose(node.numpy(), w, rtol=1e-3,
                                       atol=1e-4 * np.abs(w).max() + 1e-12)
    return model, ts


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama4-scout-17b-a16e"])
def test_three_step_trajectory_matches_jax(arch):
    _run_both(arch, 3)


def test_microbatches_match_jax():
    _run_both("dbrx-132b", 2, microbatches=2)


def test_two_position_data_parallel_step_is_bitwise_the_microbatched_step():
    """Two positions each take half the rows; their gradients are summed in
    mesh order and halved: bitwise the one-device step that splits the
    same rows into two microbatches."""
    _, _, model = jax_pair("qwen1.5-0.5b")
    cfg = AdamWConfig(learning_rate=warmup_cosine(1e-3, 1, 10))
    mesh = make_mesh((2,), ("data",), devices=["cpu"] * 2)
    dp = make_train_step(model, cfg, mesh=mesh)
    _, _, twin = jax_pair("qwen1.5-0.5b", microbatches=2)  # the same weights
    micro = make_train_step(twin, cfg)
    a = b = TrainState.create(model.flat_params(), cfg)
    for batch in _batches(model.cfg.vocab_size, 4, 32, 2):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        a, ma = dp(a, batch)
        b, mb = micro(b, batch)
        assert torch.equal(ma["total_loss"], mb["total_loss"])
        assert torch.equal(ma["grad_norm"], mb["grad_norm"])
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.opt["m"][k], b.opt["m"][k]) and torch.equal(a.opt["v"][k],
                                                                         b.opt["v"][k])


def test_train_state_shapes_allocate_nothing():
    _, _, model = jax_pair("mamba2-1.3b")
    like = train_state_shapes(model, AdamWConfig(moment_dtype="bfloat16"))
    for k, p in model.named_parameters():
        assert like.params[k].is_meta and like.params[k].shape == p.shape
        assert like.opt["m"][k].dtype == torch.bfloat16 and like.opt["v"][k].is_meta
    assert like.step.dtype == torch.int32 and like.opt["count"].is_meta
