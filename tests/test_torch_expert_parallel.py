"""The expert-parallel MoE on a model mesh against the JAX package's
``moe_einsum`` on one device.

Routing is per token and the dispatch per shard, so JAX's expert-parallel
output equals its ``moe_einsum`` run on each (batch shard, sequence chunk)
block alone: the oracle needs no mesh.  The smoke dbrx (softmax top-2) and
llama4-scout (sigmoid top-1, a shared expert) at their capacity factor
1.25, meshed on ``"cpu"`` positions: each MoE layer's block ``buf_tok``
bitwise JAX's ``_dispatch_sorted`` on the block (drops included), the
layer's output and load-balance loss against ``moe_einsum`` on each block;
decode (one token a row) against ``moe_einsum`` over the whole batch; and
``moe_blockwise_reference``, the one-device plain version of the meshed
semantics.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from torch_train_cases import jax_pair

from repro_torch.dist import make_mesh
from repro_torch.models import moe, transformer
from repro_torch.models.model import shard_params

TOL = dict(rtol=1e-5, atol=1e-5)


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * 4)


def _jax_moe_params(params, layer):
    return {k: jnp.asarray(v[layer]) for k, v in params["g0"]["moe"].items()}


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("shape,fsdp", [((1, 2), False), ((1, 4), False), ((2, 2), False),
                                        ((2, 2), True)], ids=str)
def test_expert_parallel_blocks_match_jax(arch, shape, fsdp):
    """At capacity factor 1.25: each MoE layer's blocks against JAX
    ``moe_einsum`` on the block; with ``fsdp`` the experts' d_ff lies on
    ``data`` (the ``ff_axis`` level: tokens gathered over ``data``, the
    partial outputs psum-scattered), held as the JAX package's
    ``md_moe`` holds it (``rtol=2e-4, atol=2e-5``)."""
    bundle, params, model = jax_pair(arch, capacity_factor=1.25, fsdp=fsdp)
    cfg, jcfg = model.cfg, bundle.cfg
    tol = dict(rtol=2e-4, atol=2e-5) if fsdp else TOL
    meshed = shard_params(model, _mesh(shape))
    n_data, ep = shape
    seen = []
    inner = moe.moe_apply

    def capture(m, pre, hs, record=None):
        rec = []
        ys, aux = inner(m, pre, hs, rec)
        seen.append((hs, rec, ys, aux))
        return ys, aux

    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 128)))
    transformer.moe_mod.moe_apply = capture
    try:
        meshed.prefill(toks)
    finally:
        transformer.moe_mod.moe_apply = inner
    assert len(seen) == cfg.num_layers
    ctx = meshed.ctx
    sl = 128 // ep
    dropped = 0
    for layer, (hs, rec, ys, aux) in enumerate(seen):
        p = _jax_moe_params(params, layer)
        block_aux = []
        for i in range(ctx.n):
            j = ctx.model_index[i]
            x = jnp.asarray(hs[i][:, j * sl:(j + 1) * sl].numpy())
            x2d = x.reshape(-1, cfg.d_model)
            ids, gates, _ = jmoe._route(x2d, p["router"], cfg.experts_per_token,
                                        cfg.router_softmax_topk)
            cap = jmoe._capacity(x2d.shape[0], cfg.experts_per_token, cfg.num_experts,
                                 cfg.capacity_factor)
            buf_tok, _ = jmoe._dispatch_sorted(ids, gates, x2d.shape[0], cfg.num_experts, cap)
            np.testing.assert_array_equal(rec[i]["buf_tok"].numpy(), np.asarray(buf_tok))
            want_y, want_aux = jmoe.moe_einsum(p, x, cfg=jcfg)
            np.testing.assert_allclose(ys[i][:, j * sl:(j + 1) * sl].numpy(),
                                       np.asarray(want_y), err_msg=f"layer {layer}", **tol)
            block_aux.append(float(want_aux))
            dropped += rec[i]["dropped"]
        for a in aux:
            np.testing.assert_allclose(float(a), np.mean(block_aux), **TOL)
    print(f"{arch} {shape}: {dropped} slots dropped over {cfg.num_layers} layers")


def test_moe_decode_runs_moe_einsum_over_the_whole_batch():
    """S = 1: one routing and dispatch over every row; each position runs
    its experts (and, with ``fsdp``, its d_ff slice), partials summed."""
    for fsdp in (False, True):
        bundle, params, model = jax_pair("dbrx-132b", capacity_factor=1.25, fsdp=fsdp)
        meshed = shard_params(model, _mesh((2, 2)))
        x = (0.5 * np.random.default_rng(8).standard_normal((4, 1, model.cfg.d_model))
             ).astype(np.float32)
        ys, aux = moe.moe_apply(meshed, "layers.1.moe.", meshed.ctx.split_batch(
            torch.from_numpy(x)))
        want_y, want_aux = jmoe.moe_einsum(_jax_moe_params(params, 1), jnp.asarray(x),
                                           cfg=bundle.cfg)
        got = meshed.ctx.gather_batch(ys, "cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want_y), **TOL)
        assert all(abs(float(a) - float(want_aux)) < 1e-6 for a in aux)


def test_blockwise_reference_is_moe_einsum_a_block():
    bundle, params, model = jax_pair("dbrx-132b", capacity_factor=1.25)
    cfg = model.cfg
    x = torch.from_numpy((0.5 * np.random.default_rng(9).standard_normal(
        (4, 32, cfg.d_model))).astype(np.float32))
    p = model.layers[0]["moe"]
    y, aux = moe.moe_blockwise_reference(p, x, cfg, 2, 4)
    for i, j in np.ndindex(2, 4):
        blk = (slice(2 * i, 2 * i + 2), slice(8 * j, 8 * j + 8))
        want, _ = moe.moe_einsum(p, x[blk], cfg=cfg)
        assert torch.equal(y[blk], want)
    assert torch.equal(moe.moe_blockwise_reference(p, x[:, :1], cfg, 2, 4)[0],
                       moe.moe_einsum(p, x[:, :1], cfg=cfg)[0])
