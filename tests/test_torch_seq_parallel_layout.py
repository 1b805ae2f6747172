"""Where the sequence-parallel residual applies: each position's residual
between blocks against JAX's rule, and SP on against SP off.

For the dense, MoE, VLM, SSM, hybrid and encoder-decoder smoke configs on
(1, 2), (1, 4) and (2, 2) meshes of ``"cpu"`` positions, every block of a
prefill and of a training forward is walked (``recorded_residuals``): each
position holds ``(B / n_batch, S / tp, d)`` exactly where JAX's
``RunCtx(...).axes()`` (on a ``SimpleNamespace`` mesh) and
``constrain_residual``'s rule put the sequence on ``model`` (S above 1 and
dividing by the ``model`` extent; the ``emb`` spec of JAX's
``input_shardings`` agrees), the whole sequence elsewhere: at S = 1 (a
decode step), at S = 10 on tp = 4, and with the flag off.  whisper's
encoder is held at 24 frames and at 22 (whole at tp = 4).  The
``embeds`` block ``split_inputs`` hands a position is ``input_shardings``'
block.  SP on and SP off give equal prefill logits, caches and decode
steps on one mesh, within float rounding (``1e-5``).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_sp_cases import B, ENC, MESHES, mesh, recorded_residuals, sp_overrides
from torch_train_cases import batch_for, torch_batch
from torch_train_cases import one_torch_thread  # noqa: F401  (autouse)

from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.models.model import build_model as jax_build_model
from repro.models.transformer import RunCtx as JaxRunCtx

from repro_torch.configs import smoke_config
from repro_torch.models import build_model
from repro_torch.models.model import gather_caches, shard_params

ARCHS = ["yi-6b", "dbrx-132b", "qwen2-vl-2b", "mamba2-1.3b", "jamba-1.5-large-398b",
         "whisper-tiny"]


def jax_seq_axis(arch, over, shape, s):
    """The axis JAX's ``constrain_residual`` puts a residual of ``s``
    positions on: ``RunCtx.axes()``'s sequence axis, dropped at ``s`` = 1
    and where ``s`` does not divide by its extent."""
    cfg = dataclasses.replace(jax_smoke_config(arch), **over)
    ns = SimpleNamespace(shape={"data": shape[0], "model": shape[1]})
    ba, sa = JaxRunCtx(cfg, ns).axes()
    assert ba == ("data",)
    if s == 1 or (sa is not None and s % ns.shape[sa]):
        sa = None
    if s > 1:  # the embeddings' spec JAX's input_shardings give the cell
        specs = jax_build_model(cfg, ns).input_shardings(JaxShapeConfig("cell", s, B, "train"))
        emb = specs.get("enc_embeds", specs.get("embeds"))
        if emb is not None:
            assert emb[1] == sa
    return sa


def want_shapes(arch, over, shape, s, d):
    rows = B // shape[0]
    sa = jax_seq_axis(arch, over, shape, s)
    return [(rows, s // shape[1] if sa else s, d)] * (shape[0] * shape[1]), sa


def prefill_args(cfg, s, enc, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, s)))
    if cfg.is_encdec:
        return (torch.from_numpy((0.5 * rng.standard_normal((B, enc, cfg.d_model)))
                                 .astype(np.float32)), toks), {}
    if cfg.mrope_sections:
        return (), dict(embeds=torch.from_numpy((0.5 * rng.standard_normal(
            (B, s, cfg.d_model))).astype(np.float32)))
    return (toks,), {}


def _model(arch, over):
    return build_model(dataclasses.replace(smoke_config(arch), **over), device="cpu",
                       dtype=torch.float32)


def _hold(seen, arch, over, shape, s, enc, d):
    """Every recorded block input against JAX's rule -> the axes seen."""
    axes = set()
    assert seen
    for stack, layer, shapes in seen:
        length = enc if stack == "enc" else s
        want, sa = want_shapes(arch, over, shape, length, d)
        assert shapes == want, (stack, layer, length)
        axes.add(sa)
    return axes


@pytest.mark.parametrize("sp", [True, False], ids=["sp", "sp-off"])
@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_residual_layout_is_jaxs(arch, shape, sp):
    over = sp_overrides(arch, seq_shard_activations=sp)
    model = _model(arch, over)
    meshed = shard_params(model, mesh(shape))
    d = model.cfg.d_model
    for s, enc in ((32, ENC), (10, 22)):
        args, kw = prefill_args(model.cfg, s, enc)
        with recorded_residuals([]) as seen:
            _, caches = meshed.prefill(*args, cache_len=s + 1, **kw)
        axes = _hold(seen, arch, over, shape, s, enc, d)
        if sp and s == 32:
            assert axes == {"model"}
        if not sp:
            assert axes == {None}
        # a decode step: one position, the residual whole
        with recorded_residuals([]) as seen:
            meshed.serve_step(args[-1][:, :1] if args else torch.zeros((B, 1), dtype=torch.long),
                              s, caches)
        _hold([x for x in seen if x[0] != "enc"], arch, over, shape, 1, 1, d)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_training_residual_and_input_blocks_are_jaxs(arch, shape):
    over = sp_overrides(arch)
    model = _model(arch, over)
    meshed = shard_params(model, mesh(shape))
    d = model.cfg.d_model
    for s in (32, 10):
        batch = torch_batch(batch_for(model.cfg, B, s, seed=1))
        with torch.no_grad(), recorded_residuals([]) as seen:
            loss, _ = meshed.train_loss(batch)
        assert torch.isfinite(loss)
        _hold(seen, arch, over, shape, s, s, d)
        if "embeds" in batch:  # input_shardings' emb block
            blocks, _ = want_shapes(arch, over, shape, s, d)
            parts = meshed.split_inputs(batch)
            assert [tuple(p["embeds"].shape) for p in parts] == blocks
            assert [tuple(p["positions"].shape) for p in parts] == [(B // shape[0], s, 3)] * len(
                parts)


@pytest.mark.parametrize("arch", ARCHS)
def test_sp_on_and_off_give_equal_logits_and_caches(arch):
    over = sp_overrides(arch)
    model = _model(arch, over)
    on = shard_params(model, mesh((1, 4)))
    off = on.with_seq_shard(False)
    assert off.cfg == dataclasses.replace(on.cfg, seq_shard_activations=False)
    assert off.ctx.act_seq is None and on.ctx.act_seq == "model"
    args, kw = prefill_args(model.cfg, 32, ENC, seed=2)
    got_on, caches_on = on.prefill(*args, cache_len=33, **kw)
    got_off, caches_off = off.prefill(*args, cache_len=33, **kw)
    tol = dict(rtol=1e-4, atol=1e-4) if model.cfg.family == "hybrid" else dict(rtol=1e-5,
                                                                              atol=1e-5)
    torch.testing.assert_close(got_on, got_off, **tol)
    for a, b in zip(gather_caches(on, caches_on), gather_caches(off, caches_off)):
        for key in b:
            torch.testing.assert_close(a[key], b[key], **tol)
    step = args[-1][:, -1:] if args else torch.zeros((B, 1), dtype=torch.long)
    torch.testing.assert_close(on.serve_step(step, 32, caches_on)[0],
                               off.serve_step(step, 32, caches_off)[0], **tol)
