"""Shared cases of the sequence-parallel residual tests (imported by the
``test_torch_seq_parallel*.py`` files).

Every case is a smoke config with ``seq_shard_activations=True`` (the
smoke configs turn it off; the published ones leave JAX's default on), in
float32, the JAX weights loaded with ``params_from_jax`` and laid out on
meshes of ``"cpu"`` positions, ``(data, model)`` = (1, 2), (1, 4) and
(2, 2).  JAX's oracle is its single-device bundle, as in the other
model-mesh tests (its own 8-device tests fail in the driver's runs).  The
MoE and hybrid archs run at ``capacity_factor=8.0``: no slot is dropped,
so the expert-parallel blocks (each position's sequence slice) give the
whole batch's outputs.

``recorded_residuals`` records the residual each position holds between
blocks: the input of every meshed decoder block (``mesh_block_apply``) and
of every encoder and decoder layer of the encoder-decoder model.
"""

import contextlib

import jax
import numpy as np
import torch

from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from test_torch_families import _jax_caches_by_layer, _pad_self_kv
from torch_train_cases import jax_pair, smoke_configs

from repro_torch.dist import make_mesh
from repro_torch.models import model as model_mod
from repro_torch.models.encdec import MeshEncDecLM
from repro_torch.models.model import gather_caches

SP = dict(seq_shard_activations=True)
MESHES = [(1, 2), (1, 4), (2, 2)]
TOL = dict(rtol=1e-5, atol=1e-5)
HYBRID_TOL = dict(rtol=1e-4, atol=1e-4)
ROOMY = 8.0  # capacity factor at which no smoke MoE layer drops a slot
B, S, EXTRA = 4, 32, 3  # the prefill (S: one SSD chunk, divides by 2 and 4), a step's slots
ENC = 24  # whisper's encoder frames: divide by 2 and 4
# greedy waves: 32 divides by every tp, 10 by 2 only (at tp = 4 the residual stays whole)
LENGTHS, NEWS = [32, 10, 32, 10], [5, 4, 3, 5]


def mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * 4)


def sp_overrides(arch, **over) -> dict:
    """SP on, and the MoE archs at the roomy capacity (``arch``: a case of
    ``smoke_configs``)."""
    fam = smoke_configs(arch)[1].family
    roomy = dict(capacity_factor=ROOMY, microbatches=1) if fam in ("moe", "hybrid") else {}
    return {**SP, **roomy, **over}


def sp_pair(arch, **over):
    """(JAX bundle, its params, the port model) of ``arch``'s smoke config with SP."""
    return jax_pair(arch, **sp_overrides(arch, **over))


def tol(cfg) -> dict:
    return HYBRID_TOL if cfg.family == "hybrid" else TOL


def inputs(cfg, b, s, seed):
    """-> (JAX prefill batch, port prefill args, port prefill kwargs)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        frames = (0.5 * rng.standard_normal((b, ENC, cfg.d_model))).astype(np.float32)
        toks = rng.integers(0, cfg.vocab_size, (b, s))
        return ({"enc_embeds": frames, "dec_tokens": toks.astype(np.int32)},
                (torch.from_numpy(frames), torch.from_numpy(toks)), {})
    if cfg.mrope_sections:
        embeds = (0.5 * rng.standard_normal((b, s, cfg.d_model))).astype(np.float32)
        grid = rng.integers(0, 8, (b, s, 2))
        pos = np.concatenate([np.broadcast_to(np.arange(s), (b, s))[..., None], grid], -1)
        return ({"embeds": embeds, "positions": pos.astype(np.int32)}, (),
                dict(embeds=torch.from_numpy(embeds), positions=torch.from_numpy(pos)))
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    return {"tokens": toks.astype(np.int32)}, (torch.from_numpy(toks),), {}


def serve_want(bundle, params, model) -> dict:
    """JAX's prefill of (B, S), a decode step at S, and the greedy tokens
    over ``LENGTHS`` (the JAX engine's; whisper's from the port's one-device
    ``greedy``: JAX's engine refuses it)."""
    cfg = model.cfg
    batch, args, kw = inputs(cfg, B, S, seed=3)
    logits, caches = jax.jit(bundle.prefill)(params, batch)
    caches = _pad_self_kv(model, caches, EXTRA)
    step = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 1))
    step_logits, step_caches = jax.jit(bundle.serve_step)(
        params, {"tokens": step.astype(np.int32), "pos": np.int32(S), "caches": caches})
    want = dict(args=args, kw=kw, logits=np.asarray(logits), caches=caches, step=step,
                step_logits=np.asarray(step_logits), step_caches=step_caches)
    rng = np.random.default_rng(0)
    if cfg.is_encdec:
        frames = torch.from_numpy((0.5 * rng.standard_normal((B, ENC, cfg.d_model)))
                                  .astype(np.float32))
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 4)))
        want["greedy"] = (frames, prompt, model.greedy(frames, prompt, 5)[0])
    else:
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in LENGTHS]
        tokens = JaxServeEngine(bundle, params).serve(
            [JaxRequest(p, n) for p, n in zip(prompts, NEWS)])
        want["greedy"] = (prompts, tokens)
    return want


def hold_caches(model, got, want_tree, tolerance):
    want = _jax_caches_by_layer(model, want_tree)
    assert len(got) == len(want)
    for layer, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), layer
        for name in w:
            np.testing.assert_allclose(g[name].numpy(), w[name], err_msg=f"{layer}.{name}",
                                       **tolerance)


def hold_serve(model, meshed, want):
    """The meshed prefill's logits and gathered caches, then a decode
    step's, against JAX's and the port's one-device model's."""
    t, args, kw = tol(model.cfg), want["args"], want["kw"]
    one, one_caches = model.prefill(*args, cache_len=S + EXTRA, **kw)
    got, caches = meshed.prefill(*args, cache_len=S + EXTRA, **kw)
    assert got.shape == (B, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want["logits"], **t)
    np.testing.assert_allclose(got.numpy(), one.numpy(), **t)
    hold_caches(model, gather_caches(meshed, caches), want["caches"], t)
    step = torch.from_numpy(want["step"])
    got_step, caches = meshed.serve_step(step, S, caches)
    one_step, _ = model.serve_step(step, S, one_caches)
    assert got_step.shape == (B, 1, model.cfg.vocab_size)
    np.testing.assert_allclose(got_step.numpy(), want["step_logits"], **t)
    np.testing.assert_allclose(got_step.numpy(), one_step.numpy(), **t)
    hold_caches(model, gather_caches(meshed, caches), want["step_caches"], t)


@contextlib.contextmanager
def recorded_residuals(seen: list):
    """While open, every meshed block's input residual goes to ``seen`` as
    ``(stack, layer, [each position's shape])``, in call order (``stack``:
    ``"decoder"`` for a decoder-only model's blocks, ``"enc"`` / ``"dec"``
    for the encoder-decoder's layers)."""
    inner = model_mod.mesh_block_apply
    enc, dec = MeshEncDecLM._enc_layer, MeshEncDecLM._dec_layer

    def block(m, l, xs, *args, **kw):
        seen.append(("decoder", l, [tuple(x.shape) for x in xs]))
        return inner(m, l, xs, *args, **kw)

    def enc_layer(self, i, xs, *args):
        seen.append(("enc", i, [tuple(x.shape) for x in xs]))
        return enc(self, i, xs, *args)

    def dec_layer(self, i, xs, *args):
        seen.append(("dec", i, [tuple(x.shape) for x in xs]))
        return dec(self, i, xs, *args)

    model_mod.mesh_block_apply = block
    MeshEncDecLM._enc_layer, MeshEncDecLM._dec_layer = enc_layer, dec_layer
    try:
        yield seen
    finally:
        model_mod.mesh_block_apply = inner
        MeshEncDecLM._enc_layer, MeshEncDecLM._dec_layer = enc, dec

