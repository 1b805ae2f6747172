"""Serving the SSM, hybrid and encoder-decoder families on a model mesh:
repro_torch's meshed mamba2, jamba and whisper vs the JAX package.

The smoke configs, in float32: the JAX weights (biases, norms and the SSM's
``dt_bias`` / ``a_log`` / ``d_skip`` perturbed off their init) loaded with
``params_from_jax``, then ``shard_params`` onto meshes of ``"cpu"``
positions, ``(data, model)`` = (1, 2), (1, 4) and (2, 2).  JAX's oracle is
its single-device ``ModelBundle``.  The row-parallel sums and the gated
norm's sum of squares add their partials in mesh order, so the meshed
model is held within ``1e-5``, never bitwise; jamba's eight-layer superblock within ``1e-4``
(its tolerance in ``test_torch_families.py``), at ``capacity_factor=8.0``
(no slot dropped: the expert-parallel prefill's per-block capacities give
the one-device outputs).

Also: greedy ``ServeEngine`` tokens equal the JAX engine's (whisper's the
port's one-device ``greedy``: JAX's engine refuses it), ``gather_params``
inverts ``shard_params`` bit for bit, a Mamba config whose ``d_inner``
divides by the model extent but whose SSM heads do not, whisper with six
heads at tp = 4, every cache leaf each position holds against the blocks
of ``cache_specs`` (JAX's ``_cache_specs``), and the refusals a meshed model
keeps: the SSD's prompt length, the conv window, an encoder-decoder engine.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.model import build_model as jax_build_model
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from test_torch_families import _jax_caches_by_layer, _pad_self_kv
from test_torch_mesh_caches import jax_block_shape
from torch_train_cases import jax_pair
from torch_train_cases import one_torch_thread  # noqa: F401  (autouse)

from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import make_mesh
from repro_torch.dist.sharding import shard_slices
from repro_torch.models import build_model
from repro_torch.models.model import gather_caches, gather_params, shard_params
from repro_torch.serve import Request, ServeEngine

ARCHS = ["mamba2-1.3b", "jamba-1.5-large-398b", "whisper-tiny"]
MESHES = [(1, 2), (1, 4), (2, 2)]
TOL = dict(rtol=1e-5, atol=1e-5)
HYBRID_TOL = dict(rtol=1e-4, atol=1e-4)
ROOMY = 8.0  # capacity factor at which no smoke MoE layer drops a slot
B, S, EXTRA = 4, 32, 3  # the prefill held to JAX (one SSD chunk), the slots a step needs
ENC = 24  # whisper's encoder frames
LENGTHS, NEWS = [32, 9, 32, 9], [5, 4, 3, 5]  # greedy waves: a whole chunk, a short prompt


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * 4)


def _tol(cfg):
    return HYBRID_TOL if cfg.family == "hybrid" else TOL


def _inputs(cfg, b, s, seed):
    """-> (JAX prefill batch, port prefill args)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    if cfg.is_encdec:
        frames = (0.5 * rng.standard_normal((b, ENC, cfg.d_model))).astype(np.float32)
        return ({"enc_embeds": frames, "dec_tokens": toks.astype(np.int32)},
                (torch.from_numpy(frames), torch.from_numpy(toks)))
    return {"tokens": toks.astype(np.int32)}, (torch.from_numpy(toks),)


def _jax_run(bundle, params, model, b, s, seed=3):
    """JAX's prefill of (b, s) and a decode step at s -> dict of numpy."""
    cfg = model.cfg
    batch, args = _inputs(cfg, b, s, seed)
    logits, caches = jax.jit(bundle.prefill)(params, batch)
    caches = _pad_self_kv(model, caches, EXTRA)  # the self-attention slots the step writes
    step = np.random.default_rng(4).integers(0, cfg.vocab_size, (b, 1))
    step_logits, step_caches = jax.jit(bundle.serve_step)(
        params, {"tokens": step.astype(np.int32), "pos": np.int32(s), "caches": caches})
    return dict(args=args, logits=np.asarray(logits), caches=caches, step=step,
                step_logits=np.asarray(step_logits), step_caches=step_caches)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(the JAX outputs, the port's one-device model with the JAX weights):
    prefill and a decode step, and the greedy tokens over ``LENGTHS`` (the
    JAX engine's; whisper's from the port's one-device ``greedy``)."""
    over = dict(capacity_factor=ROOMY) if request.param.startswith("jamba") else {}
    bundle, params, model = jax_pair(request.param, **over)
    want = _jax_run(bundle, params, model, B, S)
    cfg = model.cfg
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
    return want, model


def _hold_caches(model, got, want_tree, tol):
    want = _jax_caches_by_layer(model, want_tree)
    assert len(got) == len(want)
    for layer, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), layer
        for name in w:
            np.testing.assert_allclose(g[name].numpy(), w[name], err_msg=f"{layer}.{name}",
                                       **tol)


def _hold_to_jax(model, meshed, want):
    """The meshed prefill's logits and gathered caches, then a decode step's,
    against JAX's and the port's one-device model's."""
    tol, args = _tol(model.cfg), want["args"]
    one, one_caches = model.prefill(*args, cache_len=S + EXTRA)
    got, caches = meshed.prefill(*args, cache_len=S + EXTRA)
    assert got.shape == (B, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want["logits"], **tol)
    np.testing.assert_allclose(got.numpy(), one.numpy(), **tol)
    _hold_caches(model, gather_caches(meshed, caches), want["caches"], tol)
    step = torch.from_numpy(want["step"])
    got_step, caches = meshed.serve_step(step, S, caches)
    one_step, _ = model.serve_step(step, S, one_caches)
    assert got_step.shape == (B, 1, model.cfg.vocab_size)
    np.testing.assert_allclose(got_step.numpy(), want["step_logits"], **tol)
    np.testing.assert_allclose(got_step.numpy(), one_step.numpy(), **tol)
    _hold_caches(model, gather_caches(meshed, caches), want["step_caches"], tol)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_prefill_caches_and_step_match_jax(pair, shape):
    want, model = pair
    _hold_to_jax(model, shard_params(model, _mesh(shape)), want)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_greedy_tokens_equal_the_reference(pair, shape):
    want, model = pair
    meshed = shard_params(model, _mesh(shape))
    if model.cfg.is_encdec:
        frames, prompt, tokens = want["greedy"]
        got, stats = meshed.greedy(frames, prompt, 5)
        assert torch.equal(got, tokens) and stats["decode_steps"] == 4
        return
    prompts, tokens = want["greedy"]
    engine = ServeEngine(meshed)
    assert engine.serve([Request(p, n) for p, n in zip(prompts, NEWS)]) == tokens
    assert [(w["batch"], w["prompt_len"]) for w in engine.stats] == [(2, 9), (2, 32)]


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_gather_params_inverts_shard_params_bitwise(pair, shape):
    _, model = pair
    meshed = shard_params(model, _mesh(shape))
    whole = gather_params(meshed)
    assert set(whole) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        assert torch.equal(whole[name], p), name
    assert meshed.num_params() == model.num_params()


def _held_blocks(model, meshed, caches, cell):
    """Each position's cache leaves against the blocks ``cache_specs``
    gives it (every leaf: ``k``, ``v``, ``xk``, ``xv`` and the Mamba
    state); -> the leaves held."""
    specs, gathered = model.cache_specs(cell), gather_caches(meshed, caches)
    held = []
    for i, pos_caches in enumerate(caches):
        coords = meshed.ctx.coords[i]
        for layer, (got, layer_specs) in enumerate(zip(pos_caches, specs)):
            for name, t in got.items():
                whole, spec = list(gathered[layer][name].shape), layer_specs[name]
                block = shard_slices(meshed.mesh, coords, spec, whole)
                want = [len(range(*s.indices(n))) for s, n in zip(block, whole)]
                assert list(t.shape) == want, (i, layer, name, tuple(spec))
                held.append(name)
    return held


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=str)
def test_ff_and_ssm_heads_divide_differently(shape):
    """``d_model=96``: ``d_inner`` 192 and 6 SSM heads.  At tp = 4 the rules
    shard ``in_x``, ``conv_x``, ``norm`` and ``out``'s rows (48 channels a
    position, 1.5 heads) and replicate ``in_dt``, ``dt_bias``, ``a_log``,
    ``d_skip``: each position gathers the convolved ``x``, runs every
    head and keeps its channels; its cache holds every head's ``state``
    and its channels of ``conv_x`` (JAX's ``_cache_specs``: ``h_ax`` None,
    ``c_ax`` ``model``).  At tp = 2 both divide (3 heads a position)."""
    bundle, params, model = jax_pair("mamba2-1.3b", d_model=96)
    mesh = _mesh(shape)
    skeleton = build_model(model.cfg, device="meta", mesh=mesh)
    specs = skeleton.specs()
    tp = shape[1]
    assert specs["layers.0.ssm.in_x"][1] == "model"
    assert specs["layers.0.ssm.in_dt"][1] == ("model" if tp == 2 else None)
    want = _jax_run(bundle, params, model, B, S)
    meshed = shard_params(model, mesh)
    _hold_to_jax(model, meshed, want)
    _, caches = meshed.prefill(*want["args"])
    assert caches[0][0]["state"].shape[1] == (3 if tp == 2 else 6)
    assert caches[0][0]["conv_x"].shape[2] == 192 // tp
    cell = ShapeConfig("decode", S, B, "decode")
    jcache = _jax_bundle_on(bundle.cfg, shape)._cache_specs(cell)["g0"]["ssm"]
    port = skeleton.cache_specs(cell)[0]
    assert {k: tuple(v) for k, v in port.items()} == {k: tuple(v)[1:] for k, v in jcache.items()}
    assert sorted(set(_held_blocks(skeleton, meshed, caches, cell))) == \
        ["conv_b", "conv_c", "conv_x", "state"]


def _jax_bundle_on(cfg, shape):
    """JAX's bundle on a stand-in mesh of ``shape`` (its spec methods read
    only ``mesh.shape``)."""
    return jax_build_model(cfg, SimpleNamespace(shape={"data": shape[0], "model": shape[1]}))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=str)
def test_whisper_heads_the_model_axis_does_not_divide(shape):
    """Six heads (whisper-tiny's count): at tp = 4 every position computes
    every head of the encoder and both decoder attentions, ``wq``'s 192
    columns and ``wo``'s rows still sharded, and its caches hold all six
    KV heads of its quarter of the sequence (JAX's ``_cache_specs``: the
    heads do not divide, so the sequence goes over ``model``); at tp = 2
    three heads a position, the whole sequence.  Each leaf is the block
    JAX's ``NamedSharding.shard_shape`` gives it."""
    bundle, params, model = jax_pair("whisper-tiny", num_heads=6, num_kv_heads=6)
    want = _jax_run(bundle, params, model, B, S)
    meshed = shard_params(model, _mesh(shape))
    _hold_to_jax(model, meshed, want)
    _, caches = meshed.prefill(*want["args"])
    cell = ShapeConfig("decode", S, B, "decode")
    jspecs = _jax_bundle_on(bundle.cfg, shape)._cache_specs(cell)
    hd = model.cfg.head_dim
    for key, length in (("k", S), ("v", S), ("xk", ENC), ("xv", ENC)):
        block = jax_block_shape(shape, jspecs[key], (2, B, length, 6, hd))[1:]
        assert tuple(caches[0][0][key].shape) == block, key
    heads, slots = (3, S) if shape[1] == 2 else (6, S // 4)
    assert caches[0][0]["k"].shape[1:3] == (slots, heads)
    frames, toks = want["args"]
    assert torch.equal(meshed.greedy(frames, toks[:, :4], 4)[0],
                       model.greedy(frames, toks[:, :4], 4)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_caches_are_the_blocks_of_the_cache_specs(arch):
    """On (2, 2), (1, 4) and (1, 2): ``cache_specs`` equals JAX's
    ``_cache_specs`` (without the layer axis), and every position's cache
    leaves are the blocks those specs give it."""
    cfg = smoke_config(arch)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    cell = ShapeConfig("decode", S, B, "decode")
    for shape in [(2, 2), (1, 4), (1, 2)]:
        mesh = _mesh(shape)
        skeleton = build_model(cfg, device="meta", mesh=mesh)
        jspecs = _jax_bundle_on(jax_smoke_config(arch), shape)._cache_specs(cell)
        got = skeleton.cache_specs(cell)
        if cfg.is_encdec:
            want = [{k: tuple(v)[1:] for k, v in jspecs.items()}] * len(got)
        else:
            period = len(jspecs)
            want = [{k: tuple(v)[1:] for k, v in next(iter(jspecs[f"g{i % period}"].values()))
                     .items()} for i in range(len(got))]
        assert [{k: tuple(v) for k, v in layer.items()} for layer in got] == want, shape
        args = _inputs(cfg, B, S, seed=1)[1]
        meshed = shard_params(model, mesh)
        _, caches = meshed.prefill(*args)
        held = _held_blocks(skeleton, meshed, caches, cell)
        assert held, shape
        if cfg.family in ("ssm", "hybrid"):
            assert {"state", "conv_x", "conv_b", "conv_c"} <= set(held)
        if cfg.family != "ssm":
            assert {"k", "v"} <= set(held)
        if cfg.is_encdec:
            assert {"xk", "xv"} <= set(held)


def test_the_meshed_ssd_prefill_keeps_the_chunk_check():
    model = build_model(smoke_config("mamba2-1.3b"), device="cpu", dtype=torch.float32)
    meshed = shard_params(model, _mesh((2, 2)))
    toks = torch.zeros((2, 48), dtype=torch.int64)  # 48 tokens, chunks of 32
    with pytest.raises(ValueError, match="not a multiple of the chunk 32"):
        model.prefill(toks)
    with pytest.raises(ValueError, match="not a multiple of the chunk 32"):
        meshed.prefill(toks)


def test_the_engine_keeps_its_refusals_on_a_mesh():
    """A prompt shorter than the conv window's cache, and an
    encoder-decoder model, as on one device."""
    model = build_model(smoke_config("jamba-1.5-large-398b"), device="cpu", dtype=torch.float32)
    engine = ServeEngine(shard_params(model, _mesh((1, 2))))
    with pytest.raises(ValueError, match="conv window"):
        engine.serve([Request([1, 2], 2)])
    assert len(engine.serve([Request([1, 2, 3], 2)])[0]) == 2
    whisper = build_model(smoke_config("whisper-tiny"), device="cpu", dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServeEngine(shard_params(whisper, _mesh((1, 2))))
