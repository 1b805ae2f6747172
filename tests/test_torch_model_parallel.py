"""Serving on a model mesh: repro_torch's meshed models vs the JAX package.

The smoke configs of yi-6b, qwen1.5-0.5b, minitron-4b (the GELU MLP),
qwen2-vl (embeddings in, M-RoPE; at tp=4 its two KV heads do not divide,
so each position gathers K and V and repeats them to its query head),
llama4-scout (sigmoid router, shared expert) and dbrx, in float32: the JAX
weights loaded with ``params_from_jax``, then ``shard_params`` onto meshes
of ``"cpu"`` positions, ``(data, model)`` = (1, 2), (1, 4) and (2, 2).
JAX's oracle is its single-device ``ModelBundle`` (its own 8-device tests
fail in the driver's runs).  The row-parallel sums add their partials in
mesh order, so the meshed model is held within ``1e-5``, never bitwise.

The MoE archs run here at ``capacity_factor=8.0``: no slot is dropped, so
the expert-parallel prefill's per-block capacities and the one-device
whole-batch capacity give the same outputs.  The MoE layers at the
configs' 1.25 are held block by block in ``test_torch_expert_parallel.py``.
Also: ``gather_params`` inverts ``shard_params`` bit for bit, greedy
``ServeEngine`` tokens equal the JAX engine's, the refusals, and
``launch.serve --model-parallel 2`` (and 4) on four CPU positions, for
these archs and the SSM, hybrid and encoder-decoder ones (held in full in
``test_torch_model_parallel_families.py``).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from torch_train_cases import jax_pair
from torch_train_cases import one_torch_thread  # noqa: F401  (autouse)

from repro_torch.configs import smoke_config
from repro_torch.dist import make_mesh
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.models.model import gather_caches, gather_params, shard_params
from repro_torch.serve import Request, ServeEngine

ARCHS = ["yi-6b", "qwen1.5-0.5b", "minitron-4b", "qwen2-vl-2b", "llama4-scout-17b-a16e",
         "dbrx-132b"]
MESHES = [(1, 2), (1, 4), (2, 2)]
TOL = dict(rtol=1e-5, atol=1e-5)
ROOMY = 8.0  # capacity factor at which no smoke MoE layer drops a slot


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * 4)


B, S, EXTRA = 4, 16, 3  # the prefill held to JAX, and the slots a step needs
LENGTHS, NEWS = [16, 8, 16, 8, 16, 16], [5, 4, 3, 5, 4, 2]  # the greedy waves


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(the JAX outputs, the port's one-device model with the JAX weights).
    JAX runs once an arch: prefill of (B, S), a decode step at S, and the
    greedy engine's tokens over ``LENGTHS``."""
    over = dict(capacity_factor=ROOMY) if "moe" in smoke_config(request.param).family else {}
    bundle, params, model = jax_pair(request.param, **over)
    cfg = model.cfg
    batch, kw = _inputs(cfg, B, S, seed=3)
    logits, caches = jax.jit(bundle.prefill)(params, batch)
    step = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 1))
    caches = jax.tree.map(lambda c: np.pad(np.asarray(c), [(0, 0), (0, 0), (0, EXTRA), (0, 0),
                                                           (0, 0)]), caches)
    step_logits, step_caches = jax.jit(bundle.serve_step)(
        params, {"tokens": step.astype(np.int32), "pos": np.int32(S), "caches": caches})
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in LENGTHS]
    tokens = JaxServeEngine(bundle, params).serve(
        [JaxRequest(p, n) for p, n in zip(prompts, NEWS)])
    want = dict(kw=kw, logits=np.asarray(logits), caches=caches, step=step,
                step_logits=np.asarray(step_logits), step_caches=step_caches,
                prompts=prompts, tokens=tokens)
    return want, model


def _inputs(cfg, b, s, seed):
    """-> (JAX prefill batch, port prefill kwargs)."""
    rng = np.random.default_rng(seed)
    if cfg.mrope_sections:
        embeds = (0.5 * rng.standard_normal((b, s, cfg.d_model))).astype(np.float32)
        grid = rng.integers(0, 8, (b, s, 2))
        pos = np.concatenate([np.broadcast_to(np.arange(s), (b, s))[..., None], grid], -1)
        return ({"embeds": embeds, "positions": pos.astype(np.int32)},
                dict(embeds=torch.from_numpy(embeds), positions=torch.from_numpy(pos)))
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    return {"tokens": toks.astype(np.int32)}, dict(tokens=torch.from_numpy(toks))


def _jax_layer_caches(model, jcaches):
    """JAX's stacked caches as the port's per-layer list."""
    return [{k: np.asarray(jcaches["g0"]["attn"][k])[i] for k in ("k", "v")}
            for i in range(len(model.layers))]


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_prefill_caches_and_step_match_jax(pair, shape):
    want, model = pair
    kw = want["kw"]
    one, one_caches = model.prefill(cache_len=S + EXTRA, **kw)
    meshed = shard_params(model, _mesh(shape))
    got, caches = meshed.prefill(cache_len=S + EXTRA, **kw)
    assert got.shape == (B, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want["logits"], **TOL)
    np.testing.assert_allclose(got.numpy(), one.numpy(), **TOL)
    for layer, (g, w) in enumerate(zip(gather_caches(meshed, caches),
                                       _jax_layer_caches(model, want["caches"]))):
        for key in ("k", "v"):
            np.testing.assert_allclose(g[key].numpy(), w[key], err_msg=f"{layer}.{key}", **TOL)
            np.testing.assert_allclose(g[key].numpy(), one_caches[layer][key].numpy(), **TOL)

    step = torch.from_numpy(want["step"])
    got_step, caches = meshed.serve_step(step, S, caches)
    one_step, _ = model.serve_step(step, S, one_caches)
    np.testing.assert_allclose(got_step.numpy(), want["step_logits"], **TOL)
    np.testing.assert_allclose(got_step.numpy(), one_step.numpy(), **TOL)
    for layer, (g, w) in enumerate(zip(gather_caches(meshed, caches),
                                       _jax_layer_caches(model, want["step_caches"]))):
        for key in ("k", "v"):
            np.testing.assert_allclose(g[key].numpy(), w[key], err_msg=f"{layer}.{key}", **TOL)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_gather_params_inverts_shard_params_bitwise(pair, shape):
    _, model = pair
    meshed = shard_params(model, _mesh(shape))
    whole = gather_params(meshed)
    assert set(whole) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        assert torch.equal(whole[name], p), name
    assert meshed.num_params() == model.num_params()
    assert meshed.weight_bytes() >= model.weight_bytes()


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_greedy_tokens_equal_the_jax_engine(pair, shape):
    """Waves of 16 and 8 tokens (sequences the model axis divides: the
    expert-parallel prefill), requests of differing new-token counts."""
    want, model = pair
    engine = ServeEngine(shard_params(model, _mesh(shape)))
    assert engine.serve([Request(p, n) for p, n in zip(want["prompts"], NEWS)]) == want["tokens"]
    assert [(w["batch"], w["prompt_len"]) for w in engine.stats] == [(2, 8), (4, 16)]


def test_a_pod_axis_splits_the_batch_with_data(pair):
    """``("pod", "data", "model")`` = (2, 1, 2): the batch over pod x data,
    as JAX's batch axes; held to the one-device model."""
    want, model = pair
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), devices=["cpu"] * 4)
    meshed = shard_params(model, mesh)
    assert meshed.ctx.batch_axes == ("pod", "data") and meshed.ctx.n_batch == 2
    got, _ = meshed.prefill(**want["kw"])
    np.testing.assert_allclose(got.numpy(), want["logits"], **TOL)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b", "whisper-tiny"])
def test_other_families_shard_onto_a_mesh(arch):
    """``shard_params`` takes the SSM, hybrid and encoder-decoder families:
    the meshed prefill's logits equal the one-device model's within
    jamba's ``1e-4``."""
    cfg = smoke_config(arch)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(2)
    args = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))]
    if cfg.is_encdec:
        args.insert(0, torch.from_numpy(rng.standard_normal((2, 12, cfg.d_model))
                                        .astype(np.float32)))
    meshed = shard_params(model, _mesh((1, 2)))
    assert type(meshed).__name__ == ("MeshEncDecLM" if cfg.is_encdec else "MeshLM")
    np.testing.assert_allclose(meshed.prefill(*args)[0].numpy(), model.prefill(*args)[0].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_a_batch_the_data_axis_does_not_divide_raises(pair):
    _, model = pair
    meshed = shard_params(model, _mesh((2, 2)))
    kw = _inputs(model.cfg, 3, 8, seed=1)[1]
    with pytest.raises(ValueError, match="does not divide"):
        meshed.prefill(**kw)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "dbrx-132b", "mamba2-1.3b",
                                  "jamba-1.5-large-398b", "whisper-tiny"])
def test_serve_cli_model_parallel_tokens_equal_one_device(arch, monkeypatch, capsys):
    argv = ["--arch", arch, "--device", "cpu", "--requests", "4", "--prompt-len", "16",
            "--max-new-tokens", "6"]
    one = serve_cli.main(argv)
    monkeypatch.setenv("REPRO_DEVICES", "4")
    meshed = serve_cli.main(argv + ["--model-parallel", "2"])
    assert meshed["mesh"] == {"data": 2, "model": 2}
    assert meshed["first_tokens"] == one["first_tokens"] and meshed["new_tokens"] == 24
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["mesh"] == {"data": 2, "model": 2}


def test_serve_cli_model_parallel_4_serves_an_ssm_arch(monkeypatch):
    """``--model-parallel 4`` on four positions: a (1, 4) mesh, mamba2's
    8 SSM heads 2 a position, the tokens of ``--model-parallel 1``."""
    argv = ["--arch", "mamba2-1.3b", "--device", "cpu", "--requests", "2", "--prompt-len",
            "16", "--max-new-tokens", "4"]
    one = serve_cli.main(argv)
    monkeypatch.setenv("REPRO_DEVICES", "4")
    meshed = serve_cli.main(argv + ["--model-parallel", "4"])
    assert meshed["mesh"] == {"data": 1, "model": 4}
    assert meshed["first_tokens"] == one["first_tokens"] and meshed["new_tokens"] == 8


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=str)
def test_heads_the_model_axis_does_not_divide(shape):
    """H = 6: at tp = 4 the query heads do not divide (JAX's rule keeps
    every head on every position), though ``wq``'s 192 columns still shard
    and ``wo``'s row shard takes its heads' columns; at tp = 2 each position
    has 3 query heads and the one KV head they read."""
    cfg = dataclasses.replace(smoke_config("yi-6b"), num_heads=6, num_kv_heads=2)
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (4, 12)))
    one, one_caches = model.prefill(toks, cache_len=13)
    meshed = shard_params(model, _mesh(shape))
    got, caches = meshed.prefill(toks, cache_len=13)
    np.testing.assert_allclose(got.numpy(), one.numpy(), **TOL)
    step = toks[:, :1]
    np.testing.assert_allclose(meshed.serve_step(step, 12, caches)[0].numpy(),
                               model.serve_step(step, 12, one_caches)[0].numpy(), **TOL)


def test_build_model_keeps_the_mesh_and_its_rules():
    mesh = _mesh((2, 2))
    cfg = dataclasses.replace(smoke_config("yi-6b"), fsdp=True)
    model = build_model(cfg, device="cpu", mesh=mesh)
    assert model.mesh is mesh and model.rules.fsdp == "data" and model.rules.heads == "model"
    assert tuple(model.specs()["layers.0.attn.wq"]) == ("data", "model")
    meshed = shard_params(model)
    assert meshed.mesh is mesh
    assert meshed.local("layers.0.attn.wq")[0].shape == (64, 64)
