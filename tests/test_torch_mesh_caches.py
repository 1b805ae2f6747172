"""The meshed decode caches in JAX's ``_cache_specs`` layout: repro_torch's
meshed models vs the JAX package.

Each position holds the block of every cache leaf that ``cache_specs``
gives it: the KV heads over ``model`` where they divide, else the
sequence; the sequence over the batch axes too where the batch does not
divide them; whole where the cache length does not divide the chosen axes.
A decode step over a sharded sequence attends slice by slice and combines
the partial softmaxes over the positions holding the slices.

The smoke configs in float32, the JAX weights loaded with
``params_from_jax``, on meshes of ``"cpu"`` positions: prefill logits,
every gathered cache leaf, a decode step and greedy tokens held to JAX's
single-device bundle and to the port's one-device model at ``1e-5``, for
the sequence over ``model`` (yi-6b's two KV heads at tp = 4, with and
without a slice past the prompt), a cache length the axes do not divide,
the KV heads over ``model`` under ``tp_style="gather"`` (every query head
on a position: its cache writes and outputs cut to the block's heads),
one row on (2, 2) (the sequence over ``data``), and whisper's cross caches
``xk`` / ``xv`` (their block the one JAX's ``NamedSharding.shard_shape``
gives them; the sequence whole where JAX refuses an encoder length the axes
do not divide).  ``gather_caches`` reassembles every layout bitwise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from test_torch_families import _jax_caches_by_layer, _pad_self_kv
from torch_train_cases import jax_pair
from torch_train_cases import one_torch_thread  # noqa: F401  (autouse)

from repro_torch.configs import smoke_config
from repro_torch.dist import make_mesh
from repro_torch.dist.sharding import mesh_extent, shard_slices
from repro_torch.models import build_model
from repro_torch.models.model import gather_caches, mesh_model, shard_params
from repro_torch.serve import Request, ServeEngine

TOL = dict(rtol=1e-5, atol=1e-5)
WHISPER6 = dict(num_heads=6, num_kv_heads=6)  # heads tp = 4 does not divide


def jax_block_shape(mesh_shape, spec, whole) -> tuple:
    """The block of a leaf of shape ``whole`` laid out by the JAX ``spec``
    on a (data, model) mesh of ``mesh_shape``, as ``NamedSharding
    .shard_shape`` gives it; where JAX refuses the layout (a sequence, dim 2
    of the stacked leaf, that does not divide over its axes), the block with
    that sequence whole."""
    mesh = AbstractMesh(tuple(mesh_shape), ("data", "model"))
    try:
        return tuple(NamedSharding(mesh, spec).shard_shape(tuple(whole)))
    except ValueError:
        spec = JP(*(None if d == 2 else e for d, e in enumerate(spec)))
        return tuple(NamedSharding(mesh, spec).shard_shape(tuple(whole)))


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * (shape[0] * shape[1]))


# id -> (arch, config overrides, mesh, batch, prompt, cache length, encoder
# frames, the spec's sequence entry)
CASES = {
    "seq-over-model": ("yi-6b", {}, (1, 4), 4, 16, 20, None, "model"),
    "seq-over-model-slice-past-the-prompt": ("yi-6b", {}, (1, 4), 4, 16, 32, None, "model"),
    "length-does-not-divide": ("yi-6b", {}, (1, 4), 4, 16, 19, None, None),
    "one-row-seq-over-data": ("yi-6b", {}, (2, 2), 1, 16, 20, None, "data"),
    "mrope-seq-over-model": ("qwen2-vl-2b", {}, (1, 4), 4, 16, 20, None, "model"),
    # every query head on a position, its cache the KV heads over model
    "gather-tp-style-heads-over-model": ("yi-6b", {"tp_style": "gather"}, (1, 2), 4, 16, 20,
                                         None, None),
    "whisper-seq-over-model": ("whisper-tiny", WHISPER6, (1, 4), 4, 16, 20, 24, "model"),
    "whisper-frames-do-not-divide": ("whisper-tiny", WHISPER6, (1, 4), 4, 16, 20, 22, "model"),
    "whisper-one-row-seq-over-data": ("whisper-tiny", WHISPER6, (2, 2), 1, 16, 20, 24, "data"),
}


@pytest.fixture(scope="module")
def pairs():
    """arch -> (JAX bundle, JAX params, the port's one-device model), built
    once an arch."""
    out = {}

    def get(arch, over):
        key = (arch, tuple(sorted(over.items())))
        if key not in out:
            out[key] = jax_pair(arch, **over)
        return out[key]

    return get


def _inputs(cfg, b, s, enc, seed):
    """-> (JAX prefill batch, port prefill args, port prefill kwargs)."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        frames = (0.5 * rng.standard_normal((b, enc, cfg.d_model))).astype(np.float32)
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


def _hold(got_caches, want_tree, model, err=""):
    want = _jax_caches_by_layer(model, want_tree)
    assert len(got_caches) == len(want)
    for layer, (g, w) in enumerate(zip(got_caches, want)):
        assert sorted(g) == sorted(w), layer
        for name in w:
            np.testing.assert_allclose(g[name].numpy(), w[name], err_msg=f"{err}{layer}.{name}",
                                       **TOL)


def _greedy(m, args, kwargs, length, new):
    """Greedy tokens of one wave through ``prefill`` and ``serve_step``."""
    last, caches = m.prefill(*args, cache_len=length + new, **kwargs)
    tok, out = last.argmax(-1), []
    for i in range(new):
        out.append(tok)
        if i + 1 < new:
            logits, caches = m.serve_step(tok[:, None], length + i, caches)
            tok = logits[:, 0].argmax(-1)
    return torch.stack(out, 1)


@pytest.mark.parametrize("case", list(CASES))
def test_meshed_caches_hold_jax_layout_and_values(pairs, case):
    arch, over, shape, b, s, length, enc, seq = CASES[case]
    bundle, params, model = pairs(arch, over)
    cfg = model.cfg
    batch, args, kwargs = _inputs(cfg, b, s, enc, seed=3)
    # JAX: prefill, the self-attention caches grown to ``length``, a step at s
    jlogits, jcaches = jax.jit(bundle.prefill)(params, batch)
    jcaches = _pad_self_kv(model, jcaches, length - s)
    step = np.random.default_rng(4).integers(0, cfg.vocab_size, (b, 1))
    jstep, jstep_caches = jax.jit(bundle.serve_step)(
        params, {"tokens": step.astype(np.int32), "pos": np.int32(s), "caches": jcaches})

    one, one_caches = model.prefill(*args, cache_len=length, **kwargs)
    meshed = shard_params(model, _mesh(shape))
    if b % shape[0]:  # JAX replicates a batch the batch axes do not divide
        meshed = meshed.with_batch_replicated()
    got, caches = meshed.prefill(*args, cache_len=length, **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(got.numpy(), one.numpy(), **TOL)

    # the layout: JAX's spec, each leaf the block JAX gives the position
    cell = JaxShapeConfig("decode", length, b, "decode")
    jspecs = build_jax_on(bundle, shape)._cache_specs(cell)
    kspec = jspecs["k"] if cfg.is_encdec else jspecs["g0"]["attn"]["k"]
    assert kspec[2] == seq
    leaves = {"k": length, "v": length}
    if cfg.is_encdec:
        leaves.update(xk=enc, xv=enc)
    for i, pos in enumerate(caches):
        for name, n in leaves.items():
            whole = (cfg.num_layers, b, n, cfg.num_kv_heads, cfg.head_dim)
            want = jax_block_shape(shape, kspec, whole)[1:]
            assert tuple(pos[0][name].shape) == want, (i, name)
    if enc is not None and enc % shape[1 if seq == "model" else 0]:
        assert caches[0][0]["xk"].shape[1] == enc  # JAX refuses that layout: whole

    _hold(gather_caches(meshed, caches), jcaches, model)
    for g, w in zip(gather_caches(meshed, caches), one_caches):
        for name in w:
            np.testing.assert_allclose(g[name].numpy(), w[name].numpy(), err_msg=name, **TOL)

    tok = torch.from_numpy(step)
    got_step, caches = meshed.serve_step(tok, s, caches)
    one_step, one_caches = model.serve_step(tok, s, one_caches)
    np.testing.assert_allclose(got_step.numpy(), np.asarray(jstep), **TOL)
    np.testing.assert_allclose(got_step.numpy(), one_step.numpy(), **TOL)
    _hold(gather_caches(meshed, caches), jstep_caches, model, err="step ")


def build_jax_on(bundle, shape):
    """JAX's bundle of the same config on a stand-in mesh of ``shape`` (its
    spec methods read only ``mesh.shape``)."""
    from types import SimpleNamespace

    from repro.models.model import build_model as jax_build_model

    return jax_build_model(bundle.cfg, SimpleNamespace(shape={"data": shape[0],
                                                              "model": shape[1]}))


@pytest.mark.parametrize("case", [c for c in CASES if not c.startswith("whisper")
                                  and not c.startswith("mrope")])
def test_greedy_tokens_over_the_layout_equal_jax(pairs, case):
    """Greedy waves whose cache length (prompt plus new tokens) gives the
    case's layout: the meshed tokens equal the JAX engine's and the
    one-device model's (the engine drives a batch the mesh divides; one
    row goes through ``with_batch_replicated``)."""
    arch, over, shape, b, s, length, _, _ = CASES[case]
    bundle, params, model = pairs(arch, over)
    cfg = model.cfg
    new = length - s
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, s).tolist() for _ in range(b)]
    want = JaxServeEngine(bundle, params).serve([JaxRequest(p, new) for p in prompts])
    meshed = shard_params(model, _mesh(shape))
    if b % shape[0]:
        meshed = meshed.with_batch_replicated()
        toks = torch.tensor(prompts)
        got = _greedy(meshed, (toks,), {}, s, new).tolist()
        assert got == _greedy(model, (toks,), {}, s, new).tolist()
    else:
        engine = ServeEngine(meshed)
        got = engine.serve([Request(p, new) for p in prompts])
        assert ServeEngine(model).serve([Request(p, new) for p in prompts]) == got
    assert got == want


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("whisper")])
def test_whisper_greedy_over_the_layout_equals_one_device(pairs, case):
    """``MeshEncDecLM.greedy`` (cache length prompt plus new tokens) equals
    the one-device ``greedy``: the JAX engine refuses the encoder-decoder."""
    arch, over, shape, b, s, length, enc, _ = CASES[case]
    _, _, model = pairs(arch, over)
    _, (frames, toks), _ = _inputs(model.cfg, b, s, enc, seed=5)
    meshed = shard_params(model, _mesh(shape))
    if b % shape[0]:
        meshed = meshed.with_batch_replicated()
    got = meshed.greedy(frames, toks, length - s)[0]
    assert torch.equal(got, model.greedy(frames, toks, length - s)[0])


@pytest.mark.parametrize("mesh_shape,axes", [((1, 4), ("data", "model")),
                                             ((2, 2), ("data", "model")),
                                             ((2, 1, 2), ("pod", "data", "model"))], ids=str)
@pytest.mark.parametrize("arch", ["yi-6b", "jamba-1.5-large-398b", "whisper-tiny"])
@pytest.mark.parametrize("batch,length", [(4, 16), (4, 18), (1, 16)], ids=str)
def test_gather_caches_reassembles_every_layout_bitwise(arch, mesh_shape, axes, batch, length):
    """Random whole caches cut into the blocks ``new_caches`` lays out (the
    position's ``shard_slices`` of each leaf under its spec): every block
    has the block's shape, and ``gather_caches`` gives the wholes back bit
    for bit, sequence slices in the flat order of their axes."""
    cfg = smoke_config(arch)
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, **WHISPER6)
    mesh = make_mesh(mesh_shape, axes, devices=["cpu"] * 4)
    meshed = mesh_model(build_model(cfg, device="meta"), mesh)
    if batch % meshed.ctx.n_batch:
        meshed = meshed.with_batch_replicated()
    kw = {"cross": 12} if cfg.is_encdec else {}
    caches = meshed.new_caches(batch, length, device="cpu", **kw)
    gen = torch.Generator().manual_seed(7)
    wholes = []
    for layer in caches[0]:
        leaves = {}
        for name, t in layer.items():
            extents = [mesh_extent(mesh, e) for e in layer.specs[name]]
            leaves[name] = torch.randn([d * e for d, e in zip(t.shape, extents)], generator=gen)
        wholes.append(leaves)
    for i, pos in enumerate(caches):
        coords = meshed.ctx.coords[i]
        for layer, whole in zip(pos, wholes):
            for name, w in whole.items():
                block = w[shard_slices(mesh, coords, layer.specs[name], w.shape)]
                assert layer[name].shape == block.shape, (i, name)
                layer[name].copy_(block)
    for got, want in zip(gather_caches(meshed, caches, device="cpu"), wholes):
        assert sorted(got) == sorted(want)
        for name in want:
            assert torch.equal(got[name], want[name]), name
    rows = {layer["k"].shape[0] for pos in caches for layer in pos if "k" in layer}
    assert rows <= {batch // meshed.ctx.n_batch}
