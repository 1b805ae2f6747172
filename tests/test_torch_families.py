"""repro_torch's other LM families vs the JAX package.

The smoke configs of dbrx (MoE, softmax top-2), llama4-scout (MoE, sigmoid
top-1 and a shared expert), mamba2 (SSD), jamba (the hybrid: Mamba layers,
attention at offset 4, MoE on odd layers), qwen2-vl (M-RoPE, embeddings in)
and whisper (encoder-decoder), in float32 on the CPU.  The JAX parameters
(biases, norm weights and the SSM's ``dt_bias`` / ``a_log`` / ``d_skip``
perturbed away from their init, so every weight matters) are loaded with
``params_from_jax``; parameter counts equal, prefill logits, every cache
leaf and a decode step agree with ``ModelBundle`` within
``rtol=1e-5, atol=1e-5``.  The pieces are held one by one too: the MoE
routing and capacity dispatch (``buf_tok`` bit for bit, drops and ties
included), ``ssd_chunked`` against JAX's and against the token-by-token
recurrence, M-RoPE and the sinusoidal table.  The fixture's cases add
``jamba-cut``, jamba's smoke config cut as the card serves the published
one (``JAMBA_CUT``: an attention layer, then a Mamba-2 layer with the MoE),
and the cut of the published config is counted on ``meta``.  Serving is
held in ``test_torch_families_serve.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import rope as jrope
from repro.models.model import build_model as jax_build_model
from torch_train_cases import JAMBA_CUT_CASE, smoke_configs

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.configs.jamba_1_5_large_398b import JAMBA_CUT
from repro_torch.models import build_model, mamba, moe, rope
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import group_pattern

FAMILIES = ["dbrx-132b", "llama4-scout-17b-a16e", "mamba2-1.3b", "jamba-1.5-large-398b",
            "qwen2-vl-2b", "whisper-tiny"]
DECODERS = FAMILIES[:-1]
TOL = dict(rtol=1e-5, atol=1e-5)
# Jamba's superblock (eight layers: seven Mamba, four MoE) drifts further in
# float32 than the two-layer smoke configs, and the drift grows layer by
# layer.  Its witness is the port's float64 run of the same weights (the
# router, dt and the SSM decays stay float32 there, as in JAX): the port's
# and the JAX package's float32 logits and caches each lie within
# HYBRID_WITNESS of it (``_hold_hybrid_to_float64``), so the two are held
# to each other at twice that.
HYBRID_WITNESS = dict(rtol=5e-5, atol=5e-5)
HYBRID_TOL = dict(rtol=1e-4, atol=1e-4)


def _tol(model):
    return HYBRID_TOL if model.cfg.family == "hybrid" else TOL
PERTURBED = {"bq", "bk", "bv", "b_in", "b_out", "w", "b", "dt_bias", "a_log", "d_skip",
             "norm"}


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", None) in PERTURBED:
            x = x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


@pytest.fixture(scope="module", params=FAMILIES + [JAMBA_CUT_CASE])
def pair(request):
    """(JAX bundle, JAX params as numpy, port model with those weights)."""
    jax_cfg, cfg = smoke_configs(request.param)
    bundle = jax_build_model(jax_cfg, mesh=None)
    params = _perturbed(bundle.init(jax.random.PRNGKey(1)), seed=7)
    model = build_model(cfg, device="cpu")
    params_from_jax(model, params)
    return bundle, params, model


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _frames(cfg, b, s, seed):
    return (0.5 * np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))
            ).astype(np.float32)


def _grid_positions(b, s, grid_w=4):
    """(B, S, 3) M-RoPE ids: an image grid over the first half (t = 0,
    h = i // w, w = i % w), text after it (t = h = w)."""
    i = np.arange(s)
    img = s // 2
    pos = np.stack([np.zeros(s), i // grid_w, i % grid_w], axis=-1)
    pos[img:] = (i[img:] - img + (img - 1) // grid_w + 1)[:, None]
    return np.broadcast_to(pos.astype(np.int64), (b, s, 3)).copy()


def _prefill_inputs(model, b, s, seed):
    """-> (JAX batch, port prefill args, port prefill kwargs)."""
    cfg = model.cfg
    if cfg.is_encdec:
        frames, toks = _frames(cfg, b, 24, seed), _tokens(cfg, b, s, seed)
        return ({"enc_embeds": frames, "dec_tokens": toks},
                (torch.from_numpy(frames), torch.from_numpy(toks)), {})
    if cfg.mrope_sections:
        embeds, pos = _frames(cfg, b, s, seed), _grid_positions(b, s)
        return ({"embeds": embeds, "positions": pos}, (),
                dict(embeds=torch.from_numpy(embeds), positions=torch.from_numpy(pos)))
    toks = _tokens(cfg, b, s, seed)
    return {"tokens": toks}, (torch.from_numpy(toks),), {}


def _jax_caches_by_layer(model, jcaches) -> list:
    """The JAX cache tree as the port's per-layer list of dicts."""
    if isinstance(model, EncDecLM):
        return [{name: np.asarray(c)[i] for name, c in jcaches.items()}
                for i in range(len(model.dec_layers))]
    period = len(group_pattern(model.cfg))
    out = []
    for layer in range(len(model.layers)):
        (sub,) = jcaches[f"g{layer % period}"].values()  # {"attn": ...} or {"ssm": ...}
        out.append({name: np.asarray(c)[layer // period] for name, c in sub.items()})
    return out


def _pad_self_kv(model, jcaches, extra):
    """Grow the self-attention K/V caches by ``extra`` slots (axis 2 of the
    stacked tree), as the JAX engine's ``_pad_caches`` does."""
    def grow(path, c):
        names = {getattr(p, "key", None) for p in path}
        c = np.asarray(c)
        if names & {"k", "v"} and not names & {"ssm"}:
            pad = [(0, 0)] * c.ndim
            pad[2] = (0, extra)
            c = np.pad(c, pad)
        return c

    return jax.tree_util.tree_map_with_path(grow, jcaches)


def _assert_caches(model, got, want_tree):
    want = _jax_caches_by_layer(model, want_tree)
    assert len(got) == len(want)
    for layer, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), layer
        for name in w:
            np.testing.assert_allclose(g[name].numpy(), w[name], err_msg=f"{layer}.{name}",
                                       **_tol(model))


def _hold_hybrid_to_float64(params, model, run, got, want):
    """For the hybrid: ``run(m) -> (logits, caches)`` on the port's float64
    twin of ``model``; ``got`` (the port's) and ``want`` (JAX's) each lie
    within HYBRID_WITNESS of it.  Other families return at once."""
    if model.cfg.family != "hybrid":
        return
    twin = build_model(dataclasses.replace(model.cfg, dtype="float64"), device="cpu")
    ref_logits, ref_caches = run(params_from_jax(twin, params))
    assert ref_logits.dtype == torch.float64
    (logits, caches), (want_logits, want_caches) = got, want
    for who, x in (("port", logits.numpy()), ("jax", np.asarray(want_logits))):
        np.testing.assert_allclose(x, ref_logits.numpy(), err_msg=who, **HYBRID_WITNESS)
    for layer, (g, w, r) in enumerate(zip(caches, _jax_caches_by_layer(model, want_caches),
                                          ref_caches)):
        for name in r:
            for who, x in (("port", g[name].numpy()), ("jax", w[name])):
                np.testing.assert_allclose(x, r[name].numpy(), err_msg=f"{who} {layer}.{name}",
                                           **HYBRID_WITNESS)


def test_param_count_matches_jax(pair):
    bundle, _, model = pair
    assert model.num_params() == bundle.num_params()


def test_prefill_logits_and_caches(pair):
    bundle, params, model = pair
    batch, args, kw = _prefill_inputs(model, 2, 19, seed=3)
    want_logits, want_caches = jax.jit(bundle.prefill)(params, batch)
    logits, caches = model.prefill(*args, **kw)
    assert logits.shape == (2, model.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **_tol(model))
    _assert_caches(model, caches, want_caches)
    _hold_hybrid_to_float64(params, model, lambda m: m.prefill(*args, **kw),
                            (logits, caches), (want_logits, want_caches))


def test_serve_step_at_a_cursor(pair):
    bundle, params, model = pair
    b, s, extra = 2, 16, 3
    batch, args, kw = _prefill_inputs(model, b, s, seed=5)
    step = _tokens(model.cfg, b, 1, seed=6)
    _, jcaches = jax.jit(bundle.prefill)(params, batch)
    want_logits, want_caches = jax.jit(bundle.serve_step)(
        params, {"tokens": step, "pos": np.int32(s), "caches": _pad_self_kv(model, jcaches, extra)})
    _, caches = model.prefill(*args, cache_len=s + extra, **kw)
    logits, caches = model.serve_step(torch.from_numpy(step), s, caches)
    assert logits.shape == (b, 1, model.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **_tol(model))
    _assert_caches(model, caches, want_caches)

    def run(m):
        return m.serve_step(torch.from_numpy(step), s, m.prefill(*args, cache_len=s + extra, **kw)[1])

    _hold_hybrid_to_float64(params, model, run, (logits, caches), (want_logits, want_caches))


def test_prefill_then_decode_consistency(pair):
    """Prefill of s-1 tokens and one decode step == prefill of s tokens (the
    JAX package's own check, ``tests/test_arch_smoke.py``), on the token
    path every family decodes through."""
    _, _, model = pair
    cfg, s = model.cfg, 16
    tokens = torch.from_numpy(_tokens(cfg, 2, s, seed=4))
    if cfg.is_encdec:
        frames = torch.from_numpy(_frames(cfg, 2, 24, seed=4))
        full, _ = model.prefill(frames, tokens)
        _, caches = model.prefill(frames, tokens[:, : s - 1], cache_len=s)
    else:
        full, _ = model.prefill(tokens)
        _, caches = model.prefill(tokens[:, : s - 1], cache_len=s)
    step, _ = model.serve_step(tokens[:, s - 1:], s - 1, caches)
    np.testing.assert_allclose(step[:, 0].numpy(), full.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", list_archs())
def test_every_config_builds_with_the_jax_parameter_count(arch):
    model = build_model(smoke_config(arch), device="cpu")
    assert model.num_params() == jax_build_model(jax_smoke_config(arch), mesh=None).num_params()


def test_jamba_cut_at_its_published_widths_on_meta():
    """The cut the card serves (``JAMBA_CUT`` over the published config),
    built on ``meta`` with no weight allocated: an attention layer with a
    dense MLP, then a Mamba-2 layer with the 16-expert MoE; its parameters
    and bf16 bytes, and JAX's count of the same replaced config."""
    arch = "jamba-1.5-large-398b"
    model = build_model(dataclasses.replace(get_config(arch), **JAMBA_CUT), device="meta",
                        dtype=torch.bfloat16)
    assert model.kinds == [("attn", "dense"), ("ssm", "moe")]
    assert all(p.is_meta for p in model.parameters())
    assert model.num_params() == 11_899_496_192
    assert model.weight_bytes() == 23_798_992_384
    bundle = jax_build_model(dataclasses.replace(jax_get_config(arch), **JAMBA_CUT), mesh=None)
    assert bundle.num_params() == model.num_params()


def test_hybrid_stacks_map_leaf_i_of_g_j_to_layer_i_times_period_plus_j():
    """Two jamba superblocks: ``g{j}`` leaf ``i`` is layer ``8 i + j``."""
    cfg = dataclasses.replace(smoke_config("jamba-1.5-large-398b"), num_layers=16)
    jcfg = dataclasses.replace(jax_smoke_config("jamba-1.5-large-398b"), num_layers=16)
    params = jax.tree.map(np.asarray, jax_build_model(jcfg, mesh=None).init(jax.random.PRNGKey(0)))
    model = params_from_jax(build_model(cfg, device="cpu"), params)
    assert [k for k, _ in model.kinds] == (["ssm"] * 4 + ["attn"] + ["ssm"] * 3) * 2
    assert [f for _, f in model.kinds] == ["dense", "moe"] * 8
    for i in range(2):
        for j in range(8):
            layer = model.layers[8 * i + j]
            np.testing.assert_array_equal(layer["ln1"]["w"].detach().numpy(), params[f"g{j}"]["ln1"]["w"][i])
    np.testing.assert_array_equal(model.layers[12]["attn"]["wq"].detach().numpy(),
                                  params["g4"]["attn"]["wq"][1])
    np.testing.assert_array_equal(model.layers[9]["moe"]["router"].detach().numpy(),
                                  params["g1"]["moe"]["router"][1])
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(build_model(smoke_config("jamba-1.5-large-398b"), device="cpu"), params)


def test_encdec_tree_and_its_checks():
    arch = "whisper-tiny"
    params = jax.tree.map(np.asarray,
                          jax_build_model(jax_smoke_config(arch), mesh=None).init(jax.random.PRNGKey(0)))
    model = params_from_jax(build_model(smoke_config(arch), device="cpu"), params)
    np.testing.assert_array_equal(model.dec_layers[1]["cross"]["wk"].detach().numpy(),
                                  params["dec_blocks"]["cross"]["wk"][1])
    np.testing.assert_array_equal(model.top["enc_final"]["b"].detach().numpy(), params["enc_final"]["b"])
    with pytest.raises(KeyError, match="not in the JAX tree"):
        params_from_jax(model, {k: v for k, v in params.items() if k != "dec_final"})
    with pytest.raises(KeyError, match="no counterpart"):
        params_from_jax(model, dict(params, g0=params["enc_blocks"]))


# -- MoE: routing, capacity dispatch, the expert FFN ------------------------

def _moe_case(arch, factor, zero_router, t=40, seed=0):
    cfg = dataclasses.replace(smoke_config(arch), capacity_factor=factor)
    jcfg = dataclasses.replace(jax_smoke_config(arch), capacity_factor=factor)
    bundle = jax_build_model(jcfg, mesh=None)
    tree = bundle.init(jax.random.PRNGKey(seed))
    jp = jax.tree.map(np.asarray, tree["g0"]["moe"])
    jp = {k: v[0] for k, v in jp.items()}  # layer 0
    if zero_router:
        jp["router"] = np.zeros_like(jp["router"])
    x = np.random.default_rng(seed).standard_normal((2, t // 2, cfg.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in jp.items()}
    return cfg, jcfg, jp, tp, x


MOE_CASES = [  # arch, capacity factor, zero router
    ("dbrx-132b", 2.0, False),  # the smoke config: softmax top-2
    ("dbrx-132b", 0.5, False),  # a small factor: full experts drop slots
    ("dbrx-132b", 1.0, True),  # every logit ties: experts 0 and 1, both over capacity
    ("llama4-scout-17b-a16e", 2.0, False),  # sigmoid top-1, the shared expert
    ("llama4-scout-17b-a16e", 0.5, True),
]


@pytest.mark.parametrize("arch,factor,zero_router", MOE_CASES)
def test_moe_dispatch_bitwise_and_output_match_jax(arch, factor, zero_router):
    cfg, jcfg, jp, tp, x = _moe_case(arch, factor, zero_router)
    e, k = cfg.num_experts, cfg.experts_per_token
    x2d = x.reshape(-1, cfg.d_model)
    t = x2d.shape[0]
    cap = moe._capacity(t, k, e, factor)
    assert cap == jmoe._capacity(t, k, e, factor)
    jids, jgates, jprobs = jmoe._route(jnp.asarray(x2d), jnp.asarray(jp["router"]), k,
                                      jcfg.router_softmax_topk)
    ids, gates, probs = moe._route(torch.from_numpy(x2d), tp["router"], k,
                                   cfg.router_softmax_topk)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), **TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)
    jtok, jgate = jmoe._dispatch_sorted(jids, jgates, t, e, cap)
    tok, gate = moe._dispatch_sorted(ids, gates, e, cap)
    assert tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), **TOL)
    kept = int((tok >= 0).sum())
    if factor <= 1:
        assert kept < t * k  # this case drops slots
    else:
        assert kept == t * k
    if zero_router:
        assert set(ids.unique().tolist()) == set(range(k))  # the lower indices win ties
    jy, jaux = jmoe.moe_einsum(jp, jnp.asarray(x), cfg=jcfg)
    y, aux = moe.moe_einsum(tp, torch.from_numpy(x), cfg=cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e"])
def test_moe_equals_the_dense_reference_when_nothing_drops(arch):
    cfg, jcfg, jp, tp, x = _moe_case(arch, 8.0, False, t=64, seed=3)
    y, _ = moe.moe_einsum(tp, torch.from_numpy(x), cfg=cfg)
    ref = moe.moe_dense_reference(tp, torch.from_numpy(x), cfg=cfg)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), **TOL)
    jref = jmoe.moe_dense_reference(jp, jnp.asarray(x), cfg=jcfg)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), **TOL)


# -- Mamba-2: the SSD scan and its pieces ----------------------------------

def _ssd_inputs(b=2, s=64, h=4, p=8, n=16, seed=0):
    """What ``mamba_apply`` hands the scan: x, B and C through a SiLU, dt
    through a softplus, ``a = -exp(a_log)``."""
    rng = np.random.default_rng(seed)

    def silu(v):
        return (v / (1 + np.exp(-v))).astype(np.float32)

    x = silu(rng.standard_normal((b, s, h, p)))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.1 * rng.standard_normal(h)).astype(np.float32)
    bb = silu(rng.standard_normal((b, s, 1, n))).repeat(h, axis=2)  # one group
    cc = silu(rng.standard_normal((b, s, 1, n))).repeat(h, axis=2)
    s0 = (0.1 * rng.standard_normal((b, h, p, n))).astype(np.float32)
    return x, dt, a, bb, cc, s0


@pytest.mark.parametrize("chunk", [16, 64, 128])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax_and_the_recurrence(chunk, with_state):
    x, dt, a, b, c, s0 = _ssd_inputs()
    init = s0 if with_state else None
    jy, jstate = jmamba.ssd_chunked(*(jnp.asarray(t) for t in (x, dt, a, b, c)), chunk=chunk,
                                    initial_state=None if init is None else jnp.asarray(init))
    tx, tdt, ta, tb, tc = (torch.from_numpy(t) for t in (x, dt, a, b, c))
    y, state = mamba.ssd_chunked(tx, tdt, ta, tb, tc, chunk=chunk,
                                 initial_state=None if init is None else torch.from_numpy(init))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL)
    # The token-by-token recurrence on the same inputs.
    st = torch.zeros_like(state) if init is None else torch.from_numpy(init)
    ys = []
    for i in range(x.shape[1]):
        yi, st = mamba.ssd_recurrent_step(st, tx[:, i:i + 1], tdt[:, i:i + 1], ta,
                                          tb[:, i:i + 1], tc[:, i:i + 1])
        ys.append(yi)
    scale = np.abs(y.numpy()).max()
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(st.numpy(), state.numpy(), rtol=1e-5, atol=1e-5 * scale)


def test_ssd_recurrent_step_matches_jax():
    x, dt, a, b, c, s0 = _ssd_inputs(s=1)
    jy, jst = jmamba.ssd_recurrent_step(*(jnp.asarray(t) for t in (s0, x, dt, a, b, c)))
    y, st = mamba.ssd_recurrent_step(*(torch.from_numpy(t) for t in (s0, x, dt, a, b, c)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


def test_ssd_prefill_needs_whole_chunks_as_jax():
    x, dt, a, b, c, _ = _ssd_inputs(s=33)
    with pytest.raises(AssertionError):
        jmamba.ssd_chunked(*(jnp.asarray(t) for t in (x, dt, a, b, c)), chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk 32"):
        mamba.ssd_chunked(*(torch.from_numpy(t) for t in (x, dt, a, b, c)), chunk=32)
    mamba.ssd_chunked(*(torch.from_numpy(t) for t in (x, dt, a, b, c)), chunk=33)


def test_segsum_and_causal_conv_match_jax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 6)).astype(np.float32)
    got, want = mamba._segsum(torch.from_numpy(a)).numpy(), np.asarray(jmamba._segsum(jnp.asarray(a)))
    assert np.isneginf(got[:, 0, 1]).all() and np.isneginf(want[:, 0, 1]).all()
    np.testing.assert_allclose(got, want, **TOL)
    x = rng.standard_normal((2, 5, 7)).astype(np.float32)
    w = rng.standard_normal((4, 7)).astype(np.float32)
    cache = rng.standard_normal((2, 3, 7)).astype(np.float32)
    for c in (None, cache):
        jy, jc = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                     None if c is None else jnp.asarray(c))
        y, tc = mamba._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                   None if c is None else torch.from_numpy(c))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        if c is not None:
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


# -- positions: M-RoPE and the sinusoidal table ----------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_matches_jax_with_distinct_streams(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 11, 3))
    assert (pos[..., 0] != pos[..., 1]).any() and (pos[..., 1] != pos[..., 2]).any()
    want = jrope.apply_mrope(jnp.asarray(x).astype(dtype), jnp.asarray(pos), (4, 6, 6), theta=1e6)
    got = rope.apply_mrope(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(pos),
                           (4, 6, 6), theta=1e6)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    with pytest.raises(ValueError, match="sections"):
        rope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (4, 6, 5))


def test_mrope_of_text_positions_is_rope():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 9, 4, 32)).astype(np.float32))
    pos = torch.from_numpy(np.stack([np.arange(9), np.arange(40, 49)]))
    want = rope.apply_rope(x, pos, theta=1e6)
    assert torch.equal(rope.apply_mrope(x, rope.text_mrope_positions(pos), (4, 6, 6), theta=1e6),
                       want)
    cos, sin = rope.rope_cos_sin(pos, 32, theta=1e6, sections=(4, 6, 6))  # (B, S) ids
    assert torch.equal(rope.rotate(x, cos, sin), want)
    np.testing.assert_array_equal(
        rope.text_mrope_positions(pos).numpy(),
        np.asarray(jrope.text_mrope_positions(jnp.asarray(pos.numpy()))))


@pytest.mark.parametrize("seq_len,d_model", [(1500, 384), (24, 128), (7, 6)])
def test_sinusoidal_positions_match_jax(seq_len, d_model):
    got = rope.sinusoidal_positions(seq_len, d_model)
    want = np.asarray(jrope.sinusoidal_positions(seq_len, d_model))
    assert got.dtype == torch.float32 and got.shape == (seq_len, d_model)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(rope.sinusoidal_rows(torch.tensor(seq_len - 1), d_model), got[-1])
