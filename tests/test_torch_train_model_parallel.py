"""Training on a model mesh: repro_torch's meshed loss, gradients and AdamW
vs the JAX package.

The smoke configs of qwen1.5-0.5b, yi-6b, minitron-4b (the GELU MLP),
qwen2-vl (embeddings in, M-RoPE; at tp=4 its two KV heads do not divide),
llama4-scout (sigmoid router, shared expert) and dbrx, in float32: the JAX
weights loaded with ``params_from_jax``, then laid out on meshes of
``"cpu"`` positions, ``(data, model)`` = (1, 2), (1, 4) and (2, 2).  The
meshed gradient of each leaf (every block summed over its holders by
``mesh_value_and_grad``) is gathered, restacked with ``params_to_jax`` and
held to ``jax.value_and_grad`` of JAX's single-device bundle (its own
8-device tests fail in the driver's runs) at ``test_torch_train_loss.py``'s
``LOSS_RTOL`` and ``GRAD_REL`` / ``GRAD_FLOOR`` rule: the meshed sums run
in mesh order, never bitwise the one-device ones.

The MoE oracle: the meshed MoE routes each (batch shard, sequence chunk)
block with its own capacity and averages the blocks' load-balance losses
(JAX's ``pmean``), so its aux loss and the router's gradients differ from
a one-device run at any capacity.  The loss without aux is held to JAX at
``capacity_factor=8.0`` (no slot dropped); the aux, the router's
gradients and the whole gradient tree at the configs' 1.25 to the port's
one-device model with ``moe_blockwise_reference`` in place of
``moe_einsum``; one MoE layer's output, aux and gradients to
``jax.value_and_grad`` of JAX's ``moe_einsum`` applied block by block.

Also: the remat modes bitwise, a (2, 1) mesh step bitwise the
data-parallel step, AdamW on blocks against JAX's ``adamw_update``, the
vocabulary-parallel cross-entropy, microbatches, the pipeline's shards and
a step of each of the SSM, hybrid and encoder-decoder families.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.optimizer import adamw_update as jax_adamw_update
from repro.train.optimizer import warmup_cosine as jax_warmup_cosine
from test_torch_train_loss import GRAD_FLOOR, GRAD_REL, LOSS_RTOL, hold_grads
from test_torch_train_step import hold_params
from torch_train_cases import batch_for, jax_pair, jax_value_and_grad, torch_batch
from torch_train_cases import one_torch_thread  # noqa: F401  (autouse)

from repro_torch.configs import smoke_config
from repro_torch.data import ShardedDataPipeline
from repro_torch.dist import make_mesh
from repro_torch.models import build_model, moe, transformer
from repro_torch.models.convert import params_to_jax
from repro_torch.models.layers import cross_entropy_loss, vocab_parallel_nll
from repro_torch.models.model import gather_leaves, mesh_model, shard_leaves
from repro_torch.train import (
    AdamWConfig,
    TrainState,
    gather_train_state,
    global_norm,
    init_train_state,
    make_train_step,
    mesh_value_and_grad,
    shard_adamw_update,
    shard_global_norm,
    shard_train_state,
    train_state_shapes,
    warmup_cosine,
)
from repro_torch.train.train_step import decay_mask

DENSE = ["qwen1.5-0.5b", "yi-6b", "minitron-4b", "qwen2-vl-2b"]
MOE = ["llama4-scout-17b-a16e", "dbrx-132b"]
MESHES = [(1, 2), (1, 4), (2, 2)]
B, S = 4, 32
ROOMY = 8.0  # capacity factor at which no smoke MoE layer drops a slot
# llama4's config accumulates 4 microbatches; the loss and gradient checks
# take one batch, as ``bundle.train_loss`` does.


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), devices=["cpu"] * 4)


def mesh_grads(model, mesh, batch):
    """-> (loss, metrics, every gradient leaf whole in the port's layout)."""
    shards = shard_leaves(mesh_model(model, mesh), model.flat_params())
    loss, metrics, grads = mesh_value_and_grad(model, mesh)(shards, torch_batch(batch))
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        gather_leaves(mesh_model(model, mesh), grads)


def as_jax(model, flat):
    return jax.tree.map(lambda t: t.float().numpy(), params_to_jax(model, flat))


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    bundle, params, model = jax_pair(request.param)
    batch = batch_for(bundle.cfg, B, S, seed=3)
    return model, batch, jax_value_and_grad(bundle, params, batch)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_loss_and_every_gradient_leaf_match_jax(dense, shape):
    model, batch, (want_loss, want_m, want_g) = dense
    loss, metrics, grads = mesh_grads(model, _mesh(shape), batch)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["loss"], want_m["loss"], rtol=LOSS_RTOL)
    assert metrics["aux_loss"] == 0.0
    assert set(grads) == {n for n, _ in model.named_parameters()}
    hold_grads(as_jax(model, grads), want_g, GRAD_REL)


@pytest.fixture(scope="module", params=MOE)
def moe_roomy(request):
    bundle, params, model = jax_pair(request.param, capacity_factor=ROOMY, microbatches=1)
    batch = batch_for(bundle.cfg, B, S, seed=3)
    return model, batch, jax_value_and_grad(bundle, params, batch)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_moe_loss_without_aux_matches_jax(moe_roomy, shape):
    model, batch, (_, want_m, _) = moe_roomy
    loss, metrics, _ = mesh_grads(model, _mesh(shape), batch)
    np.testing.assert_allclose(metrics["loss"], want_m["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, metrics["loss"] + 0.01 * metrics["aux_loss"], rtol=1e-6)


def blockwise_value_and_grad(model, batch, shape, monkeypatch):
    """The port's one-device loss and gradients with its MoE layers run as
    ``moe_blockwise_reference`` over ``shape``'s blocks."""
    n_data, n_model = shape

    def blockwise(p, x, *, cfg):
        return moe.moe_blockwise_reference(p, x, cfg, n_data, n_model)

    with monkeypatch.context() as mp:
        mp.setattr(transformer, "moe_einsum", blockwise)
        leaves = {k: v.detach().requires_grad_(True) for k, v in model.flat_params().items()}
        loss, metrics = model.train_loss(torch_batch(batch), leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return (float(loss.detach()), {k: float(v) for k, v in metrics.items()},
            dict(zip(leaves, grads)))


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("shape,fsdp", [((1, 2), False), ((1, 4), False), ((2, 2), False),
                                        ((2, 2), True)], ids=str)
def test_moe_aux_router_and_every_leaf_match_the_blockwise_reference(arch, shape, fsdp,
                                                                     monkeypatch):
    """At capacity factor 1.25 (slots dropped a block); with ``fsdp`` the
    experts' d_ff lies on ``data`` (the ``ff_axis`` level)."""
    _, _, model = jax_pair(arch, capacity_factor=1.25, fsdp=fsdp, microbatches=1)
    batch = batch_for(model.cfg, B, S, seed=4)
    want_loss, want_m, want_g = blockwise_value_and_grad(model, batch, shape, monkeypatch)
    loss, metrics, grads = mesh_grads(model, _mesh(shape), batch)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["aux_loss"], want_m["aux_loss"], rtol=LOSS_RTOL)
    assert metrics["aux_loss"] > 0
    routers = [k for k in grads if k.endswith("moe.router")]
    assert routers
    for name, g in grads.items():
        scale = float(want_g[name].abs().max())
        err = float((g - want_g[name]).abs().max())
        assert err <= GRAD_REL * scale + GRAD_FLOOR, f"{name}: {err} > {GRAD_REL} * {scale}"
        if name in routers:
            assert scale > 0


def _jax_blockwise_moe(p, x, cfg, n_data, n_model):
    """JAX ``moe_einsum`` on each (batch shard, sequence chunk) block ->
    (y, the blocks' mean aux)."""
    b, s, _ = x.shape
    rows, sl = b // n_data, s // n_model
    outs, aux = [], []
    for i in range(n_data):
        row = []
        for j in range(n_model):
            y, a = jmoe.moe_einsum(p, x[i * rows:(i + 1) * rows, j * sl:(j + 1) * sl], cfg=cfg)
            row.append(y)
            aux.append(a)
        outs.append(jnp.concatenate(row, 1))
    return jnp.concatenate(outs, 0), jnp.mean(jnp.stack(aux))


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=str)
def test_one_moe_layer_and_its_gradients_match_jax_block_by_block(arch, shape):
    """The expert-parallel layer's output and aux, and the gradients of
    ``sum(y * r) + aux`` with respect to its input and every weight, against
    ``jax.value_and_grad`` of JAX's ``moe_einsum`` a block."""
    bundle, params, model = jax_pair(arch, capacity_factor=1.25)
    cfg, jcfg = model.cfg, bundle.cfg
    rng = np.random.default_rng(11)
    x = (0.5 * rng.standard_normal((B, S, cfg.d_model))).astype(np.float32)
    r = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    p = {k: jnp.asarray(v[1]) for k, v in params["g0"]["moe"].items()}

    def objective(p, x):
        y, aux = _jax_blockwise_moe(p, x, jcfg, *shape)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (want_y, want_aux)), (want_gp, want_gx) = jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))

    meshed = mesh_model(model, _mesh(shape))
    flat = {k: v for k, v in model.flat_params().items() if k.startswith("layers.1.moe.")}
    shards = [{k: v.requires_grad_(True) for k, v in sh.items()}
              for sh in shard_leaves(meshed, flat)]
    xt = torch.from_numpy(x).requires_grad_(True)
    ctx = meshed.ctx
    ys, aux = moe.moe_apply(meshed.with_shards(shards), "layers.1.moe.", ctx.split_batch(xt))
    y = ctx.gather_batch(ys, "cpu")
    total = (y * torch.from_numpy(r)).sum() + aux[0]
    leaves = [t for sh in shards for t in sh.values()]
    grads = torch.autograd.grad(total, [xt] + leaves)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    assert all(abs(float(a) - float(want_aux)) <= 1e-6 for a in aux)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_gx), rtol=1e-5, atol=1e-5)
    it = iter(grads[1:])
    per_pos = [{k: next(it) for k in sh} for sh in shards]
    for name in flat:
        summed = ctx.psum([g[name] for g in per_pos], meshed.replica_axes(name))
        got = gather_leaves(meshed, [{name: g} for g in summed])[name]
        want = np.asarray(want_gp[name.rsplit(".", 1)[1]])
        assert np.abs(got.numpy() - want).max() <= GRAD_REL * np.abs(want).max() + GRAD_FLOOR, \
            name


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "dbrx-132b"])
def test_remat_modes_give_bitwise_equal_meshed_gradients(arch):
    batch = batch_for(smoke_config(arch), B, S, seed=5)
    runs = {}
    for mode in ("none", "dots", "full"):
        _, _, model = jax_pair(arch, remat=mode, microbatches=1)
        runs[mode] = mesh_grads(model, _mesh((2, 2)), batch)
    loss, _, grads = runs["none"]
    for mode in ("dots", "full"):
        assert runs[mode][0] == loss
        for k, g in grads.items():
            assert torch.equal(runs[mode][2][k], g), (mode, k)


def _batches(vocab, steps, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": torch.from_numpy(rng.integers(0, vocab, (B, S)).astype(np.int32)),
             "targets": torch.from_numpy(rng.integers(0, vocab, (B, S)).astype(np.int32))}
            for _ in range(steps)]


def test_a_21_mesh_step_is_bitwise_the_data_parallel_step():
    """(data, model) = (2, 1): each data position runs the one-device
    model's operations on its rows, the replicated leaves' gradients are
    summed over ``data`` in mesh order, the norm counts each leaf once: the
    (2,)-position data-parallel step, bit for bit."""
    _, _, model = jax_pair("qwen1.5-0.5b")
    cfg = AdamWConfig(learning_rate=warmup_cosine(1e-3, 1, 10))
    mesh = make_mesh((2, 1), ("data", "model"), devices=["cpu"] * 2)
    meshed = make_train_step(model, cfg, mesh=mesh)
    dp = make_train_step(model, cfg, mesh=make_mesh((2,), ("data",), devices=["cpu"] * 2))
    a = init_train_state(model, cfg, mesh)
    b = TrainState.create(model.flat_params(), cfg)
    for batch in _batches(model.cfg.vocab_size, 2):
        a, ma = meshed(a, batch)
        b, mb = dp(b, batch)
        for key in ("total_loss", "loss", "grad_norm", "lr"):
            assert torch.equal(ma[key], mb[key]), key
    whole = gather_train_state(model, a, mesh)
    assert int(whole.step) == int(b.step) == 2 and int(whole.opt["count"]) == 2
    for k in b.params:
        assert torch.equal(whole.params[k], b.params[k]), k
        assert torch.equal(whole.opt["m"][k], b.opt["m"][k])
        assert torch.equal(whole.opt["v"][k], b.opt["v"][k])
    for sh in a.params[1:]:  # the replicas stay equal
        assert all(torch.equal(sh[k], a.params[0][k]) for k in sh)


def _hold_tree(got, want, rtol, scale_atol=0.0, atol=0.0):
    """Each leaf within ``rtol`` plus ``scale_atol`` of its largest value."""
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for p in path:
            node = node[p.key]
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(node.float().numpy(), w, rtol=rtol,
                                   atol=atol + scale_atol * np.abs(w).max(),
                                   err_msg="/".join(p.key for p in path))


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_two_adamw_steps_on_blocks_match_jax_on_the_gathered_trees(moment_dtype):
    """``shard_adamw_update`` on (2, 2) blocks of the qwen smoke weights
    (fsdp: the matrices sharded over both axes, the norms replicated over
    all four positions) against JAX's ``adamw_update`` on the gathered
    trees, restacked into its layout (where it decides weight decay); the
    norm counts a replicated leaf once.  The norm is summed in another order
    than JAX's, so the clip scale may differ by a float32 rounding: the
    moments are held to ``1e-6`` of each leaf's largest value (the second
    step's ``b1 m + (1 - b1) g`` cancels to far below it) beside ``1e-6``
    relative, the bfloat16 ones beside a bf16 rounding (``2^-7``) either
    side."""
    _, _, model = jax_pair("qwen1.5-0.5b", fsdp=True)
    mesh = _mesh((2, 2))
    meshed = mesh_model(model, mesh)
    owners = {k: meshed.owners(k) for k in meshed.specs}
    assert len(owners["top.final_norm.w"]) == 1 and len(owners["layers.0.attn.wq"]) == 4
    tcfg = AdamWConfig(learning_rate=warmup_cosine(1e-2, 1, 10), moment_dtype=moment_dtype,
                       grad_clip_norm=5.0)
    jcfg = JaxAdamWConfig(learning_rate=jax_warmup_cosine(1e-2, 1, 10),
                          moment_dtype=moment_dtype, grad_clip_norm=5.0)
    params = model.flat_params()
    jp = jax.tree.map(jnp.asarray, as_jax(model, params))
    jopt = jax_adamw_init(jp, jcfg)
    state = TrainState.create(shard_leaves(meshed, params), tcfg)
    opt, shards = state.opt, state.params
    rng = np.random.default_rng(2)
    for step in range(2):
        g = {k: torch.from_numpy((rng.standard_normal(v.shape) * 3).astype(np.float32))
             for k, v in params.items()}
        gs = shard_leaves(meshed, g)
        np.testing.assert_allclose(float(shard_global_norm(gs, owners, "cpu")),
                                   float(global_norm(g)), rtol=1e-6)
        every = {f"{k}@{i}": sh[k] for i, sh in enumerate(gs) for k in sh}
        assert float(global_norm(every)) > float(global_norm(g)) * (1 + 1e-3)  # replicas again
        shards, opt, tm = shard_adamw_update(gs, opt, shards, tcfg, owners, decay_mask(model))
        jp, jopt, jm = jax_adamw_update(jax.tree.map(jnp.asarray, as_jax(model, g)), jopt, jp,
                                        jcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])
        assert int(opt["count"]) == int(jopt["count"]) == step + 1
        _hold_tree(params_to_jax(model, gather_leaves(meshed, shards)), jp, rtol=1e-6,
                   atol=1e-7)
        tol = dict(rtol=1e-6 if moment_dtype == "float32" else 2 ** -7, scale_atol=1e-6)
        for mom in ("m", "v"):
            whole = gather_leaves(meshed, opt[mom])
            assert all(str(t.dtype) == f"torch.{moment_dtype}" for t in whole.values())
            _hold_tree(params_to_jax(model, whole), jopt[mom], **tol)


def vocab_parallel_cross_entropy(logits, targets, shards):
    """The mean nll of ``vocab_parallel_nll`` over ``shards`` column
    blocks of ``logits``, reduced over all of them."""
    parts = list(logits.chunk(shards, -1))
    starts = [i * parts[0].shape[-1] for i in range(shards)]
    return vocab_parallel_nll(parts, [targets] * shards, starts)[0].mean()


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_vocab_parallel_cross_entropy_matches_the_gathered_one(shards):
    rng = np.random.default_rng(shards)
    logits = torch.from_numpy((3 * rng.standard_normal((3, 7, 64))).astype(np.float32))
    logits.requires_grad_(True)
    targets = torch.from_numpy(rng.integers(0, 64, (3, 7)))
    want = cross_entropy_loss(logits, targets)
    got = vocab_parallel_cross_entropy(logits, targets, shards)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    g_want, = torch.autograd.grad(want, logits)
    g_got, = torch.autograd.grad(got, logits)
    np.testing.assert_allclose(g_got.numpy(), g_want.numpy(), rtol=1e-5, atol=1e-8)
    # bf16 logits are taken in float32, as cross_entropy_loss takes them
    half = logits.detach().bfloat16()
    np.testing.assert_allclose(float(vocab_parallel_cross_entropy(half, targets, shards)),
                               float(cross_entropy_loss(half, targets)), rtol=1e-6)


def test_vocab_parallel_nll_reduces_only_within_a_group():
    """Two groups of rows, each split over two shards: a reduction over each
    group's shards gives each row its own nll."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
    targets = torch.from_numpy(rng.integers(0, 32, (2, 5)))
    parts = [logits[0:1, :, :16], logits[0:1, :, 16:], logits[1:, :, :16], logits[1:, :, 16:]]

    def reduce(vals, op):
        out = []
        for g in (vals[:2], vals[2:]):
            r = torch.maximum(*g) if op == "max" else g[0] + g[1]
            out += [r, r]
        return out

    nll = vocab_parallel_nll(parts, [targets[:1]] * 2 + [targets[1:]] * 2, [0, 16, 0, 16],
                             reduce)
    want = torch.logsumexp(logits, -1) - torch.gather(logits, -1, targets[..., None])[..., 0]
    for i, n in enumerate(nll):
        np.testing.assert_allclose(n.numpy(), want[i // 2:i // 2 + 1].numpy(), rtol=1e-6)


def test_microbatches_on_the_mesh_match_one_device():
    """``microbatches=2`` on (1, 2): the same rows in the same two parts as
    one device's microbatches; the loss and norm within ``LOSS_RTOL`` of
    the one-device step's, two steps' weights by ``test_torch_train_step``'s
    AdamW sign-flip rule."""
    _, _, model = jax_pair("qwen1.5-0.5b", microbatches=2)
    cfg = AdamWConfig(learning_rate=warmup_cosine(1e-3, 1, 10))
    mesh = _mesh((1, 2))
    a = init_train_state(model, cfg, mesh)
    b = init_train_state(model, cfg)
    meshed, one = make_train_step(model, cfg, mesh=mesh), make_train_step(model, cfg)
    lrs = []
    for batch in _batches(model.cfg.vocab_size, 2, seed=3):
        a, ma = meshed(a, batch)
        b, mb = one(b, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(ma[key]), float(mb[key]), rtol=LOSS_RTOL)
        assert float(ma["aux_loss"]) == 0.0 and float(ma["lr"]) == float(mb["lr"])
        lrs.append(float(mb["lr"]))
    whole = gather_train_state(model, a, mesh)
    hold_params(params_to_jax(model, whole.params), as_jax(model, b.params), lrs)


def test_the_step_takes_the_pipelines_shards():
    """``shards_at(step)`` (each data shard's rows on its position) and the
    global batch (split by the step) give bitwise the same step."""
    _, _, model = jax_pair("yi-6b")
    cfg = AdamWConfig()
    mesh = _mesh((2, 2))
    step = make_train_step(model, cfg, mesh=mesh)
    pipe = ShardedDataPipeline(mesh=mesh, global_batch=B, seq_len=S, vocab=model.cfg.vocab_size)
    assert len(pipe.shards_at(0)) == 2
    state = init_train_state(model, cfg, mesh)
    a, ma = step(state, pipe.shards_at(0))
    b, mb = step(state, pipe.batch_at(0))
    assert torch.equal(ma["total_loss"], mb["total_loss"])
    for sa, sb in zip(a.params, b.params):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_train_state_shapes_on_a_mesh_are_each_positions_blocks():
    _, _, model = jax_pair("qwen2-vl-2b")
    mesh = _mesh((2, 2))
    like = train_state_shapes(model, AdamWConfig(moment_dtype="bfloat16"), mesh=mesh)
    real = init_train_state(model, AdamWConfig(moment_dtype="bfloat16"), mesh)
    assert len(like.params) == len(real.params) == 4
    for lp, rp, lm, rm in zip(like.params, real.params, like.opt["m"], real.opt["m"]):
        for k in rp:
            assert lp[k].is_meta and lp[k].shape == rp[k].shape and lp[k].dtype == rp[k].dtype
            assert lm[k].is_meta and lm[k].shape == rm[k].shape
            assert rm[k].dtype == torch.bfloat16
    assert real.params[0]["layers.0.attn.wq"].shape == (128, 64)  # (d, H D / 2 model)
    assert like.step.is_meta and like.opt["count"].is_meta


def test_shard_and_gather_train_state_invert_each_other_bitwise():
    _, _, model = jax_pair("llama4-scout-17b-a16e", fsdp=True)
    cfg = AdamWConfig()
    state = TrainState.create(model.flat_params(), cfg)
    state.opt["m"] = {k: torch.randn(v.shape) for k, v in state.params.items()}
    mesh = _mesh((2, 2))
    meshed = shard_train_state(model, state, mesh)
    assert [id(sh["top.final_norm.w"]) for sh in meshed.params] != \
        [id(meshed.params[0]["top.final_norm.w"])] * 4  # a copy a position
    back = gather_train_state(model, meshed, mesh)
    for k in state.params:
        assert torch.equal(back.params[k], state.params[k])
        assert torch.equal(back.opt["m"][k], state.opt["m"][k])


@pytest.mark.parametrize("shape", [None, (2, 2)], ids=str)
def test_a_donated_step_is_the_same_step_and_consumes_its_state(shape):
    """``donate=True``: bitwise the step that keeps its input, and the input
    state's leaves are gone (as JAX's donated buffers are)."""
    _, _, model = jax_pair("dbrx-132b", fsdp=True, microbatches=1)
    cfg = AdamWConfig()
    mesh = None if shape is None else _mesh(shape)
    batch = _batches(model.cfg.vocab_size, 1)[0]
    kept, mk = make_train_step(model, cfg, mesh=mesh)(init_train_state(model, cfg, mesh), batch)
    given = init_train_state(model, cfg, mesh)
    took, mt = make_train_step(model, cfg, mesh=mesh, donate=True)(given, batch)
    assert torch.equal(mk["total_loss"], mt["total_loss"])
    trees = [(kept.params, took.params), (kept.opt["m"], took.opt["m"])]
    for a, b in trees:
        for sa, sb in ([(a, b)] if shape is None else zip(a, b)):
            assert list(sa) == list(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    left = [given.params] if shape is None else given.params
    assert all(not d for d in left)
    assert all(not d for d in ([given.opt["v"]] if shape is None else given.opt["v"]))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b", "whisper-tiny"])
def test_other_families_take_a_model_mesh_step(arch):
    """``make_train_step(mesh=)`` takes the SSM, hybrid and
    encoder-decoder families (held in full in
    ``test_torch_train_model_parallel_families.py``): a step on (1, 2)
    gives a finite loss and moves every position's weights."""
    model = build_model(smoke_config(arch), device="cpu", dtype=torch.float32)
    cfg = AdamWConfig(learning_rate=warmup_cosine(1e-3, 1, 10))
    mesh = _mesh((1, 2))
    state = init_train_state(model, cfg, mesh)
    batch = torch_batch(batch_for(model.cfg, 8, 32, seed=8))  # jamba: 8 microbatches
    new, metrics = make_train_step(model, cfg, mesh=mesh)(state, batch)
    assert np.isfinite(float(metrics["loss"])) and int(new.step) == 1
    for old, sh in zip(state.params, new.params):
        assert any(not torch.equal(old[k], sh[k]) for k in sh)
