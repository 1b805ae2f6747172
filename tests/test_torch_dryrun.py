"""The port's dry run and its accounting (``repro_torch.launch.dryrun``,
``repro_torch.analysis.op_analysis`` and ``op_top``) against the JAX
package's: the production mesh, every config's input specs and a train
cell's argument bytes a position, the counted FLOPs of the dense smoke
config's steps against XLA's compiled ones, the ``meta`` run against the
CPU run op for op, the collectives of a meshed step against a count
derived from the model, the command line and the op ranking."""

import dataclasses
import inspect
import json
import math
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.analysis.hlo_analysis import CollectiveOp as JaxCollectiveOp
from repro.analysis.hlo_analysis import analyze_hlo
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.launch import mesh as jax_mesh_module
from repro.models.model import build_model as jax_build_model
from repro.models.transformer import group_pattern as jax_group_pattern
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.train_step import make_train_state_specs as jax_train_state_specs
from repro.train.train_step import make_train_step as jax_make_train_step
from repro.train.train_step import train_state_shapes as jax_train_state_shapes

from repro_torch.analysis import op_top
from repro_torch.analysis.op_analysis import CollectiveOp, analyze_step
from repro_torch.configs import SHAPES, get_config, list_archs, shape_applicable, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist.meshes import make_mesh
from repro_torch.kernels.flash_attention import flash_charge
from repro_torch.launch.dryrun import train_state_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.model import mesh_model, shard_params
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.train.train_step import shard_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = "qwen1.5-0.5b"


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


# -- the production mesh -----------------------------------------------------


def test_production_mesh_is_jaxs_topology_on_meta_positions():
    src = inspect.getsource(jax_mesh_module.make_production_mesh)
    assert "(2, 16, 16) if multi_pod else (16, 16)" in src
    assert '("pod", "data", "model") if multi_pod else ("data", "model")' in src
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    for mesh in (single, multi):
        assert {d.type for d in mesh.devices.flat} == {"meta"}


# -- input specs -----------------------------------------------------------------


def _port_cache_leaves(cfg, caches) -> dict:
    """The port's per-layer caches stacked as JAX's ``_cache_shapes`` lays
    them out: path -> (shape, dtype)."""
    out = {}
    if cfg.is_encdec:
        for key in caches[0]:
            out[(key,)] = ((len(caches),) + tuple(caches[0][key].shape), caches[0][key].dtype)
        return out
    period = len(jax_group_pattern(cfg))
    for j in range(period):
        layers = caches[j::period]
        kind = "attn" if "k" in layers[0] else "ssm"
        for key, t in layers[0].items():
            assert all(tuple(c[key].shape) == tuple(t.shape) for c in layers)
            out[(f"g{j}", kind, key)] = ((len(layers),) + tuple(t.shape), t.dtype)
    return out


def _jax_leaves(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(k.key for k in path): (tuple(x.shape), x.dtype) for path, x in flat}


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    bundle = jax_build_model(jcfg, types.SimpleNamespace(shape={"data": 16, "model": 16}))
    model = build_model(cfg, device="meta")
    for name in SHAPES:
        want = bundle.input_specs(JSHAPES[name])
        got = model.input_specs(SHAPES[name])
        assert sorted(got) == sorted(want), name
        for key in want:
            if key == "caches":
                jl = _jax_leaves(want["caches"])
                pl = _port_cache_leaves(cfg, got["caches"])
                assert sorted(pl) == sorted(jl), name
                for path in jl:
                    assert pl[path][0] == jl[path][0], (name, path)
                    assert _dtype_name(pl[path][1]) == str(jl[path][1]), (name, path)
                continue
            assert tuple(got[key].shape) == tuple(want[key].shape), (name, key)
            assert _dtype_name(got[key].dtype) == str(want[key].dtype), (name, key)
            assert got[key].is_meta


def test_meshed_input_specs_hold_each_positions_caches():
    cfg = smoke_config(DENSE)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
    meshed = mesh_model(build_model(cfg, device="meta", mesh=mesh), mesh)
    shape = ShapeConfig("d", 64, 8, "decode")
    got = meshed.input_specs(shape)
    assert tuple(got["tokens"].shape) == (8, 1) and got["pos"].dim() == 0
    assert len(got["caches"]) == 4
    for pos in got["caches"]:  # 4 of the 8 rows, one of the 2 KV heads
        assert [tuple(c["k"].shape) for c in pos] == [(4, 64, 1, cfg.head_dim)] * cfg.num_layers


# -- argument bytes a position -------------------------------------------------


def _jax_block_bytes(shapes, specs, mesh_shape) -> int:
    leaves = jax.tree.leaves(shapes)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for sds, spec in zip(leaves, spec_leaves):
        n = 1
        entries = tuple(spec) + (None,) * len(sds.shape)
        for d, e in zip(sds.shape, entries):
            axes = () if e is None else (e,) if isinstance(e, str) else tuple(e)
            n *= d // math.prod(mesh_shape[a] for a in axes)
        total += n * np.dtype(sds.dtype).itemsize
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_argument_bytes_a_position_equal_jax(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        bundle = jax_build_model(jcfg, types.SimpleNamespace(shape=dict(mesh.shape)))
        jopt = JaxAdamWConfig(moment_dtype=jcfg.optimizer_moment_dtype)
        want = _jax_block_bytes(jax_train_state_shapes(bundle, jopt),
                                jax_train_state_specs(bundle), mesh.shape)
        model = build_model(cfg, device="meta", dtype=torch.float32, compute_dtype=cfg.dtype,
                            mesh=mesh)
        got = train_state_bytes(model, AdamWConfig(moment_dtype=cfg.optimizer_moment_dtype),
                                mesh)
        assert got == want, arch


def test_train_state_bytes_are_a_built_positions():
    from repro_torch.train import train_state_shapes

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree.values())

    cfg = smoke_config("dbrx-132b")
    mesh = make_mesh((2, 4), ("data", "model"), devices=["meta"] * 8)
    model = build_model(cfg, device="meta", dtype=torch.float32, mesh=mesh)
    opt = AdamWConfig(moment_dtype="bfloat16")
    state = train_state_shapes(model, opt, mesh)
    for i in range(mesh.size):  # every position holds as many bytes
        built = (nbytes(state.params[i]) + nbytes(state.opt["m"][i]) + nbytes(state.opt["v"][i])
                 + 2 * 4)
        assert train_state_bytes(model, opt, mesh) == built, i


def _position_caches(arch, shape_name, mesh):
    """Position 0's decode caches of a production cell, as ``build_cell``
    lays them out (no step counted)."""
    meshed = mesh_model(build_model(get_config(arch), device="meta", mesh=mesh), mesh)
    shape = SHAPES[shape_name]
    if shape.global_batch % meshed.ctx.n_batch:
        meshed = meshed.with_batch_replicated()
    return meshed.input_specs(shape)["caches"][0]


def _nbytes(caches, keys=None) -> int:
    return sum(t.numel() * t.element_size() for layer in caches for k, t in layer.items()
               if keys is None or k in keys)


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_decode_cache_bytes_a_position_are_the_cache_specs_blocks(shape_name):
    """Every config's applicable decode cell on the (16, 16) ``meta``
    production mesh: position 0 holds, leaf for leaf, the bytes of the
    blocks JAX's ``_cache_specs`` gives it of ``_cache_shapes``.  yi-6b's
    ``decode_32k`` holds 8 rows x 2048 slots x 4 KV heads x 128 x k and v x
    2 bytes x 32 layers; jamba's ``long_500k`` attention layers 2048 slots
    (the sequence over data x model) x 8 heads x 128 x 2 x 2 bytes x 9."""
    mesh = make_production_mesh()
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        if not shape_applicable(cfg, SHAPES[shape_name])[0]:
            continue
        bundle = jax_build_model(jcfg, types.SimpleNamespace(shape=dict(mesh.shape)))
        jshape = JSHAPES[shape_name]
        want = _jax_block_bytes(bundle._cache_shapes(jshape), bundle._cache_specs(jshape),
                                mesh.shape)
        caches = _position_caches(arch, shape_name, mesh)
        assert _nbytes(caches) == want, arch
    if shape_name == "decode_32k":
        assert _nbytes(_position_caches("yi-6b", shape_name, mesh)) == 1_073_741_824
    else:
        jamba = _position_caches("jamba-1.5-large-398b", shape_name, mesh)
        assert _nbytes(jamba, ("k", "v")) == 2048 * 8 * 128 * 2 * 2 * 9 == 75_497_472


# -- counts against XLA's, and meta against the CPU ----------------------------

B, S = 2, 32


@pytest.fixture(scope="module")
def jax_flops():
    """analyze_hlo's flops of JAX's dense smoke train step, prefill and decode
    step, compiled for the one CPU device."""
    jcfg = jax_smoke_config(DENSE)
    bundle = jax_build_model(jcfg, None)
    out = {}
    for kind in ("train", "prefill", "decode"):
        specs = bundle.input_specs(JaxShapeConfig("cell", S, B, kind))
        if kind == "train":
            opt = JaxAdamWConfig(moment_dtype=jcfg.optimizer_moment_dtype)
            fn, args = jax_make_train_step(bundle, opt), (jax_train_state_shapes(bundle, opt), specs)
        else:
            fn = bundle.prefill if kind == "prefill" else bundle.serve_step
            args = (bundle.shapes(), specs)
        out[kind] = analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())["flops"]
    return out


def _dense_steps(device):
    """The dense smoke config's three steps on ``device``, each as
    ``(fn, args)``, with seeded inputs."""
    cfg = smoke_config(DENSE)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(device)
    model = build_model(cfg, device=device, dtype=torch.float32)
    opt = AdamWConfig(moment_dtype=cfg.optimizer_moment_dtype)
    state = init_train_state(model, opt)
    caches = model.new_caches(B, S)
    return model, {
        "train": (make_train_step(model, opt), (state, {"tokens": tokens, "targets": tokens})),
        "prefill": (lambda t: model.prefill(t), (tokens,)),
        "plain_prefill": (lambda t: model.prefill(t, use_kernel=False), (tokens,)),
        "decode": (lambda t, c: model.serve_step(t, S - 1, c), (tokens[:, :1], caches)),
    }


@pytest.fixture(scope="module")
def counted():
    out = {}
    for device in ("cpu", "meta"):
        model, steps = _dense_steps(device)
        out[device] = {k: analyze_step(fn, *args) for k, (fn, args) in steps.items()}
    out["model"] = model
    return out


def test_counted_flops_agree_with_xla(jax_flops, counted):
    """Train and decode: equal.  Prefill: JAX's model unembeds every
    position and keeps the last (``logits[:, -1]``); the port unembeds the
    last only, so JAX counts 2 B (S - 1) d V more, and nothing else."""
    cfg = counted["model"].cfg
    cpu = counted["cpu"]
    assert cpu["train"]["flops"] == jax_flops["train"]
    assert cpu["decode"]["flops"] == jax_flops["decode"]
    dropped = 2 * B * (S - 1) * cfg.d_model * cfg.vocab_size
    assert cpu["prefill"]["flops"] == jax_flops["prefill"] - dropped


def test_meta_run_counts_the_cpu_runs_ops(counted):
    cpu, meta = counted["cpu"], counted["meta"]
    for kind in ("train", "decode", "plain_prefill"):
        for key in ("flops", "bytes", "collectives", "kernels"):
            assert meta[kind][key] == cpu[kind][key], (kind, key)
        assert meta[kind]["memory"] == cpu[kind]["memory"], kind
    # the prefill's attention is the flash kernel's charge on meta, its plain
    # version's ops on the CPU; everything else is the same ops
    cfg = counted["model"].cfg
    charge = meta["prefill"]["kernels"]["flash_attention"]
    flops, nbytes = flash_charge(B, S, S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 4,
                                 True)
    assert charge == {"calls": cfg.num_layers, "flops": cfg.num_layers * flops,
                      "bytes": cfg.num_layers * nbytes}
    assert cpu["prefill"]["kernels"] == {}
    plain = meta["plain_prefill"]
    attn_flops = plain["flops"] - (meta["prefill"]["flops"] - charge["flops"])
    assert attn_flops == cfg.num_layers * 2 * 2 * B * cfg.num_heads * S * S * cfg.head_dim


def test_argument_and_output_bytes_of_the_train_step(counted):
    cpu = counted["cpu"]["train"]["memory"]
    model = counted["model"]
    n = model.num_params()
    state_bytes = 3 * 4 * n + 2 * 4  # float32 params and moments, two counters
    # the batch's tokens and targets are one int64 tensor: its storage once
    assert cpu["argument_size_in_bytes"] == state_bytes + B * S * 8
    assert cpu["output_size_in_bytes"] >= state_bytes - 8
    assert cpu["total_hbm_bytes"] == (cpu["argument_size_in_bytes"]
                                      + cpu["output_size_in_bytes"]
                                      + cpu["temp_size_in_bytes"] - cpu["alias_size_in_bytes"])


# -- collectives on a mesh -------------------------------------------------------


def _expected_collectives(meshed, rows, train: bool) -> dict:
    """kind -> (count, operand bytes a position), from the model's
    structure: the vocabulary-parallel embedding's psum, each layer's two
    row-parallel psums (``wo``, ``down``), then the last position's logits
    gathered over ``model`` (serving), or the vocabulary-parallel loss's
    max and two sums and the batch shards' mean (training), every psum's
    backward, and each replicated leaf's gradient psum."""
    cfg, ctx = meshed.cfg, meshed.ctx
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    act = rows * S * d * 4  # a (rows, S, d) float32 activation
    if not train:
        return {"all-reduce": (1 + 2 * L, (1 + 2 * L) * act),
                "all-gather": (1, rows * v * 4 // ctx.tp)}
    tok = rows * S * 4  # a (rows, S) float32 reduction over the vocabulary
    count = (1 + 2 * L) * 2 + 3 + 2  # forward and backward; max, two sums and their backward
    nbytes = (1 + 2 * L) * 2 * act + 5 * tok
    if ctx.n_batch > 1:  # the mean over the batch shards and its backward
        count, nbytes = count + 2, nbytes + 2 * 4
    for name in meshed.specs:  # the gradient psum of every replicated block
        if any(ctx.mesh.shape[a] > 1 for a in meshed.replica_axes(name)):
            count += 1
            nbytes += meshed.local(name)[0].numel() * 4
    return {"all-reduce": (count, nbytes)}


def _expected_sp_collectives(meshed, rows, train: bool) -> dict:
    """kind -> (count, operand bytes a position) with the sequence-parallel
    residual: the embedding's reduce-scatter onto the sequence slices, each
    layer's two all-gathers of a normed slice (attention, MLP: a slice's
    bytes each) and two reduce-scatters of the row-parallel partials (the
    whole activation's), then the last position's row and the logits'
    vocabulary shards gathered over ``model`` (serving), or the final
    normed slices gathered before the vocabulary-parallel loss's max and
    two sums and the batch shards' mean (training), every all-gather's
    backward a reduce-scatter of the whole, every reduce-scatter's an
    all-gather of a slice, the sums' backward and each replicated leaf's
    gradient psum.  No all-reduce of a (rows, S, d) activation is left."""
    cfg, ctx = meshed.cfg, meshed.ctx
    d, v, L, tp = cfg.d_model, cfg.vocab_size, cfg.num_layers, ctx.tp
    act = rows * S * d * 4  # a (rows, S, d) float32 activation
    if not train:
        return {"reduce-scatter": (1 + 2 * L, (1 + 2 * L) * act),
                "all-gather": (2 * L + 2, 2 * L * act // tp + rows * d * 4 + rows * v * 4 // tp)}
    tok = rows * S * 4  # a (rows, S) float32 reduction over the vocabulary
    pairs = 2 * (1 + 2 * L)  # the forward's gathers and reduce-scatters and their backward's
    count, nbytes = 5, 5 * tok  # max, two sums and their backward
    if ctx.n_batch > 1:  # the mean over the batch shards and its backward
        count, nbytes = count + 2, nbytes + 2 * 4
    for name in meshed.specs:  # the gradient psum of every replicated block
        if any(ctx.mesh.shape[a] > 1 for a in meshed.replica_axes(name)):
            count += 1
            nbytes += meshed.local(name)[0].numel() * 4
    return {"all-gather": (pairs, pairs * act // tp), "reduce-scatter": (pairs, pairs * act),
            "all-reduce": (count, nbytes)}


@pytest.mark.parametrize("shape,sp", [((1, 2), False), ((2, 2), False), ((1, 2), True),
                                      ((2, 2), True)],
                         ids=["shape0", "shape1", "shape0-sp", "shape1-sp"])
def test_collectives_of_a_meshed_step_equal_the_models_count(shape, sp):
    """The smoke config (its residual whole), and with
    ``seq_shard_activations`` (Megatron-SP: each position's sequence slice)."""
    cfg = dataclasses.replace(smoke_config(DENSE), seq_shard_activations=sp)
    n = shape[0] * shape[1]
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * n)
    model = build_model(cfg, device="cpu", dtype=torch.float32, mesh=mesh)
    meshed = shard_params(model, mesh)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    rows = B // shape[0]
    prefill = analyze_step(lambda t: meshed.prefill(t), tokens, num_partitions=n, keep_ops=True)
    opt = AdamWConfig(moment_dtype=cfg.optimizer_moment_dtype)
    state = shard_train_state(model, init_train_state(model, opt), mesh)
    step = make_train_step(model, opt, mesh=mesh)
    train = analyze_step(step, state, {"tokens": tokens, "targets": tokens}, num_partitions=n,
                         keep_ops=True)
    meshed_state = mesh_model(model, mesh)
    meshed_state.shards = state.params
    expected = _expected_sp_collectives if sp else _expected_collectives
    for rec, want in ((prefill, expected(meshed, rows, False)),
                      (train, expected(meshed_state, rows, True))):
        by = rec["collectives"]["by_type"]
        assert {k: (v["count"], v["operand_bytes"]) for k, v in by.items()} == want
        # each op's ring wire bytes are JAX's CollectiveOp's
        wire = {}
        for _, _, operand, kind, _ in rec["ops"]:
            if not operand:
                continue
            base, g = kind[:-1].split("(g=")
            ours = CollectiveOp(base, operand, int(g)).wire_bytes
            assert ours == JaxCollectiveOp(base, operand, int(g)).wire_bytes
            wire[base] = wire.get(base, 0.0) + ours
        for k, v in by.items():
            assert wire[k] == pytest.approx(v["wire_bytes"], rel=1e-12)


def test_a_batch_that_does_not_divide_is_replicated_over_the_batch_axes():
    """``long_500k``'s one row on a mesh with ``data`` > 1: every position
    takes the whole batch (JAX's ``input_shardings`` leave it replicated),
    the ``fsdp`` weights still gathered over ``data``; the logits and a
    decode step those of one device."""
    import dataclasses

    cfg = dataclasses.replace(smoke_config(DENSE), fsdp=True)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    model = build_model(cfg, device="cpu", dtype=torch.float32, mesh=mesh)
    meshed = shard_params(model, mesh)
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=torch.Generator().manual_seed(2))
    with pytest.raises(ValueError, match="does not divide"):
        meshed.prefill(tokens)
    meshed = meshed.with_batch_replicated()
    want, want_caches = model.prefill(tokens, cache_len=S + 1)
    got, caches = meshed.prefill(tokens, cache_len=S + 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    step = tokens[:, :1]
    torch.testing.assert_close(meshed.serve_step(step, S, caches)[0],
                               model.serve_step(step, S, want_caches)[0], rtol=1e-5, atol=1e-5)


# -- the command line and the op ranking ----------------------------------------


def _dryrun(*args, out):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                           "--out", str(out)], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)


JAX_ONLY_KEYS = {"lower_s", "compile_s", "cost_xla", "cost_raw_f32", "hlo_bytes"}


def test_command_line_records_a_production_cell(tmp_path):
    args = ("--arch", DENSE, "--shape", "decode_32k", "--mesh", "single",
            "--set", "num_layers=2", "--keep-ops")
    run = _dryrun(*args, out=tmp_path)
    assert run.returncode == 0, run.stderr[-3000:]
    path = tmp_path / "single" / f"{DENSE}__decode_32k.json"
    rec = json.loads(path.read_text())
    jax_keys = {"arch", "shape", "mesh", "status", "overrides", "step_kind", "n_devices",
                "mesh_shape", "params_total", "params_matmul_total", "params_matmul_active",
                "lower_s", "compile_s", "cost_xla", "cost", "cost_raw_f32", "memory",
                "collectives", "roofline", "hlo_bytes"}
    assert set(rec) == (jax_keys - JAX_ONLY_KEYS) | {"trace_s", "kernels", "counted_depths", "counts"}
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                  "temp_size_in_bytes", "alias_size_in_bytes", "total_hbm_bytes"}
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant",
                                    "hlo_flops_global", "model_flops", "useful_flops_ratio",
                                    "roofline_mfu_bound"}
    assert rec["cost"]["flops"] > 0 and rec["collectives"]["operand_bytes"] > 0
    # op_top's totals are analyze_step's
    ops = tmp_path / "single" / f"{DENSE}__decode_32k.ops.json"
    totals = op_top.totals(json.loads(ops.read_text()))
    assert totals["bytes"] == pytest.approx(rec["cost"]["bytes"], rel=1e-9)
    assert totals["flops"] == pytest.approx(rec["cost"]["flops"], rel=1e-9)
    assert totals["collective_bytes"] == pytest.approx(rec["collectives"]["operand_bytes"],
                                                       rel=1e-9)


def test_command_line_reuses_a_cached_record_and_force_reruns(tmp_path):
    """A cached record is read back as it is, ``--force`` runs the cell
    again: here ``long_500k`` of a full-attention arch, skipped with JAX's
    reason."""
    args = ("--arch", DENSE, "--shape", "long_500k", "--mesh", "single")
    path = tmp_path / "single" / f"{DENSE}__long_500k.json"
    path.parent.mkdir(parents=True)
    path.write_text(json.dumps({"arch": DENSE, "shape": "long_500k", "mesh": "single",
                                "status": "skipped", "skip_reason": "a cached record"}))
    cached = _dryrun(*args, out=tmp_path)
    assert cached.returncode == 0 and "a cached record" in cached.stdout
    forced = _dryrun(*args, "--force", out=tmp_path)
    assert forced.returncode == 0, forced.stderr[-3000:]
    rec = json.loads(path.read_text())
    ok, reason = jax_shape_applicable(jax_get_config(DENSE), JSHAPES["long_500k"])
    assert not ok
    assert rec == {"arch": DENSE, "shape": "long_500k", "mesh": "single", "status": "skipped",
                   "skip_reason": reason}


def test_a_failing_cell_records_its_error_and_exits_nonzero(tmp_path):
    run = _dryrun("--arch", DENSE, "--shape", "decode_32k", "--mesh", "single",
                  "--set", "d_ff=-8", out=tmp_path)
    assert run.returncode != 0
    rec = json.loads((tmp_path / "single" / f"{DENSE}__decode_32k.json").read_text())
    assert rec["status"] == "error" and rec["trace"] and rec["error"]


def test_op_top_ranks_a_steps_ops(counted, capsys):
    model, steps = _dense_steps("cpu")
    fn, args = steps["train"]
    rec = analyze_step(fn, *args, keep_ops=True)
    totals = op_top.totals(rec["ops"])
    assert totals["bytes"] == pytest.approx(rec["bytes"], rel=1e-12)
    assert totals["flops"] == rec["flops"]
    op_top.report(rec["ops"], 5)
    out = capsys.readouterr().out
    assert "top ops by HBM bytes" in out and "top matmuls by FLOPs" in out
    assert "models/" in out
