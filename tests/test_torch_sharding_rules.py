"""The port's sharding rules against the JAX package's, entry for entry:
``logical_to_spec`` over an enumerated set of cases, then, for all 10
configs at full and smoke widths on four meshes, the parameter specs,
``make_train_state_specs`` and the cache and input specs of every
applicable shape cell.  Neither side needs devices: the specs read only
``mesh.shape`` (JAX's ``build_model`` takes a stand-in with a ``shape``,
the port builds its model on the ``meta`` device)."""

import itertools
import types

import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import shape_applicable
from repro.configs import smoke_config as jax_smoke_config
from repro.dist.sharding import ShardingRules as JaxRules
from repro.dist.sharding import logical_to_spec as jax_logical_to_spec
from repro.models.model import build_model as jax_build_model
from repro.train.train_step import make_train_state_specs as jax_train_state_specs

from repro_torch.configs import SHAPES, get_config, list_archs, smoke_config
from repro_torch.dist import PartitionSpec, ShardingRules, logical_to_spec, rules_for
from repro_torch.models import build_model
from repro_torch.models.convert import jax_paths
from repro_torch.train import make_train_state_specs

MESHES = [{"data": 1, "model": 4}, {"data": 2, "model": 4}, {"data": 16, "model": 16},
          {"pod": 2, "data": 2, "model": 2}]
RULE_FIELDS = ("fsdp", "ff", "heads", "kv_heads", "ssm_heads", "vocab", "experts",
               "expert_ff", "act_seq")


def _mesh(shape):
    return types.SimpleNamespace(shape=dict(shape))


def test_partition_spec_normalises_as_jax():
    from jax.sharding import PartitionSpec as P

    for entries in [(), (None,), ("data",), (("data",), None), (("pod", "data"), "model"),
                    ((), "model")]:
        assert tuple(PartitionSpec(*entries)) == tuple(P(*entries)), entries


RULE_SETS = [
    dict(fsdp="data", heads="model", kv_heads="model", vocab="model"),
    # tuple axes, an axis absent from some meshes, an axis two logical names share
    dict(fsdp=("pod", "data"), heads="model", kv_heads="data", vocab=("data", "model"),
         ff="model", experts="expert", expert_ff="data"),
    dict(fsdp="model", ff="model", heads=("model", "data"), vocab="pod"),
]
LOGICALS = [("fsdp", "heads"), ("heads", "fsdp"), ("vocab", "fsdp"), ("fsdp", "kv_heads"),
            ("experts", "none", "expert_ff"), ("experts", "expert_ff", "none"),
            ("none", "ff"), ("ff", "fsdp"), ("kv_heads", "heads", "vocab"), ("none",),
            ("fsdp", "ff", "heads")]
DIMS = [1, 2, 3, 4, 6, 8, 12, 16, 24]


@pytest.mark.parametrize("rules_i", range(len(RULE_SETS)))
def test_logical_to_spec_matches_jax(rules_i):
    fields = RULE_SETS[rules_i]
    port, jax_rules = ShardingRules(**fields), JaxRules(**fields)
    n = 0
    for shape in MESHES + [{"data": 4}, {"model": 3}, {"pod": 2, "data": 3, "expert": 2}]:
        mesh = _mesh(shape)
        for logical in LOGICALS:
            for dims in itertools.product(DIMS, repeat=len(logical)):
                got = logical_to_spec(logical, dims, mesh, port)
                want = jax_logical_to_spec(logical, dims, mesh, jax_rules)
                assert tuple(got) == tuple(want), (shape, logical, dims, got, want)
                n += 1
    assert n > 10_000


@pytest.mark.parametrize("shape", MESHES + [{"data": 8}, {"model": 2}], ids=str)
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("seq", [True, False])
def test_rules_for_matches_jax(shape, fsdp, seq):
    from repro.dist.sharding import rules_for as jax_rules_for

    got = rules_for(_mesh(shape), fsdp=fsdp, seq_shard=seq)
    want = jax_rules_for(_mesh(shape), fsdp=fsdp, seq_shard=seq)
    assert {f: getattr(got, f) for f in RULE_FIELDS} == {f: getattr(want, f) for f in RULE_FIELDS}


def _at(tree, path):
    for key in path:
        tree = tree[key] if isinstance(tree, dict) else getattr(tree, key)
    return tree


def _per_layer(spec):
    """A JAX stacked leaf's spec without its layer axis."""
    return tuple(spec)[1:]


def _check_specs(arch, preset, shape):
    getter = (get_config, jax_get_config) if preset == "full" else (smoke_config, jax_smoke_config)
    cfg, jcfg = getter[0](arch), getter[1](arch)
    mesh = _mesh(shape)
    model = build_model(cfg, device="meta", mesh=mesh)
    bundle = jax_build_model(jcfg, mesh)

    specs, jspecs = model.specs(), bundle.specs()
    paths = jax_paths(model)
    assert set(specs) == set(paths)
    for name, (path, layer) in paths.items():
        want = _at(jspecs, path)
        want = tuple(want) if layer is None else _per_layer(want)
        assert tuple(specs[name]) == want, (name, specs[name], want)

    state, jstate = make_train_state_specs(model), jax_train_state_specs(bundle)
    assert tuple(state.step) == tuple(jstate.step) and tuple(state.opt["count"]) == tuple(
        jstate.opt["count"])
    for moment in ("m", "v"):
        for name, (path, layer) in paths.items():
            want = _at(jstate.opt[moment], path)
            assert tuple(state.opt[moment][name]) == (
                tuple(want) if layer is None else _per_layer(want))
    assert state.params == specs

    for cell in SHAPES.values():
        if not shape_applicable(jcfg, cell)[0]:
            continue
        got, want = model.input_shardings(cell), bundle.input_shardings(cell)
        assert set(got) == set(want), (cell.name, set(got), set(want))
        for key in set(got) - {"caches"}:
            assert tuple(got[key]) == tuple(want[key]), (cell.name, key)
        if cell.kind != "decode":
            continue
        caches, jcaches = got["caches"], want["caches"]
        if cfg.is_encdec:
            for layer in caches:
                assert {k: _per_layer(v) for k, v in jcaches.items()} == {
                    k: tuple(v) for k, v in layer.items()}
            continue
        period = len(jcaches)
        for i, layer in enumerate(caches):
            jl = jcaches[f"g{i % period}"]
            jl = jl["attn"] if "attn" in jl else jl["ssm"]
            assert {k: tuple(v) for k, v in layer.items()} == {
                k: _per_layer(v) for k, v in jl.items()}, (cell.name, i)


@pytest.mark.parametrize("preset", ["full", "smoke"])
@pytest.mark.parametrize("arch", list_archs())
def test_model_specs_match_jax(arch, preset):
    for shape in MESHES:
        _check_specs(arch, preset, shape)


def test_specs_without_a_mesh_replicate_everything():
    model = build_model(smoke_config("yi-6b"), device="meta")
    assert all(tuple(s) == () for s in model.specs().values())
    cell = SHAPES["decode_32k"]
    assert all(tuple(v) == (None,) * 4 for layer in model.cache_specs(cell)
               for v in layer.values())


def test_full_width_specs_shard_what_the_rules_say():
    """Spot checks at full widths, where the smoke widths come out
    replicated: qwen2-vl's KV columns at tp=4 (256 % 4 == 0 though KV = 2),
    dbrx's experts on ``model`` and their d_ff on ``data``."""
    mesh = _mesh({"data": 2, "model": 4})
    specs = build_model(get_config("qwen2-vl-2b"), device="meta", mesh=mesh).specs()
    assert tuple(specs["layers.0.attn.wk"]) == ("data", "model")
    specs = build_model(get_config("dbrx-132b"), device="meta", mesh=mesh).specs()
    assert tuple(specs["layers.0.moe.gate"]) == ("model", None, "data")
    assert tuple(specs["top.embed"]) == ("model", "data")
