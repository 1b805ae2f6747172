"""repro_torch front door (``MRMRSelector``) vs the JAX selector on the CPU.

Every registered criterion × the ``reference`` / ``conventional`` /
``alternative`` engines on ``CorralSource(1500, 24, seed=3)``: selections
exact, gains and relevance within ``rtol=1e-5, atol=1e-6``.  The JAX side
runs without a mesh on one device.
"""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
from repro.core import selector as jselector
from repro.core.mrmr import MRMRResult as JMRMRResult
from repro.core.scores import MIScore as JMIScore
from repro.core.scores import PearsonMIScore as JPearsonMIScore
from repro.core.selector import MRMRSelector as JSelector
from repro.core.selector import plan_selection as jplan_selection
from repro.core.selector import register_engine as jregister_engine
from repro.data.sources import ArraySource as JArraySource
from repro.data.sources import CorralSource as JCorralSource

import repro_torch
from repro_torch import (
    ArraySource,
    MIScore,
    MRMRResult,
    MRMRSelector,
    PearsonMIScore,
    available_criteria,
    plan_selection,
)
from repro_torch.core import selector as tselector
from repro_torch.core.selector import available_encodings, check_num_select, register_engine

RTOL, ATOL = 1e-5, 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corral():
    return JCorralSource(1500, 24, seed=3).materialize()


@pytest.mark.parametrize("engine", ["reference", "conventional", "alternative"])
@pytest.mark.parametrize("criterion", available_criteria())
def test_criterion_engine_matches_jax(corral, criterion, engine):
    X, y = corral
    t = MRMRSelector(5, score=MIScore(2, 2), encoding=engine, criterion=criterion,
                     device="cpu").fit(X, y)
    j = JSelector(5, score=JMIScore(2, 2), encoding=engine, criterion=criterion,
                  devices=1).fit(X, y)
    assert j.plan_.mesh_shape == ()
    np.testing.assert_array_equal(t.selected_, j.selected_)
    np.testing.assert_allclose(t.scores_, j.scores_, rtol=RTOL, atol=ATOL)
    if criterion == "miq":
        # The quotient rel / mean_red divides by redundancies of ~1e-3 nats,
        # amplifying MI rounding into the gain; hold the MI-valued divisor
        # rel_k / g_k = max(mean_red_k, 1e-4) to the stated tolerance.
        np.testing.assert_allclose(t.scores_[t.selected_] / t.gains_,
                                   j.scores_[j.selected_] / j.gains_,
                                   rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(t.gains_, j.gains_, rtol=RTOL, atol=ATOL)
    assert t.selected_.dtype == np.int32 and t.gains_.dtype == np.float32
    assert (t.result_.engine, t.result_.criterion) == (engine, criterion)


@pytest.mark.parametrize(
    "shape,encoding", [((1500, 24), "conventional"), ((24, 1500), "alternative"),
                       ((100, 100), "conventional")],
)
def test_plan_follows_aspect_rule_like_jax(shape, encoding):
    from repro.core.selector import plan_selection as jplan

    assert plan_selection(shape, device="cpu").encoding == encoding
    assert jplan(shape, devices=1).encoding == encoding


def test_auto_plan_and_read_side(corral):
    X, y = corral
    sel = MRMRSelector(4, device="cpu").fit(X, y)  # score inferred: MI(2, 2)
    jsel = JSelector(4, devices=1).fit(X, y)
    assert sel.plan_.encoding == jsel.plan_.encoding == "conventional"
    assert sel.plan_.score == MIScore(2, 2)
    np.testing.assert_array_equal(sel.selected_, jsel.selected_)
    np.testing.assert_array_equal(sel.ranking_, jsel.ranking_)
    np.testing.assert_array_equal(sel.get_support(), jsel.get_support())
    np.testing.assert_array_equal(sel.get_support(indices=True),
                                  jsel.get_support(indices=True))
    np.testing.assert_array_equal(sel.transform(X), X[:, sel.selected_])
    Xt = torch.from_numpy(X)
    assert torch.equal(sel.transform(Xt), Xt[:, torch.from_numpy(sel.selected_).long()])
    assert sel.n_features_in_ == 24


def test_wide_plans_alternative(corral):
    X, y = corral
    Xw, yw = np.ascontiguousarray(X[:10]), y[:10]  # 10 observations x 24 features
    sel = MRMRSelector(3, device="cpu").fit(Xw, yw)
    jsel = JSelector(3, devices=1).fit(Xw, yw)
    assert sel.plan_.encoding == jsel.plan_.encoding == "alternative"
    np.testing.assert_array_equal(sel.selected_, jsel.selected_)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MRMRSelector(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MRMRSelector(3, encoding="streaming")


# The mesh knobs, once refused: each fits on a CPU mesh (device positions
# repeat "cpu") like the one-device fit, or raises the JAX selector's own
# error.  The JAX side runs one device; "cpu" lists stand for its devices.
@pytest.mark.parametrize(
    "knob", [dict(mesh=object()), dict(devices=4), dict(devices=2),
             dict(feat_axes=("model", "pod")), dict(devices=8), dict(obs_axes=("data", "pod")),
             dict(obs_axes=("rows",)), dict(feat_axes="cols"), dict(devices=["cpu"] * 2),
             dict(devices=["cpu"] * 4), dict(devices=["cpu"] * 3, obs_axes=("rows",)),
             dict(mesh="data2"), dict(mesh="grid2x2")],
)
def test_unported_knobs_raise(corral, knob):
    from repro_torch.dist.meshes import Mesh, make_mesh

    X, y = corral
    meshes = dict(data2=((2,), ("data",)), grid2x2=((2, 2), ("data", "model")))
    if knob.get("mesh") in meshes:
        knob = dict(mesh=make_mesh(*meshes[knob["mesh"]], devices=["cpu"] * 4))
    jknob = {k: v for k, v in knob.items() if not isinstance(v, (list, Mesh))}
    try:
        JSelector(3, **jknob).fit(X, y)
    except Exception as e:  # noqa: BLE001 - the port must raise what JAX raises
        with pytest.raises(type(e), match=str(e).replace("(", r"\(").replace(")", r"\)")):
            MRMRSelector(3, device="cpu", **knob).fit(X, y)
        return
    one = MRMRSelector(3, device="cpu").fit(X, y)
    got = MRMRSelector(3, device="cpu", **knob).fit(X, y)
    np.testing.assert_array_equal(got.selected_, one.selected_)
    assert np.array_equal(got.gains_, one.gains_)  # bitwise
    j = JSelector(3, devices=1).fit(X, y)
    np.testing.assert_array_equal(got.selected_, j.selected_)
    np.testing.assert_allclose(got.gains_, j.gains_, rtol=RTOL, atol=ATOL)
    n_dev = len(knob["devices"]) if isinstance(knob.get("devices"), list) else 1
    if "mesh" in knob:
        assert got.mesh_ is knob["mesh"] and got.plan_.num_shards > 1
    elif n_dev > 1:  # tall data: the observation-sharded engine on all positions
        assert got.plan_.encoding == "conventional" and got.plan_.num_shards == n_dev
        assert got.mesh_.size == n_dev
    else:
        assert got.mesh_ is None and got.plan_.mesh_shape == ()


def test_one_device_knobs_fit_like_jax(corral):
    X, y = corral
    kw = dict(devices=1, obs_axes="data", feat_axes=("model",), block=16)
    t = MRMRSelector(4, device="cpu", spill_budget_bytes=None, **kw).fit(X, y)
    j = JSelector(4, **kw).fit(X, y)
    np.testing.assert_array_equal(t.selected_, j.selected_)


def test_hosts_auto_fits_on_one_process(corral):
    X, y = corral
    for hosts in ("auto", 1, None):
        t = MRMRSelector(4, hosts=hosts, device="cpu").fit(X, y)
        j = JSelector(4, hosts=hosts, devices=1).fit(X, y)
        np.testing.assert_array_equal(t.selected_, j.selected_)
    t = MRMRSelector(4, hosts="auto", device="cpu").fit(ArraySource(X, y))
    j = JSelector(4, hosts="auto", devices=1).fit(JArraySource(X, y))
    np.testing.assert_array_equal(t.selected_, j.selected_)
    with pytest.raises(ValueError, match="hosts"):
        MRMRSelector(4, hosts=0, device="cpu")


def test_registered_engine_gets_provenance_from_the_plan(corral):
    """An engine registered from outside that names neither itself nor its
    criterion gets both from the plan, in both packages."""
    X, y = corral

    def probe(X, y, *, num_select, plan):
        return MRMRResult(torch.arange(num_select, dtype=torch.int32),
                          torch.zeros(num_select))

    def jprobe(X, y, *, num_select, plan, mesh):
        return JMRMRResult(np.arange(num_select, dtype=np.int32),
                           np.zeros(num_select, np.float32))

    register_engine("probe")(probe)
    jregister_engine("probe")(jprobe)
    try:
        t = MRMRSelector(3, encoding="probe", device="cpu").fit(X, y)
        j = JSelector(3, encoding="probe", devices=1).fit(X, y)
    finally:
        tselector._ENGINES.pop("probe")
        jselector._ENGINES.pop("probe")
    assert (t.result_.engine, t.result_.criterion) == ("probe", "mid")
    assert (j.result_.engine, j.result_.criterion) == ("probe", "mid")


def _params(fn):
    return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]


# Names of repro.__all__ that come with later modules of the port (ROADMAP
# §1): none since CustomScore, FeatureSelector and mrmr_select were ported.
NOT_YET_PORTED: dict = {}


def test_signatures_and_exports_match_jax():
    jknobs = _params(JSelector)[: [n for n, _, _ in _params(JSelector)].index("hosts") + 1]
    tparams = _params(MRMRSelector)
    assert tparams[: len(jknobs)] == jknobs  # names, order, kinds, defaults
    assert tparams[len(jknobs)][0] == "device"
    tplan = _params(plan_selection)
    assert tplan[:-1] == _params(jplan_selection)
    assert tplan[-1][:2] == ("device", inspect.Parameter.KEYWORD_ONLY)
    for shape in ((1500, 24), (24, 1500)):  # positional devices, then score
        for score, jscore in ((None, None), (PearsonMIScore(), JPearsonMIScore())):
            assert (plan_selection(shape, 1, score, device="cpu").encoding
                    == jplan_selection(shape, 1, jscore).encoding)
    assert set(repro.__all__) - set(NOT_YET_PORTED) <= set(repro_torch.__all__)
    assert not set(NOT_YET_PORTED) & set(repro_torch.__all__)
    assert repro_torch.__version__ == repro.__version__
    for name in repro_torch.__all__:
        assert hasattr(repro_torch, name), name


class TestGuards:
    def test_num_select_bounds(self, corral):
        X, y = corral
        for bad in (0, 25):
            with pytest.raises(ValueError, match="num_select"):
                MRMRSelector(bad, device="cpu").fit(X, y)
        with pytest.raises(ValueError, match="out of range"):
            check_num_select(3, 2)

    def test_continuous_features_raise(self, corral):
        X, y = corral
        with pytest.raises(ValueError, match="continuous"):
            MRMRSelector(3, score=MIScore(2, 2), device="cpu").fit(X.astype(np.float32), y)

    def test_negative_categories_raise(self, corral):
        X, y = corral
        Xn = X.astype(np.int32)
        Xn[0, 0] = -1
        with pytest.raises(ValueError, match="negative category"):
            MRMRSelector(3, device="cpu").fit(Xn, y)
        with pytest.raises(ValueError, match="negative category"):
            JSelector(3, devices=1).fit(Xn, y)

    def test_shapes_and_missing_target(self, corral):
        X, y = corral
        with pytest.raises(ValueError, match="bad shapes"):
            MRMRSelector(3, device="cpu").fit(X, y[:-1])
        with pytest.raises(ValueError, match="y is required"):
            MRMRSelector(3, device="cpu").fit(X)

    def test_unknown_encoding(self, corral):
        X, y = corral
        with pytest.raises(ValueError, match="unknown encoding"):
            MRMRSelector(3, encoding="hexagonal", device="cpu").fit(X, y)
        # "grid" is registered: one device runs the degenerate 1x1 grid.
        assert available_encodings() == (
            "alternative", "conventional", "grid", "reference", "streaming")
        g = MRMRSelector(3, encoding="grid", device="cpu").fit(X, y)
        assert (g.plan_.mesh_shape, g.result_.engine) == ((1, 1), "grid")
        np.testing.assert_array_equal(g.selected_, MRMRSelector(3, device="cpu").fit(X, y).selected_)

    def test_transform_before_fit(self):
        with pytest.raises(RuntimeError, match="fit"):
            MRMRSelector(3, device="cpu").transform(np.zeros((2, 3)))


def test_import_leaves_jax_and_repro_out():
    code = (
        "import sys, repro_torch, repro_torch.launch.select; "
        "import repro_torch.kernels.ops, repro_torch.data.synthetic; "
        "import repro_torch.kernels.binning, repro_torch.kernels.pearson; "
        "import repro_torch.data.binning, repro_torch.core.streaming; "
        "import repro_torch.kernels.flash_attention, repro_torch.models.convert; "
        "import repro_torch.models, repro_torch.serve, repro_torch.launch.serve; "
        "import repro_torch.configs, repro_torch.data.block_cache; "
        "import repro_torch.serve.selection, repro_torch.interop.sklearn; "
        "import repro_torch.core.selection, repro_torch.runtime.resilience; "
        "import repro_torch.launch.serve_select, repro_torch.dist.multihost; "
        "import repro_torch.dist.meshes, repro_torch.launch.select_multihost; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')); print(bad)"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_cli_prints_one_json_line_naming_the_device():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.select", "--rows", "2000",
           "--cols", "30", "--select", "4", "--device", "cpu"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, check=True,
                         timeout=120)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["device"] == "cpu" and rec["encoding"] == "conventional"
    assert len(rec["selected"]) == 4


def test_bool_features_fit_like_jax(corral):
    X, y = corral
    Xb = X.astype(bool)
    t = MRMRSelector(4, device="cpu").fit(Xb, y)
    j = JSelector(4, devices=1).fit(Xb, y)
    np.testing.assert_array_equal(t.selected_, j.selected_)
