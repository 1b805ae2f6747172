"""repro_torch's in-process device mesh vs its one-device fits and the JAX
package's, on the CPU.

Meshes of ``torch.device("cpu")`` positions (2, 4 and 8 of them: a position
may repeat a device) run the mesh engines — shard placement and padding, a
kernel call per shard, the cross-shard sums, the distributed argmax — the
way four positions on one card do.  Every mesh fit is held to two oracles:

* the port's one-device fit of the same data: ``selected`` equal, gains
  bitwise (``torch.equal``; Pearson within ``rtol=1e-4, atol=1e-5``, its
  plain correlation being a matrix product whose rounding moves with the
  shard's row count);
* the JAX package's single-device fit (no mesh: its explicit-mesh tests
  fail with the pinned JAX release, ROADMAP §3.6): ``selected`` equal, gains within
  ``rtol=1e-5, atol=1e-6`` (Pearson ``rtol=1e-4, atol=1e-5``), streaming
  ledgers equal (the state bytes scaled to the padded feature count).

The cases are those of the JAX package's mesh tests
(``tests/multidevice/md_mrmr.py``, ``test_selector.py``,
``test_streaming.py``, ``test_criteria.py``, ``test_io_tax.py``), plus the
layout-independent tie-break, the select CLI on a 2 x 2 mesh and a
two-process gloo fit whose processes each shard blocks over a local
two-position mesh.

Run as a script with ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` /
``REPRO_PROCESS_ID`` set, this file is one worker of that gloo fit.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
CPU8 = ["cpu"] * 8
RTOL, ATOL = 1e-5, 1e-6
P_RTOL, P_ATOL = 1e-4, 1e-5
LAUNCH_TIMEOUT = 300


def _gloo_data():
    from repro_torch.data.synthetic import corral_dataset_np

    return corral_dataset_np(3000, 40, seed=4)


def _gloo_worker() -> None:
    """One process of the two-process fit: the §III host rule across the
    processes, each process's blocks sharded over a local 2-position mesh."""
    from repro_torch import ArraySource, MIScore, MRMRSelector
    from repro_torch.dist.multihost import init_multihost

    from repro_torch import mrmr_streaming
    from repro_torch.dist.meshes import make_mesh
    from repro_torch.dist.multihost import resolve_host_shards

    ctx = init_multihost(timeout=120)
    X, y = _gloo_data()
    sel = MRMRSelector(4, score=MIScore(2, 2), hosts="auto", devices=["cpu"] * 2,
                       block_obs=301, device="cpu").fit(ArraySource(X, y))
    # A tall host grid may also shard features over local devices (40
    # columns padded to 42 over 3): the states join into one full-width
    # state for the cross-host sum.
    spec = resolve_host_shards(*X.shape, 2, ctx.process_id)
    res = mrmr_streaming(ArraySource(X, y), 4, MIScore(2, 2), shards=spec, block_obs=301,
                         device="cpu", mesh=make_mesh((2, 3), ("data", "model"),
                                                      devices=["cpu"] * 6),
                         obs_axes=("data",), feat_axes=("model",))
    print(json.dumps(dict(
        rank=ctx.process_id, selected=sel.selected_.tolist(),
        gains=[float(g) for g in sel.gains_], mesh=sel.mesh_.shape,
        plan=[sel.plan_.obs_axes, sel.plan_.mesh_shape, sel.plan_.block_obs],
        hosts=sel.result_.io["hosts"], grid_selected=res.selected.tolist(),
        grid_gains=[float(g) for g in res.gains])), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    _gloo_worker()
    sys.exit(0)


import jax.numpy as jnp  # noqa: E402
from repro.core import mrmr as jmrmr  # noqa: E402
from repro.core.scores import MIScore as JMIScore  # noqa: E402
from repro.core.scores import PearsonMIScore as JPearsonMIScore  # noqa: E402
from repro.core.selection import FeatureSelector as JFeatureSelector  # noqa: E402
from repro.core.selector import MRMRSelector as JSelector  # noqa: E402
from repro.core.selector import plan_selection as jplan_selection  # noqa: E402
from repro.core.streaming import mrmr_streaming as jstreaming  # noqa: E402
from repro.data.sources import ArraySource as JArraySource  # noqa: E402
from repro.data.synthetic import continuous_wide_dataset, corral_dataset  # noqa: E402

from repro_torch import (  # noqa: E402
    ArraySource,
    CorralSource,
    CustomScore,
    FeatureSelector,
    MIScore,
    MRMRSelector,
    PearsonMIScore,
    mrmr_alternative,
    mrmr_conventional,
    mrmr_grid,
    mrmr_reference,
    mrmr_select,
    mrmr_streaming,
    plan_selection,
)
from repro_torch import dist as tdist  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist.meshes import Mesh, host_mesh, make_mesh  # noqa: E402
from repro_torch.dist.streaming import BlockPlacer  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402


def _mesh(shape, axes):
    return make_mesh(shape, axes, devices=CPU8 + CPU8)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _hold_one(got_sel, got_gains, one_sel, one_gains, pearson=False):
    """The port's one-device oracle: same picks, bitwise gains (Pearson:
    within tolerance)."""
    np.testing.assert_array_equal(_np(got_sel), _np(one_sel))
    if pearson:
        np.testing.assert_allclose(_np(got_gains), _np(one_gains), rtol=P_RTOL, atol=P_ATOL)
    else:
        assert torch.equal(torch.as_tensor(_np(got_gains)), torch.as_tensor(_np(one_gains)))


def _hold_jax(sel, gains, rel, jsel, jgains, jrel, crit="mid", pearson=False):
    """The JAX single-device oracle: same picks, gains within tolerance
    (``miq``: its MI-valued divisor ``rel / gain``, ROADMAP §3.5)."""
    np.testing.assert_array_equal(_np(sel), _np(jsel))
    rtol, atol = (P_RTOL, P_ATOL) if pearson else (RTOL, ATOL)
    if crit == "miq":
        s = _np(sel)
        np.testing.assert_allclose(_np(rel)[s] / _np(gains), _np(jrel)[s] / _np(jgains),
                                   rtol=rtol, atol=atol)
    else:
        np.testing.assert_allclose(_np(gains), _np(jgains), rtol=rtol, atol=atol)


def _hold(got, one, j, crit="mid", pearson=False):
    """Selector fits against both oracles (``j`` a fitted JAX selector)."""
    _hold_one(got.selected_, got.gains_, one.selected_, one.gains_, pearson)
    _hold_jax(got.selected_, got.gains_, got.scores_, j.selected_, j.gains_, j.scores_,
              crit, pearson)


# ---------------------------------------------------------------------------
# the mesh value and the shard arithmetic
# ---------------------------------------------------------------------------

def test_mesh_value_and_make_mesh_checks():
    m = _mesh((2, 4), ("pod", "data"))
    assert m.shape == {"pod": 2, "data": 4} and list(m.shape) == ["pod", "data"]
    assert m.size == 8 and m.axis_names == ("pod", "data")
    assert m.devices.shape == (2, 4) and all(d == torch.device("cpu") for d in m.devices.flat)
    assert m == _mesh((2, 4), ("pod", "data")) and hash(m) == hash(_mesh((2, 4), ("pod", "data")))
    assert m != _mesh((4, 2), ("pod", "data"))
    with pytest.raises(ValueError, match=r"mesh \{'data': 4\} needs 4 devices, have 2"):
        make_mesh((4,), ("data",), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="length mismatch"):
        make_mesh((2, 2), ("data",), devices=CPU8)
    with pytest.raises(ValueError, match="distinct"):
        Mesh(np.array([["cpu"] * 2] * 2, dtype=object), ("a", "a"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((1,), ("data",))  # default devices: the local cards
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((2,), ("data",), devices=["cpu", "cuda:0"])
    dbg = make_debug_mesh(devices=["cpu"] * 4)
    assert dbg.shape == {"data": 2, "model": 2}
    assert {"Mesh", "make_mesh", "host_mesh", "factor_mesh"} <= set(dir(tdist))


def test_host_mesh_places_process_p_at_position_p():
    devs = [torch.device("cpu")] * 4
    hm = host_mesh((2, 2), ("hosts_obs", "hosts_feat"), devices=devs)
    assert hm.shape == {"hosts_obs": 2, "hosts_feat": 2}
    assert host_mesh(devices=devs).shape == {"hosts": 4}
    with pytest.raises(ValueError, match=r"needs 6 hosts, have 4"):
        host_mesh((2, 3), ("a", "b"), devices=devs)


def test_flat_index_grid_devices_windows_and_psum():
    m = _mesh((2, 2, 2), ("pod", "data", "model"))
    assert sharding.axes_tuple("data") == ("data",) and sharding.axes_tuple(None) == ()
    assert sharding.mesh_extent(m, ("pod", "data")) == 4 and sharding.mesh_extent(None, "x") == 1
    coords = dict(pod=1, data=0, model=1)
    assert sharding.flat_axis_index(coords, ("pod", "data"), m) == 2
    assert sharding.flat_axis_index(coords, ("data", "pod"), m) == 1
    grid = sharding.grid_devices(m, ("pod", "data"), ("model",))
    assert len(grid) == 4 and all(len(r) == 2 for r in grid)
    with pytest.raises(ValueError, match="not axes of the mesh"):
        sharding.grid_devices(m, ("rows",), ())
    with pytest.raises(ValueError, match="share an axis"):
        sharding.grid_devices(m, ("data",), ("data",))
    x = torch.arange(10).reshape(5, 2)
    w0 = sharding.shard_window(x, 0, 0, 2, -1)
    assert w0.data_ptr() == x.data_ptr() and w0.tolist() == [[0, 1], [2, 3]]  # a view
    assert sharding.shard_window(x, 0, 2, 2, -1).tolist() == [[8, 9], [-1, -1]]
    assert sharding.shard_window(x, 0, 3, 2, -1).tolist() == [[-1, -1], [-1, -1]]
    assert sharding.shard_window(x, 1, 1, 1, 0).tolist() == [[1], [3], [5], [7], [9]]
    parts = [torch.full((3,), i, dtype=torch.int32) for i in range(4)]
    out = sharding.psum(parts, torch.device("cpu"))
    assert out.tolist() == [6, 6, 6] and out.dtype == torch.int32


# ---------------------------------------------------------------------------
# in-memory engines (tests/multidevice/md_mrmr.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def md():
    rng = np.random.default_rng(0)
    M, N = 512, 24
    X = rng.integers(0, 3, (M, N)).astype(np.int32)
    y = ((X[:, 5] % 2) ^ (rng.random(M) < 0.1)).astype(np.int32)
    X[:, 6] = X[:, 5]  # an exact duplicate: redundancy must suppress it
    return X, y


_JAX_MEMO: dict = {}


def _jax_fit(X, y, L, crit="mid", inc=True, pearson=False, key=None):
    """JAX's single-device reference fit (memoised a module run)."""
    key = (key, L, crit, inc, pearson, X.shape)
    if key not in _JAX_MEMO:
        score = JPearsonMIScore() if pearson else JMIScore(3, 2)
        yy = y.astype(np.float32) if pearson else y
        r = jmrmr.mrmr_reference(jnp.asarray(X.T), jnp.asarray(yy), L, score,
                                 criterion=crit, incremental=inc)
        _JAX_MEMO[key] = tuple(np.asarray(a) for a in (r.selected, r.gains, r.relevance))
    return _JAX_MEMO[key]


ENGINE_CASES = [
    ("conventional", (8,), ("data",)),
    ("conventional", (2, 4), ("pod", "data")),
    ("conventional", (3,), ("data",)),       # 512 rows: the last shard padded
    ("alternative", (8,), ("model",)),
    ("alternative", (5,), ("model",)),       # 24 features: the last shard padded
    ("grid", (4, 2), ("data", "model")),
    ("grid", (2, 4), ("data", "model")),
    ("grid", (3, 3), ("data", "model")),     # padded both ways
]


def _engine_fit(engine, X, y, L, score, mesh, axes, **kw):
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    if engine == "conventional":
        return mrmr_conventional(Xt, yt, L, score, mesh=mesh, obs_axes=axes, **kw)
    if engine == "alternative":
        return mrmr_alternative(Xt.T, yt, L, score, mesh=mesh, feat_axes=axes, **kw)
    return mrmr_grid(Xt, yt, L, score, mesh=mesh, obs_axes=axes[:1], feat_axes=axes[1:], **kw)


@pytest.mark.parametrize("crit,inc", [("mid", True), ("miq", True), ("mid", False),
                                      ("jmi", True), ("cmim", False), ("maxrel", True)])
@pytest.mark.parametrize("engine,shape,axes", ENGINE_CASES)
def test_engine_on_cpu_mesh_matches_one_device_and_jax(md, engine, shape, axes, crit, inc):
    X, y = md
    L, score = 8, MIScore(3, 2)
    got = _engine_fit(engine, X, y, L, score, _mesh(shape, axes), axes, criterion=crit,
                      incremental=inc)
    one = _engine_fit(engine, X, y, L, score, None, axes, criterion=crit, incremental=inc) \
        if engine != "grid" else mrmr_conventional(torch.from_numpy(X), torch.from_numpy(y), L,
                                                   score, criterion=crit, incremental=inc)
    _hold_one(got.selected, got.gains, one.selected, one.gains)
    assert torch.equal(got.relevance, one.relevance)
    assert got.selected.dtype == torch.int32 and got.gains.dtype == torch.float32
    assert (got.engine, got.criterion) == (engine, crit)
    assert got.relevance.shape == (X.shape[1],)
    jsel, jgains, jrel = _jax_fit(X, y, L, crit, inc, key="md")
    _hold_jax(got.selected, got.gains, got.relevance, jsel, jgains, jrel, crit)


def test_uint8_at_256_values_pads_with_a_wider_code():
    """uint8 holds no out-of-range value at 256 categories: padded rows of an
    observation shard widen to int32 and still count nothing."""
    rng = np.random.default_rng(5)
    X = rng.integers(0, 256, (301, 6)).astype(np.uint8)
    X[:, 2] = np.arange(301) % 256
    y = (X[:, 1] > 127).astype(np.int32)
    score = MIScore(256, 2)
    one = mrmr_conventional(torch.from_numpy(X), torch.from_numpy(y), 3, score)
    got = mrmr_conventional(torch.from_numpy(X), torch.from_numpy(y), 3, score,
                            mesh=_mesh((4,), ("data",)))
    _hold_one(got.selected, got.gains, one.selected, one.gains)
    assert torch.equal(got.relevance, one.relevance)


@pytest.mark.parametrize("crit", sorted(__import__("repro_torch").available_criteria()))
def test_every_criterion_on_feature_and_grid_meshes(md, crit):
    """All eight criteria, incremental and the paper's recompute, on a
    feature mesh and a 2-D grid."""
    X, y = md
    jsel, jgains, jrel = _jax_fit(X, y, 6, crit, key="md6")
    one = mrmr_conventional(torch.from_numpy(X), torch.from_numpy(y), 6, MIScore(3, 2),
                            criterion=crit)
    for engine, shape, axes in (("alternative", (3,), ("model",)),
                                ("grid", (2, 3), ("data", "model"))):
        for inc in (True, False):
            got = _engine_fit(engine, X, y, 6, MIScore(3, 2), _mesh(shape, axes), axes,
                              criterion=crit, incremental=inc)
            _hold_one(got.selected, got.gains, one.selected, one.gains)
            _hold_jax(got.selected, got.gains, got.relevance, jsel, jgains, jrel, crit)


def test_alternative_not_divisible_through_feature_selector(md):
    X, y = md
    X23 = np.ascontiguousarray(X[:, :23])  # 23 % 8 != 0
    mesh = _mesh((8,), ("model",))
    fs = FeatureSelector(8, score=MIScore(3, 2), layout="alternative", mesh=mesh,
                         feat_axes=("model",), device="cpu").fit(X23, y)
    one = FeatureSelector(8, score=MIScore(3, 2), layout="alternative", device="cpu").fit(X23, y)
    _hold_one(fs.selected_, fs.gains_, one.selected_, one.gains_)
    jsel, jgains, _ = _jax_fit(X23, y, 8, key="md23")
    np.testing.assert_array_equal(fs.selected_, jsel)
    np.testing.assert_allclose(fs.gains_, jgains, rtol=RTOL, atol=ATOL)


def test_pearson_feature_sharded():
    Xc, yc = continuous_wide_dataset(256, 64, seed=3)
    Xc, yc = np.asarray(Xc, np.float32), np.asarray(yc, np.float32)
    rows = PearsonMIScore().feature_rows(torch.from_numpy(Xc).T)
    one = mrmr_alternative(rows, torch.from_numpy(yc), 6, PearsonMIScore())
    jsel, jgains, jrel = _jax_fit(Xc, yc, 6, pearson=True, key="pearson")
    for n in (8, 5, 2):
        got = mrmr_alternative(torch.from_numpy(Xc).T, torch.from_numpy(yc), 6,
                               PearsonMIScore(), mesh=_mesh((n,), ("model",)))
        _hold_one(got.selected, got.gains, one.selected, one.gains, pearson=True)
        _hold_jax(got.selected, got.gains, got.relevance, jsel, jgains, jrel, pearson=True)


def test_custom_score_feature_sharded(md):
    """A CustomScore runs on the feature-sharded alternative, as in JAX."""
    from repro.core.scores import mrmr_custom_score as jcustom

    from repro_torch import mrmr_custom_score

    X, y = md
    rows = torch.from_numpy(X).T
    one = mrmr_alternative(rows, torch.from_numpy(y), 4, mrmr_custom_score(MIScore(3, 2)))
    got = mrmr_alternative(rows, torch.from_numpy(y), 4, mrmr_custom_score(MIScore(3, 2)),
                           mesh=_mesh((5,), ("model",)))
    _hold_one(got.selected, got.gains, one.selected, one.gains)
    assert torch.isnan(got.relevance).all() and got.relevance.shape == (24,)
    j = jmrmr.mrmr_reference(jnp.asarray(X.T), jnp.asarray(y), 4, jcustom(JMIScore(3, 2)))
    np.testing.assert_array_equal(got.selected.numpy(), np.asarray(j.selected))
    np.testing.assert_allclose(got.gains.numpy(), np.asarray(j.gains), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="discrete MI only"):
        mrmr_grid(torch.from_numpy(X), torch.from_numpy(y), 2, CustomScore(lambda *a: 0.0),
                  mesh=_mesh((2, 2), ("data", "model")))


def test_corral_grid_end_to_end():
    Xb, yb = corral_dataset(2048, 32, seed=7, flip_prob=0.02)
    Xb, yb = np.asarray(Xb, np.int32), np.asarray(yb)
    mesh = _mesh((4, 2), ("data", "model"))
    got = FeatureSelector(8, score=MIScore(2, 2), layout="grid", mesh=mesh,
                          device="cpu").fit(Xb, yb)
    assert len(set(got.selected_.tolist()) & set(range(8))) >= 6
    one = MRMRSelector(8, score=MIScore(2, 2), device="cpu").fit(Xb, yb)
    _hold_one(got.selected_, got.gains_, one.selected_, one.gains_)
    j = JFeatureSelector(8, score=JMIScore(2, 2), layout="conventional").fit(Xb, yb)
    np.testing.assert_array_equal(got.selected_, j.selected_)
    np.testing.assert_allclose(got.gains_, j.gains_, rtol=RTOL, atol=ATOL)
    res = mrmr_select(Xb, yb, 8, score=MIScore(2, 2), layout="grid", mesh=mesh, device="cpu")
    assert res.selected.tolist() == got.selected_.tolist()


@pytest.mark.parametrize("encoding,shape,axes", [
    ("conventional", (8,), ("data",)), ("alternative", (8,), ("model",)),
    ("grid", (4, 2), ("data", "model")), ("reference", (8,), ("data",)),
])
def test_selector_front_door_explicit_mesh(md, encoding, shape, axes):
    X, y = md
    mesh = _mesh(shape, axes)
    got = MRMRSelector(8, score=MIScore(3, 2), encoding=encoding, mesh=mesh,
                       device="cpu").fit(X, y)
    one = MRMRSelector(8, score=MIScore(3, 2), device="cpu").fit(X, y)
    j = JSelector(8, score=JMIScore(3, 2), devices=1).fit(X, y)
    _hold(got, one, j)
    assert got.result_.engine == encoding
    assert got.mesh_ is (mesh if encoding != "reference" else None)
    want = {"conventional": (8,), "alternative": (8,), "grid": (4, 2), "reference": ()}
    assert got.plan_.mesh_shape == want[encoding]


@pytest.mark.parametrize("rows,encoding", [(512, "conventional"), (20, "alternative"),
                                           (1024, "grid")])
def test_selector_auto_plans_its_own_mesh(rows, encoding):
    """No mesh: the selector factors the device list (8 CPU positions)."""
    rng = np.random.default_rng(rows)
    n = 24 if rows < 1024 else 1024
    X = rng.integers(0, 3, (rows, n)).astype(np.int32)
    y = ((X[:, 5] % 2) ^ (rng.random(rows) < 0.1)).astype(np.int32)
    got = MRMRSelector(4, score=MIScore(3, 2), devices=CPU8, device="cpu").fit(X, y)
    assert got.plan_.encoding == encoding and got.plan_.num_shards == 8
    assert got.mesh_.size == 8
    jplan = jplan_selection(X.shape, 8, JMIScore(3, 2))
    assert (got.plan_.encoding, got.plan_.mesh_shape) == (jplan.encoding, jplan.mesh_shape)
    assert (got.plan_.obs_axes, got.plan_.feat_axes) == (jplan.obs_axes, jplan.feat_axes)
    one = MRMRSelector(4, score=MIScore(3, 2), device="cpu").fit(X, y)
    j = JSelector(4, score=JMIScore(3, 2), devices=1).fit(X, y)
    _hold(got, one, j)


def test_explicit_grid_on_one_device_is_1x1_and_devices_beyond_raise(md):
    X, y = md
    g = MRMRSelector(4, score=MIScore(3, 2), encoding="grid", device="cpu").fit(X, y)
    jg = JSelector(4, score=JMIScore(3, 2), encoding="grid", devices=1).fit(X, y)
    assert g.plan_.mesh_shape == jg.plan_.mesh_shape == (1, 1)
    assert g.mesh_.shape == {"data": 1, "model": 1}
    np.testing.assert_array_equal(g.selected_, jg.selected_)
    for bad in (4, 2):
        with pytest.raises(ValueError, match=rf"needs {bad} devices, have 1"):
            MRMRSelector(4, devices=bad, device="cpu").fit(X, y)
        with pytest.raises(ValueError, match=rf"needs {bad} devices, have 1"):
            JSelector(4, devices=bad).fit(X, y)
    with pytest.raises(TypeError, match="has no len"):
        MRMRSelector(4, mesh=object(), device="cpu").fit(X, y)


# ---------------------------------------------------------------------------
# the planner (tests/test_selector.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,devices,score", [
    ((200, 50_000), 8, None), ((100_000, 100), 8, None), ((4096, 4096), 8, None),
    ((4096, 4096), 1, None), ((100_000, 100), 8, "pearson"), ((4096, 4096), 8, "custom"),
    ((4096, 4096), 7, None), ((2000, 4000), 6, None), ((300, 300), 8, None),
])
def test_plan_selection_matches_jax(shape, devices, score):
    from repro.core.scores import CustomScore as JCustomScore

    tscore = dict(pearson=PearsonMIScore(), custom=CustomScore(lambda *a: 0.0)).get(score)
    jscore = dict(pearson=JPearsonMIScore(),
                  custom=JCustomScore(get_result=lambda *a: 0.0)).get(score)
    t = plan_selection(shape, devices, tscore, device="cpu")
    j = jplan_selection(shape, devices, jscore)
    assert (t.encoding, t.obs_axes, t.feat_axes, t.mesh_shape) == (
        j.encoding, j.obs_axes, j.feat_axes, j.mesh_shape)
    if shape == (4096, 4096) and devices == 8 and score is None:
        assert t.encoding == "grid" and t.num_shards == 8
    if devices == 1:
        assert t.encoding != "grid" and t.mesh_shape == ()


def test_mesh_constrains_planning():
    from repro.dist.meshes import make_mesh as jmake_mesh

    mesh, jmesh = make_mesh((1,), ("data",), devices=["cpu"]), jmake_mesh((1,), ("data",))
    t = plan_selection((200, 50_000), mesh, device="cpu")
    # wide data wants the alternative encoding, but the mesh has no feature
    # axis: the observation-sharded job
    assert (t.encoding, t.obs_axes) == ("conventional", ("data",))
    assert jplan_selection((200, 50_000), jmesh).encoding == "conventional"
    # a non-MI score falls back to the score-agnostic reference engine
    assert plan_selection((256, 16), mesh, PearsonMIScore(), device="cpu").encoding == "reference"
    assert jplan_selection((256, 16), jmesh, JPearsonMIScore()).encoding == "reference"


# ---------------------------------------------------------------------------
# the tie-break
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,shape,axes", [
    ("alternative", (4,), ("model",)), ("alternative", (3,), ("model",)),
    ("grid", (2, 2), ("data", "model")), ("grid", (1, 4), ("data", "model")),
])
def test_ties_break_toward_the_smallest_id_on_every_layout(engine, shape, axes):
    """Columns 17 and 5 are copies, the most relevant, in different shards:
    the smaller id is picked first whichever shard holds it."""
    rng = np.random.default_rng(11)
    X = rng.integers(0, 2, (400, 24)).astype(np.int8)
    y = (rng.random(400) < 0.5).astype(np.int32)
    X[:, 5] = y ^ (rng.random(400) < 0.05)
    X[:, 17] = X[:, 5]
    got = _engine_fit(engine, X, y, 3, MIScore(2, 2), _mesh(shape, axes), axes,
                      criterion="maxrel")
    assert got.selected.tolist()[:2] == [5, 17]
    assert got.gains[0] == got.gains[1]
    one = mrmr_reference(torch.from_numpy(X).T, torch.from_numpy(y), 3, MIScore(2, 2),
                         criterion="maxrel")
    _hold_one(got.selected, got.gains, one.selected, one.gains)


# ---------------------------------------------------------------------------
# streaming on a mesh (tests/test_streaming.py, test_criteria.py, test_io_tax.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corral():
    X, y = corral_dataset(2000, 32, seed=1, flip_prob=0.02)
    return np.asarray(X, np.int32), np.asarray(y)


@pytest.fixture(scope="module")
def wide():
    return CorralSource(256, 1024, seed=5).materialize()


def _stream_both(X, y, L, mesh, *, score=None, jscore=None, block_obs=100, crit="mid", q=1,
                 pearson=False, **kw):
    """A mesh streaming fit held to the port's one-device streaming fit and
    JAX's single-device one at the mesh's effective block size; the ledger
    equal to JAX's (state bytes scaled to the padded feature count)."""
    score = score or MIScore(2, 2)
    jscore = jscore or JMIScore(2, 2)
    got = MRMRSelector(L, score=score, block_obs=block_obs, criterion=crit,
                       batch_candidates=q, mesh=mesh, device="cpu", **kw).fit(ArraySource(X, y))
    bo = got.plan_.block_obs
    one = MRMRSelector(L, score=score, block_obs=bo, criterion=crit, batch_candidates=q,
                       device="cpu").fit(ArraySource(X, y))
    j = jstreaming(JArraySource(X, y), L, jscore, block_obs=bo, criterion=crit,
                   batch_candidates=q)
    _hold_one(got.selected_, got.gains_, one.selected_, one.gains_, pearson)
    _hold_jax(got.selected_, got.gains_, got.scores_, j.selected, j.gains, j.relevance, crit,
              pearson)
    gio, jio = dict(got.result_.io), dict(j.io)
    gio.pop("cache", None)
    n = X.shape[1]
    fext = sharding.mesh_extent(mesh, got.plan_.feat_axes)
    npad = -(-n // fext) * fext
    gsb, jsb = gio.pop("state_bytes"), jio.pop("state_bytes")
    assert gio == jio
    if not pearson:
        assert gsb * n == jsb * npad
    assert got.plan_.encoding == "streaming" and got.mesh_ is mesh
    return got


@pytest.mark.parametrize("crit", ["mid", "miq", "jmi", "cmim"])
@pytest.mark.parametrize("shape,axes", [((8,), ("data",)), ((3,), ("data",)),
                                        ((4,), ("model",)), ((3,), ("model",)),
                                        ((2, 2), ("data", "model"))])
def test_streaming_on_mesh_tall(corral, shape, axes, crit):
    X, y = corral
    got = _stream_both(X, y, 5, _mesh(shape, axes), block_obs=200, crit=crit)
    assert got.plan_.block_obs % sharding.mesh_extent(got.mesh_, got.plan_.obs_axes) == 0


@pytest.mark.parametrize("block_obs", [64, 100, 999])
def test_feature_sharded_wide_matches_alternative(wide, block_obs):
    X, y = wide
    got = _stream_both(X, y, 5, _mesh((4,), ("model",)), block_obs=block_obs)
    assert (got.plan_.obs_axes, got.plan_.feat_axes) == ((), ("model",))
    alt = MRMRSelector(5, score=MIScore(2, 2), encoding="alternative", device="cpu").fit(X, y)
    _hold_one(got.selected_, got.gains_, alt.selected_, alt.gains_)


@pytest.mark.parametrize("crit,q", [("miq", 1), ("jmi", 1), ("mid", 4)])
def test_wide_and_2d_streaming_criteria(wide, crit, q):
    X, y = wide
    for shape, axes in (((8,), ("model",)), ((2, 4), ("data", "model"))):
        _stream_both(X, y, 4, _mesh(shape, axes), block_obs=100, crit=crit, q=q)


def test_non_divisible_feature_count_and_2d_block_rounding():
    X, y = CorralSource(200, 30, seed=1).materialize()
    got = _stream_both(X, y, 4, _mesh((4,), ("model",)), block_obs=64)
    assert got.plan_.feat_axes == ("model",)
    X, y = CorralSource(400, 64, seed=6).materialize()
    got = _stream_both(X, y, 5, _mesh((3, 2), ("data", "model")), block_obs=100)
    assert got.plan_.block_obs == -(-100 // 3) * 3


def test_pearson_streaming_on_mesh():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(200, 600)).astype(np.float32)
    y = (0.5 * X[:, 3] + 0.3 * X[:, 10] + 0.1 * rng.normal(size=200)).astype(np.float32)
    for shape, axes in (((4,), ("model",)), ((2,), ("data",)), ((2, 2), ("data", "model"))):
        _stream_both(X, y, 4, _mesh(shape, axes), score=PearsonMIScore(),
                     jscore=JPearsonMIScore(), block_obs=64, pearson=True)


@pytest.mark.parametrize("shape,axes", [((4,), ("data",)), ((4,), ("model",)),
                                        ((2, 2), ("data", "model"))])
def test_binned_streaming_on_mesh(shape, axes):
    """The fused per-shard encode: raw float tiles and sharded edges."""
    rng = np.random.default_rng(23)
    n, f = 256, 200
    y = rng.integers(0, 2, size=n)
    X = rng.normal(size=(n, f))
    for j in range(5):
        X[:, j] += y * (1.8 - 0.3 * j)
    got = MRMRSelector(5, bins=8, block_obs=64, mesh=_mesh(shape, axes),
                       device="cpu").fit(ArraySource(X, y))
    one = MRMRSelector(5, bins=8, block_obs=got.plan_.block_obs, device="cpu").fit(
        ArraySource(X, y))
    j = JSelector(5, bins=8, block_obs=got.plan_.block_obs, devices=1).fit(JArraySource(X, y))
    _hold(got, one, j)
    assert got.plan_.bins == 8


def test_auto_stream_plans_follow_the_aspect_rule(corral, wide):
    X, y = wide
    got = MRMRSelector(5, score=MIScore(2, 2), block_obs=100, devices=["cpu"] * 4,
                       device="cpu").fit(ArraySource(X, y))
    assert (got.plan_.feat_axes, got.plan_.mesh_shape) == (("model",), (4,))
    one = MRMRSelector(5, score=MIScore(2, 2), block_obs=100, device="cpu").fit(ArraySource(X, y))
    _hold_one(got.selected_, got.gains_, one.selected_, one.gains_)
    X, y = corral
    got = MRMRSelector(5, score=MIScore(2, 2), block_obs=100, devices=["cpu"] * 4,
                       device="cpu").fit(ArraySource(X, y))
    assert (got.plan_.obs_axes, got.plan_.mesh_shape) == (("data",), (4,))
    X, y = CorralSource(1024, 1024, seed=2).materialize()
    got = MRMRSelector(3, score=MIScore(2, 2), block_obs=300, devices=["cpu"] * 4,
                       device="cpu").fit(ArraySource(X, y))
    assert (got.plan_.obs_axes, got.plan_.feat_axes, got.plan_.mesh_shape) == (
        ("data",), ("model",), (2, 2))
    assert got.plan_.block_obs == 300


def test_mesh_without_any_shardable_axis_raises(corral):
    X, y = corral
    with pytest.raises(ValueError, match="obs_axes"):
        MRMRSelector(2, score=MIScore(2, 2), mesh=_mesh((2,), ("pipe",)),
                     device="cpu").fit(ArraySource(X, y))


def test_block_placer_on_a_mesh():
    m4 = _mesh((4,), ("data",))
    p = BlockPlacer(100, "cpu", mesh=m4, obs_axes=("data",))
    assert p.block_obs == 100 and BlockPlacer(101, "cpu", mesh=m4, obs_axes="data").block_obs == 104
    tiles = p(np.zeros((37, 3), np.int8), np.zeros(37, np.int8))
    assert len(tiles) == 4 and all(len(r) == 1 for r in tiles)
    assert sum(int(v.sum()) for (_, _, v), in tiles) == 37
    assert all(X.shape == (25, 3) for (X, _, _), in tiles)
    with pytest.raises(ValueError, match="no axis"):
        BlockPlacer(16, "cpu", mesh=_mesh((2,), ("model",)), obs_axes=("data",))
    mf = _mesh((4,), ("model",))
    with pytest.raises(ValueError, match="num_features"):
        BlockPlacer(8, "cpu", mesh=mf, feat_axes=("model",))
    p = BlockPlacer(8, "cpu", num_features=5, mesh=mf, feat_axes=("model",))
    assert p.padded_features == 8 and p.shard_cols == 2
    tiles = p(np.ones((8, 5), np.int8), np.zeros(8, np.int8))
    cols = torch.cat([t[0] for t in tiles[0]], dim=1)
    assert cols[:, :5].all() and not cols[:, 5:].any()  # zero pad columns
    # The wide-regime memory claim: each position holds its feature shard's
    # state rows, not all of them.
    p = BlockPlacer(64, "cpu", num_features=32, mesh=mf, feat_axes=("model",))
    state = p.place_state(MIScore(2, 2).init_state(p.padded_features))
    assert [tuple(s.shape) for s in state[0]] == [(8, 2, 2)] * 4
    edges = p.place_edges(np.zeros((32, 3), np.float32))
    assert [tuple(e.shape) for e in edges[0]] == [(8, 3)] * 4


def test_conditional_streaming_on_meshes(corral, wide):
    X, y = corral
    for crit in ("jmi", "cmim"):
        _stream_both(X, y, 4, _mesh((8,), ("data",)), block_obs=512, crit=crit)
    _stream_both(X, y, 4, _mesh((1, 8), ("data", "model")), block_obs=512, crit="cmim")
    Xw, yw = wide
    got = _stream_both(Xw, yw, 4, _mesh((8,), ("model",)), block_obs=100, crit="jmi")
    alt = MRMRSelector(4, score=MIScore(2, 2), criterion="jmi", encoding="alternative",
                       device="cpu").fit(Xw, yw)
    _hold_one(got.selected_, got.gains_, alt.selected_, alt.gains_)


@pytest.mark.parametrize("case", ["obs_q4_spill", "wide_q4_spill", "grid_q8_spill_readahead"])
def test_io_knobs_on_a_mesh(corral, tmp_path, case):
    """``batch_candidates``, spill and read-ahead on a mesh: bitwise the
    knob-free mesh fit, ledgers equal to JAX's."""
    if case == "obs_q4_spill":
        X, y = corral
        mesh, bo, q, kw = _mesh((8,), ("data",)), 300, 4, dict(spill_dir=str(tmp_path))
    elif case == "wide_q4_spill":
        X, y = CorralSource(300, 256, seed=5).materialize()
        mesh, bo, q, kw = _mesh((8,), ("model",)), 100, 4, dict(spill_dir=str(tmp_path))
    else:
        X, y = CorralSource(400, 64, seed=6).materialize()
        mesh, bo, q = _mesh((2, 4), ("data", "model")), 100, 8
        kw = dict(spill_dir=str(tmp_path), readahead=2)
    plain = MRMRSelector(6, score=MIScore(2, 2), mesh=mesh, block_obs=bo,
                         device="cpu").fit(ArraySource(X, y))
    got = _stream_both(X, y, 6, mesh, block_obs=bo, q=q, **kw)
    _hold_one(got.selected_, got.gains_, plain.selected_, plain.gains_)
    assert got.result_.io["cache"]["parse_passes"] == 1
    assert got.result_.io["passes"] < 6


def test_direct_engine_api_streams_on_a_mesh(corral):
    X, y = corral
    mesh = _mesh((2, 2), ("data", "model"))
    got = mrmr_streaming((X, y), 5, MIScore(2, 2), block_obs=500, device="cpu", mesh=mesh,
                         obs_axes=("data",), feat_axes=("model",))
    one = mrmr_streaming((X, y), 5, MIScore(2, 2), block_obs=500, device="cpu")
    _hold_one(got.selected, got.gains, one.selected, one.gains)
    # A mesh runs where ``device`` says: positions of another kind raise.
    from repro_torch.dist.meshes import check_mesh_kind

    with pytest.raises(ValueError, match="mesh positions are cpu devices"):
        check_mesh_kind(mesh, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="mesh positions are cpu devices"):
        mrmr_streaming((X, y), 5, MIScore(2, 2), block_obs=500, device="meta", mesh=mesh)


@pytest.mark.parametrize("engine", ["conventional", "alternative", "grid"])
def test_in_memory_engines_refuse_data_off_the_mesh_kind(engine):
    """The engines called directly, with data on another device than the
    mesh's positions (``meta`` stands in for a card here; the card test
    uses card tensors): they raise before any shard is placed, rather than
    move the shards to the mesh's device."""
    X = torch.zeros((64, 8), dtype=torch.int8, device="meta")
    y = torch.zeros(64, dtype=torch.int8, device="meta")
    mesh = _mesh((2, 2), ("data", "model"))
    call = dict(
        conventional=lambda: mrmr_conventional(X, y, 3, MIScore(2, 2), mesh=mesh,
                                               obs_axes=("data", "model")),
        alternative=lambda: mrmr_alternative(X.T, y, 3, MIScore(2, 2), mesh=mesh,
                                             feat_axes=("data", "model")),
        grid=lambda: mrmr_grid(X, y, 3, MIScore(2, 2), mesh=mesh),
    )[engine]
    with pytest.raises(ValueError, match="mesh positions are cpu devices but device='meta'"):
        call()


# ---------------------------------------------------------------------------
# the select command line and multi-host with a local mesh
# ---------------------------------------------------------------------------

def test_select_cli_grid_on_four_positions():
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_DEVICES="4")
    cmd = [sys.executable, "-m", "repro_torch.launch.select", "--rows", "1024", "--cols",
           "640", "--select", "5", "--encoding", "grid", "--mesh-obs", "2", "--mesh-feat",
           "2", "--device", "cpu"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, check=True,
                         timeout=LAUNCH_TIMEOUT)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["encoding"] == "grid" and rec["devices"] == 4
    assert rec["mesh"] == {"data": 2, "model": 2} and rec["device"] == "cpu"
    from repro_torch.data.synthetic import corral_dataset_np

    X, y = corral_dataset_np(1024, 640, seed=0)
    one = MRMRSelector(5, score=MIScore(2, 2), device="cpu").fit(X, y)
    assert rec["selected"] == one.selected_.tolist()
    assert rec["gains"] == [float(g) for g in one.gains_]  # bitwise
    j = JSelector(5, score=JMIScore(2, 2), devices=1).fit(X, y)
    assert rec["selected"] == j.selected_.tolist()
    np.testing.assert_allclose(rec["gains"], j.gains_, rtol=RTOL, atol=ATOL)


def test_two_gloo_processes_each_with_a_local_mesh(tmp_path):
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=SRC,
                   REPRO_COORDINATOR=f"file://{tmp_path / 'rendezvous'}",
                   REPRO_NUM_PROCESSES="2", REPRO_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, __file__], env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-3000:]}\n{err[-3000:]}"
        recs.append(json.loads(out.strip().splitlines()[-1]))
    X, y = _gloo_data()
    one = MRMRSelector(4, score=MIScore(2, 2), block_obs=302, device="cpu").fit(
        ArraySource(X, y))
    j = jstreaming(JArraySource(X, y), 4, JMIScore(2, 2), block_obs=302)
    for rec in recs:
        assert rec["mesh"] == {"data": 2} and rec["plan"] == [["data"], [2], 302]
        assert rec["selected"] == one.selected_.tolist() == np.asarray(j.selected).tolist()
        assert rec["gains"] == [float(g) for g in one.gains_]  # bitwise
        assert rec["hosts"]["grid"] == [2, 1]
        assert rec["grid_selected"] == rec["selected"] and rec["grid_gains"] == rec["gains"]
    assert recs[0]["hosts"] == recs[1]["hosts"]
