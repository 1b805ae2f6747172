"""The port's scikit-learn adapter (``MRMRTransformer``) and legacy API
(``FeatureSelector``, ``mrmr_select``) against the JAX package's: the same
selections and gains (``rtol=1e-5, atol=1e-6``), sklearn's clone and
composition contracts, and streamed Parquet/Arrow fits that select as JAX's.
"""

import numpy as np
import pytest
import torch

from repro.core.selection import FeatureSelector as JFeatureSelector
from repro.core.selection import infer_layout as jinfer_layout
from repro.core.selection import mrmr_select as jmrmr_select
from repro.core.selector import MRMRSelector as JSelector
from repro.data import sources as jsources
from repro.data.synthetic import corral_dataset

from repro_torch import FeatureSelector, MIScore, MRMRSelector, PearsonMIScore, mrmr_select
from repro_torch.core.selection import infer_layout
from repro_torch.data import sources as tsources

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def corral():
    X, y = corral_dataset(1500, 24, seed=3, flip_prob=0.02)
    return np.array(X, np.int32), np.array(y)


def _same(t_sel, t_gains, j_sel, j_gains):
    np.testing.assert_array_equal(t_sel, j_sel)
    np.testing.assert_allclose(t_gains, j_gains, rtol=RTOL, atol=ATOL)


class TestLegacyAPI:
    @pytest.mark.parametrize("shape", [(1500, 24), (24, 1500), (100, 100)])
    def test_infer_layout(self, shape):
        assert infer_layout(*shape) == jinfer_layout(*shape)

    @pytest.mark.parametrize("layout", ["auto", "conventional", "alternative", "reference"])
    def test_feature_selector_like_jax(self, corral, layout):
        X, y = corral
        t = FeatureSelector(5, layout=layout, device="cpu").fit(X, y)
        j = JFeatureSelector(5, layout=layout).fit(X, y)
        _same(t.selected_, t.gains_, j.selected_, j.gains_)
        np.testing.assert_array_equal(t.transform(X), j.transform(X))
        np.testing.assert_array_equal(t.fit_transform(X, y), X[:, t.selected_])

    def test_float_data_takes_the_alternative_layout(self):
        rng = np.random.default_rng(2)
        X = rng.normal(size=(400, 12)).astype(np.float32)
        y = (X[:, 3] > 0).astype(np.float32)
        t = FeatureSelector(3, device="cpu")
        assert t._encoding_for(torch.as_tensor(X)) == "alternative"
        t.fit(X, y)
        j = JFeatureSelector(3).fit(X, y)
        np.testing.assert_array_equal(t.selected_, j.selected_)
        np.testing.assert_allclose(t.gains_, j.gains_, rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("kw", [dict(), dict(score=MIScore(2, 2), incremental=False)])
    def test_mrmr_select_like_jax(self, corral, kw):
        X, y = corral
        jkw = dict(kw)
        if "score" in jkw:
            from repro.core.scores import MIScore as JMIScore

            jkw["score"] = JMIScore(2, 2)
        t = mrmr_select(X, y, 4, device="cpu", **kw)
        j = jmrmr_select(X, y, 4, **jkw)
        _same(t.selected.numpy(), t.gains.numpy(), np.asarray(j.selected), np.asarray(j.gains))
        assert t.selected.dtype == torch.int32

    def test_grid_and_mesh_wait_for_the_mesh_engines(self, corral):
        """The mesh engines behind the legacy API: ``layout="grid"`` (the 1x1
        grid on one device, a 2x2 grid of CPU positions) and ``mesh=`` select
        as JAX's single-device fit, gains bitwise the port's one-device fit."""
        from repro_torch.dist.meshes import make_mesh

        X, y = corral
        j = JFeatureSelector(3).fit(X, y)
        one = FeatureSelector(3, device="cpu").fit(X, y)
        for kw in (dict(layout="grid"),
                   dict(layout="grid", mesh=make_mesh((2, 2), ("data", "model"),
                                                      devices=["cpu"] * 4)),
                   dict(mesh=make_mesh((4,), ("data",), devices=["cpu"] * 4))):
            t = FeatureSelector(3, device="cpu", **kw).fit(X, y)
            _same(t.selected_, t.gains_, j.selected_, j.gains_)
            assert np.array_equal(t.gains_, one.gains_)
            r = mrmr_select(X, y, 3, device="cpu", **kw)
            assert r.selected.tolist() == t.selected_.tolist()
        for fs in (FeatureSelector(3, mesh=object(), device="cpu"),
                   JFeatureSelector(3, mesh=object())):  # not a mesh: JAX's error
            with pytest.raises(AttributeError, match="shape"):
                fs.fit(X, y)

    def test_transform_before_fit(self):
        with pytest.raises(RuntimeError, match="fit"):
            FeatureSelector(3, device="cpu").transform(np.zeros((2, 3)))


sklearn = pytest.importorskip("sklearn")
from sklearn.base import clone  # noqa: E402
from sklearn.linear_model import LogisticRegression  # noqa: E402
from sklearn.model_selection import GridSearchCV  # noqa: E402
from sklearn.pipeline import make_pipeline  # noqa: E402

from repro.interop.sklearn import MRMRTransformer as JMRMRTransformer  # noqa: E402
from repro_torch.interop.sklearn import MRMRTransformer  # noqa: E402


class TestMRMRTransformer:
    def test_fit_transform_like_jax(self, corral):
        X, y = corral
        tr = MRMRTransformer(num_select=5, device="cpu").fit(X, y)
        jtr = JMRMRTransformer(num_select=5).fit(X, y)
        _same(tr.selected_, tr.gains_, jtr.selected_, jtr.gains_)
        np.testing.assert_allclose(tr.scores_, jtr.scores_, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(tr.ranking_, jtr.ranking_)
        keep = np.sort(tr.selected_)  # sklearn: ascending column order
        np.testing.assert_array_equal(np.flatnonzero(tr.get_support()), keep)
        np.testing.assert_array_equal(tr.transform(X), X[:, keep])
        np.testing.assert_array_equal(tr.transform(X), jtr.transform(X))
        assert tr.n_features_in_ == X.shape[1]
        ref = MRMRSelector(num_select=5, device="cpu").fit(X, y)
        np.testing.assert_array_equal(tr.selected_, ref.selected_)

    def test_requires_y(self, corral):
        X, _ = corral
        with pytest.raises(ValueError, match="supervised"):
            MRMRTransformer(num_select=3, device="cpu").fit(X)

    def test_clone_roundtrip(self):
        tr = MRMRTransformer(num_select=7, criterion="jmi", bins=16, block_obs=1024,
                             device="cpu")
        params = clone(tr).get_params()
        assert (params["num_select"], params["criterion"], params["bins"],
                params["block_obs"], params["device"]) == (7, "jmi", 16, 1024, "cpu")
        jparams = JMRMRTransformer(num_select=7).get_params()
        assert set(params) - set(jparams) == {"device"}

    @pytest.mark.parametrize("criterion", ["jmi", "cmim"])
    def test_criterion_passthrough_like_jax(self, corral, criterion):
        X, y = corral
        tr = MRMRTransformer(num_select=5, criterion=criterion, device="cpu").fit(X, y)
        jtr = JMRMRTransformer(num_select=5, criterion=criterion).fit(X, y)
        _same(tr.selected_, tr.gains_, jtr.selected_, jtr.gains_)
        assert tr.selector_.result_.criterion == criterion

    def test_bins_route_on_floats_like_jax(self):
        rng = np.random.default_rng(11)
        X = rng.normal(size=(800, 12)).astype(np.float32)
        y = (X[:, 2] - X[:, 7] > 0).astype(np.int32)
        tr = MRMRTransformer(num_select=4, criterion="jmi", bins=8, device="cpu")
        Xt = tr.fit_transform(X, y)
        jtr = JMRMRTransformer(num_select=4, criterion="jmi", bins=8).fit(X, y)
        assert Xt.shape == (800, 4) and {2, 7} <= set(tr.selected_.tolist())
        _same(tr.selected_, tr.gains_, jtr.selected_, jtr.gains_)
        assert tr.selector_.plan_.bins == 8

    def test_score_passthrough(self, corral):
        X, y = corral
        tr = MRMRTransformer(num_select=4, score=MIScore(2, 2), device="cpu").fit(X, y)
        ref = MRMRSelector(num_select=4, score=MIScore(2, 2), device="cpu").fit(X, y)
        np.testing.assert_array_equal(tr.selected_, ref.selected_)
        tp = MRMRTransformer(num_select=3, score=PearsonMIScore(), device="cpu")
        tp.fit(X.astype(np.float32), y)
        assert tp.selector_.plan_.encoding == "alternative"

    def test_pipeline(self, corral):
        X, y = corral
        pipe = make_pipeline(MRMRTransformer(num_select=6, device="cpu"),
                             LogisticRegression(max_iter=200))
        pipe.fit(X, y)
        assert pipe.score(X, y) > 0.6
        assert pipe[:-1].transform(X).shape == (X.shape[0], 6)

    def test_grid_search_over_num_select(self, corral):
        X, y = corral
        pipe = make_pipeline(MRMRTransformer(num_select=2, device="cpu"),
                             LogisticRegression(max_iter=200))
        gs = GridSearchCV(pipe, {"mrmrtransformer__num_select": [2, 6]}, cv=2,
                          error_score="raise")
        gs.fit(X, y)
        assert gs.best_params_["mrmrtransformer__num_select"] in (2, 6)


pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402


def _table(X, y):
    cols = {f"f{j}": X[:, j] for j in range(X.shape[1])}
    cols["label"] = y
    return pa.table(cols)


class TestColumnarFits:
    def test_streamed_parquet_fit_like_jax(self, tmp_path, corral):
        X, y = corral
        path = str(tmp_path / "d.parquet")
        pq.write_table(_table(X, y), path, row_group_size=256)
        t = MRMRSelector(5, criterion="jmi", block_obs=500, device="cpu").fit(
            tsources.ParquetSource(path))
        j = JSelector(5, criterion="jmi", block_obs=500, devices=1).fit(
            jsources.ParquetSource(path))
        assert t.plan_.encoding == "streaming"
        _same(t.selected_, t.gains_, j.selected_, j.gains_)
        assert t.result_.io == j.result_.io
        mem = MRMRSelector(5, criterion="jmi", device="cpu").fit(X, y)
        np.testing.assert_array_equal(t.selected_, mem.selected_)

    def test_float_parquet_with_bins_and_spill_like_jax(self, tmp_path):
        rng = np.random.default_rng(5)
        X = rng.normal(size=(700, 10)).astype(np.float32)
        y = (X[:, 1] + X[:, 6] > 0).astype(np.int32)
        path = str(tmp_path / "f.parquet")
        pq.write_table(_table(X, y), path)
        kw = dict(criterion="cmim", bins=8, block_obs=200)
        t = MRMRSelector(3, spill_dir=str(tmp_path / "t"), device="cpu", **kw).fit(
            tsources.ParquetSource(path))
        j = JSelector(3, spill_dir=str(tmp_path / "j"), devices=1, **kw).fit(
            jsources.ParquetSource(path))
        _same(t.selected_, t.gains_, j.selected_, j.gains_)
        assert t.result_.io == j.result_.io and t.result_.io["cache"]["parse_passes"] == 1

    def test_arrow_fit_like_jax(self, corral):
        X, y = corral
        t = MRMRSelector(5, criterion="cmim", block_obs=400, device="cpu").fit(
            tsources.ArrowSource(_table(X, y)))
        j = JSelector(5, criterion="cmim", block_obs=400, devices=1).fit(
            jsources.ArrowSource(_table(X, y)))
        _same(t.selected_, t.gains_, j.selected_, j.gains_)
