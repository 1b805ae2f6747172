"""The paper's custom-score interface (Listing 7) in the port against the
JAX package's: ``CustomScore`` / ``mrmr_custom_score`` on the reference and
alternative engines select what JAX's select (gains within ``rtol=1e-5,
atol=1e-6``), report a NaN relevance, refuse a criterion other than ``mid``
and refuse to stream.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import scores as jscores
from repro.core.selector import MRMRSelector as JSelector
from repro.data.sources import CorralSource as JCorralSource

from repro_torch import (
    ArraySource,
    CustomScore,
    MIScore,
    MRMRResult,
    MRMRSelector,
    PearsonMIScore,
    mrmr_custom_score,
    mrmr_streaming,
)
from repro_torch.core import scores
from repro_torch.kernels import ops, ref

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def corral():
    return JCorralSource(600, 40, seed=11).materialize()


class TestScoreObject:
    def test_custom_score_requires_callable(self):
        with pytest.raises(TypeError):
            CustomScore()  # missing argument fails at construction
        with pytest.raises(TypeError, match="callable"):
            CustomScore(get_result=None)
        with pytest.raises(TypeError, match="callable"):
            CustomScore(get_result=42)

    def test_streaming_support_flags(self):
        assert MIScore().supports_streaming and PearsonMIScore().supports_streaming
        custom = CustomScore(get_result=lambda v, c, s, n: 0.0)
        assert not custom.supports_streaming and not custom.incremental_safe
        with pytest.raises(NotImplementedError, match="streaming"):
            custom.init_state(4)

    def test_custom_score_equals_builtin_mrmr(self):
        rng = np.random.default_rng(7)
        X = rng.integers(0, 2, (8, 120))
        y = rng.integers(0, 2, 120)
        s = MIScore(num_values=2, num_classes=2, use_kernel=False)
        sel = torch.as_tensor(X[:3], dtype=torch.float32)
        Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
        g_custom = mrmr_custom_score(s).full_score(Xt, yt, sel, 3)
        rel = s.relevance(Xt, yt)
        red = sum(s.redundancy(Xt, torch.as_tensor(X[j])) for j in range(3)) / 3.0
        np.testing.assert_allclose(g_custom, rel - red, rtol=RTOL, atol=ATOL)
        # ... and the JAX package's full_score on the same inputs
        import jax.numpy as jnp

        jg = jscores.mrmr_custom_score(jscores.MIScore(2, 2)).full_score(
            jnp.asarray(X), jnp.asarray(y), jnp.asarray(X[:3], jnp.int32), jnp.int32(3))
        np.testing.assert_allclose(g_custom, np.asarray(jg), rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("n_selected", [0, 1, 4])
    def test_full_score_chunks_equal_one_call(self, corral, monkeypatch, n_selected):
        X, y = corral
        Xr = torch.as_tensor(X.T.copy())
        sel = torch.zeros((5, X.shape[0]), dtype=torch.float32)
        sel[:n_selected] = Xr[:n_selected].to(torch.float32)
        cs = mrmr_custom_score(MIScore(2, 2))
        whole = cs.full_score(Xr, torch.as_tensor(y), sel, n_selected)
        monkeypatch.setattr(scores, "_CUSTOM_CHUNK_ELEMS", 7 * X.shape[0] * 6)
        chunked = cs.full_score(Xr, torch.as_tensor(y), sel, n_selected)  # 7 a chunk
        assert whole.shape == (X.shape[1],) and whole.dtype == torch.float32
        assert torch.equal(whole, chunked)

    def test_out_of_range_values_count_nothing(self):
        """The vmapped count of a batched target fuses value and target into
        one code: a value or target out of range (negative, past V or C, a
        non-integral float) counts nothing, as in the plain count."""
        x = torch.tensor([[0.0], [1.0], [5.0], [-1.0], [1.0], [0.5]])
        t = torch.tensor([[1, 0, 1, 1, 7, 0], [1, 1, -3, 0, 0, 1]])
        got = torch.func.vmap(lambda tt: ops.contingency_tables(x, tt, 2, 2))(t)
        assert got[0, 0].tolist() == [[0, 1], [1, 0]]
        assert got[1, 0].tolist() == [[0, 1], [1, 1]]
        want = torch.stack([ref.contingency_tables(x, tt, 2, 2) for tt in t])
        assert torch.equal(got, want)


def _calls(monkeypatch, name):
    """Count the calls of the plain version behind a custom operator."""
    calls = []
    inner = getattr(ref, name)

    def counted(*args):
        calls.append(args[0].shape)
        return inner(*args)

    monkeypatch.setattr(ref, name, counted)
    return calls


class TestVmapRules:
    """The custom operators' vmap rules against the plain version applied
    element by element: each batched call is one call of the operator."""

    @pytest.mark.parametrize("batched", ["X", "y", "both"])
    @pytest.mark.parametrize("dtype", [torch.int8, torch.int64, torch.float32])
    def test_contingency(self, monkeypatch, batched, dtype):
        g = torch.Generator().manual_seed(3)
        B, M, F, V, C = 5, 70, 3, 3, 4
        X = torch.randint(-1, V + 1, (B, M, F), generator=g).to(dtype)
        y = torch.randint(-1, C + 1, (B, M), generator=g)
        want = torch.stack([
            ref.contingency_tables(X[b] if batched != "y" else X[0],
                                   y[b] if batched != "X" else y[0], V, C)
            for b in range(B)])
        calls = _calls(monkeypatch, "contingency_tables")
        fn = lambda xx, yy: ops.contingency_tables(xx, yy, V, C)  # noqa: E731
        dims = {"X": (0, None), "y": (None, 0), "both": (0, 0)}[batched]
        args = (X if batched != "y" else X[0], y if batched != "X" else y[0])
        got = torch.func.vmap(fn, in_dims=dims)(*args)
        assert len(calls) == 1
        assert got.dtype == torch.int32 and torch.equal(got, want)

    @pytest.mark.parametrize("shape", [(4, 3, 2), (2, 4, 3, 2)])
    def test_mi(self, monkeypatch, shape):
        counts = torch.randint(0, 50, (6, *shape), generator=torch.Generator().manual_seed(4))
        calls = _calls(monkeypatch, "mi_scores")
        got = torch.func.vmap(ops.mi_scores)(counts)
        assert len(calls) == 1
        np.testing.assert_allclose(got, torch.stack([ref.mi_scores(c) for c in counts]),
                                   rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("batched", ["X", "Y", "both"])
    def test_pearson(self, monkeypatch, batched):
        g = torch.Generator().manual_seed(5)
        X, Y = torch.randn(4, 3, 50, generator=g), torch.randn(4, 2, 50, generator=g)
        want = torch.stack([ref.pearson_corr(X[b] if batched != "Y" else X[0],
                                             Y[b] if batched != "X" else Y[0])
                            for b in range(4)])
        calls = _calls(monkeypatch, "pearson_corr")
        dims = {"X": (0, None), "Y": (None, 0), "both": (0, 0)}[batched]
        args = (X if batched != "Y" else X[0], Y if batched != "X" else Y[0])
        got = torch.func.vmap(ops.pearson_corr, in_dims=dims)(*args)
        assert len(calls) == (4 if batched == "both" else 1)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _fit_both(X, y, num_select, encoding, tscore, jscore, **kw):
    t = MRMRSelector(num_select, score=tscore, encoding=encoding, device="cpu", **kw).fit(X, y)
    j = JSelector(num_select, score=jscore, encoding=encoding, devices=1, **kw).fit(X, y)
    return t, j


class TestEngines:
    @pytest.mark.parametrize("encoding", ["reference", "alternative"])
    def test_mi_custom_fit_matches_jax(self, corral, encoding):
        X, y = corral
        t, j = _fit_both(X, y, 5, encoding, mrmr_custom_score(MIScore(2, 2)),
                         jscores.mrmr_custom_score(jscores.MIScore(2, 2)))
        np.testing.assert_array_equal(t.selected_, j.selected_)
        np.testing.assert_allclose(t.gains_, j.gains_, rtol=RTOL, atol=ATOL)
        assert np.isnan(t.scores_).all() and np.isnan(j.scores_).all()
        assert t.scores_.shape == (X.shape[1],)
        assert (t.result_.engine, t.result_.criterion) == (encoding, "mid")
        # the custom path selects what the built-in score selects
        b = MRMRSelector(5, score=MIScore(2, 2), encoding=encoding, device="cpu").fit(X, y)
        np.testing.assert_array_equal(t.selected_, b.selected_)
        np.testing.assert_allclose(t.gains_, b.gains_, rtol=RTOL, atol=ATOL)

    def test_auto_plans_alternative_like_jax(self, corral):
        X, y = corral
        t, j = _fit_both(X, y, 4, "auto", mrmr_custom_score(MIScore(2, 2)),
                         jscores.mrmr_custom_score(jscores.MIScore(2, 2)))
        assert t.plan_.encoding == j.plan_.encoding == "alternative"
        np.testing.assert_array_equal(t.selected_, j.selected_)

    @pytest.mark.parametrize("encoding", ["reference", "alternative"])
    def test_pearson_custom_fit_matches_jax(self, encoding):
        rng = np.random.default_rng(0)
        X = rng.normal(size=(300, 20)).astype(np.float32)
        y = (X[:, 0] + X[:, 3] > 0).astype(np.float32)
        t, j = _fit_both(X, y, 4, encoding, mrmr_custom_score(PearsonMIScore()),
                         jscores.mrmr_custom_score(jscores.PearsonMIScore()))
        np.testing.assert_array_equal(t.selected_, j.selected_)
        np.testing.assert_allclose(t.gains_, j.gains_, rtol=1e-4, atol=1e-5)

    def test_user_get_result_matches_jax(self, corral):
        """A get_result written by hand, once per package: agreement with
        the class minus a penalty per selected row the candidate equals."""
        import jax.numpy as jnp

        def tget(v, cls, selected, n):
            agree = (v.to(torch.float32) == cls.to(torch.float32)).to(torch.float32).mean()
            same = (selected == v.to(torch.float32)).all(dim=-1)
            live = torch.arange(selected.shape[0]) < n
            return agree - (same & live).to(torch.float32).sum()

        def jget(v, cls, selected, n):
            agree = (v.astype(jnp.float32) == cls.astype(jnp.float32)).astype(jnp.float32).mean()
            same = (selected == v.astype(jnp.float32)).all(axis=-1)
            live = jnp.arange(selected.shape[0]) < n
            return agree - (same & live).astype(jnp.float32).sum()

        X, y = corral
        X = np.concatenate([X, X[:, :3]], axis=1)  # duplicates the penalty must skip
        t, j = _fit_both(X, y, 6, "alternative", CustomScore(get_result=tget),
                         jscores.CustomScore(get_result=jget))
        np.testing.assert_array_equal(t.selected_, j.selected_)
        np.testing.assert_allclose(t.gains_, j.gains_, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("encoding", ["reference", "alternative"])
    def test_non_mid_criterion_raises(self, corral, encoding):
        X, y = corral
        with pytest.raises(ValueError, match="cannot be combined with CustomScore"):
            MRMRSelector(3, score=mrmr_custom_score(MIScore(2, 2)), encoding=encoding,
                         criterion="miq", device="cpu").fit(X, y)

    def test_conventional_refuses(self, corral):
        X, y = corral
        with pytest.raises(ValueError, match="discrete MI only"):
            MRMRSelector(3, score=mrmr_custom_score(MIScore(2, 2)), encoding="conventional",
                         device="cpu").fit(X, y)

    def test_streaming_refuses(self, corral):
        X, y = corral
        custom = mrmr_custom_score(MIScore(2, 2))
        with pytest.raises(ValueError, match="cannot stream"):
            MRMRSelector(3, score=custom, device="cpu").fit(ArraySource(X, y))
        with pytest.raises(ValueError, match="cannot stream"):
            mrmr_streaming(ArraySource(X, y), 3, custom, device="cpu")

    def test_nan_relevance_round_trips_as_strict_json(self, corral):
        X, y = corral
        res = MRMRSelector(3, score=mrmr_custom_score(MIScore(2, 2)),
                           device="cpu").fit(X, y).result_
        payload = res.to_json()
        json.loads(payload, parse_constant=lambda c: pytest.fail(f"bare {c}"))
        assert "NaN" not in payload
        back = MRMRResult.from_json(payload)
        assert torch.isnan(back.relevance).all()
        assert torch.equal(back.selected, res.selected)
        # the JAX package reads the port's payload
        from repro.core.mrmr import MRMRResult as JMRMRResult

        jback = JMRMRResult.from_json(payload)
        assert np.isnan(np.asarray(jback.relevance)).all()
