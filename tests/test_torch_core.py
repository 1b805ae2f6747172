"""repro_torch core (contingency math, scores, criteria, engines, results)
vs the JAX package on the same numpy inputs, on the CPU.

Counts compare bitwise, floats within ``rtol=1e-5, atol=1e-6``, selections
exactly.
"""

import json
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import contingency as jcont
from repro.core import criteria as jcrit
from repro.core import mrmr as jmrmr
from repro.core import scores as jscores
from repro.data.sources import CorralSource as JCorralSource

from repro_torch.core import contingency as tcont
from repro_torch.core import criteria as tcrit
from repro_torch.core import mrmr as tmrmr
from repro_torch.core import scores as tscores

RTOL, ATOL = 1e-5, 1e-6
ALL_CRITERIA = ("cife", "cmim", "icap", "jmi", "maxrel", "mid", "mifs", "miq")


@pytest.fixture(scope="module")
def corral():
    X, y = JCorralSource(1500, 24, seed=3).materialize()
    return X, y.astype(np.int32)


class TestContingencyMath:
    def test_pair_counts(self):
        rng = np.random.default_rng(0)
        x, y = rng.integers(-1, 4, 500), rng.integers(0, 3, 500)
        got = tcont.pair_counts(torch.from_numpy(x), torch.from_numpy(y), 3, 3)
        want = jcont.pair_counts(jnp.asarray(x), jnp.asarray(y), 3, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))

    @pytest.mark.parametrize("block", [1, 5, 64])
    def test_batched_counts_any_block(self, block):
        rng = np.random.default_rng(block)
        X, y = rng.integers(0, 3, (250, 13)), rng.integers(0, 2, 250)
        got = tcont.batched_counts(torch.from_numpy(X), torch.from_numpy(y), 3, 2, block=block)
        want = jcont.batched_counts(jnp.asarray(X), jnp.asarray(y), 3, 2, block=block)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))

    def test_fuse_targets_guards_every_out_of_range_input(self):
        other = np.array([0, 1, 2, -1, 2**31 - 1, 1, 0], np.int32)
        cls = np.array([0, 1, 1, 0, 1, -2, 2**31 - 1], np.int32)
        got = tcont.fuse_targets(torch.from_numpy(other), torch.from_numpy(cls), 3, 2)
        want = jcont.fuse_targets(jnp.asarray(other), jnp.asarray(cls), 3, 2)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # sentinel * num_classes must not wrap back into [0, vy * C)
        assert np.all(got.numpy()[3:] == tcont.OOR)

    def test_conditional_counts(self, corral):
        X, y = corral
        xj = X[:, 3]
        got = tcont.conditional_counts(
            torch.from_numpy(X), torch.from_numpy(xj), torch.from_numpy(y), 2, 2, 2
        )
        want = jcont.conditional_counts(
            jnp.asarray(X), jnp.asarray(xj), jnp.asarray(y), 2, 2, 2
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


class TestScores:
    def test_cmi_and_entropy(self):
        rng = np.random.default_rng(3)
        counts = rng.integers(0, 40, (30, 3, 4, 2)).astype(np.int32)
        counts[0] = 0
        counts[1, ..., 1] = 0  # an empty class slice
        got = tscores.cmi_from_counts(torch.from_numpy(counts))
        want = jscores.cmi_from_counts(jnp.asarray(counts))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        hist = counts.reshape(30, -1)
        np.testing.assert_allclose(
            tscores.entropy_from_counts(torch.from_numpy(hist)).numpy(),
            np.asarray(jscores.entropy_from_counts(jnp.asarray(hist))),
            rtol=RTOL, atol=ATOL,
        )

    @pytest.mark.parametrize("conditional", [False, True])
    def test_relevance_and_redundancy_terms(self, corral, conditional):
        X, y = corral
        rows = np.ascontiguousarray(X.T)
        tscore, jscore = tscores.MIScore(2, 2), jscores.MIScore(2, 2)
        rel_t = tscore.relevance(torch.from_numpy(rows), torch.from_numpy(y))
        rel_j = jscore.relevance(jnp.asarray(rows), jnp.asarray(y))
        np.testing.assert_allclose(rel_t.numpy(), np.asarray(rel_j), rtol=RTOL, atol=ATOL)
        t = tscore.redundancy_terms(
            torch.from_numpy(rows), torch.from_numpy(rows[5]), torch.from_numpy(y),
            conditional=conditional,
        )
        j = jscore.redundancy_terms(
            jnp.asarray(rows), jnp.asarray(rows[5]), jnp.asarray(y),
            conditional=conditional,
        )
        for key in ("marginal", "conditional"):
            if j[key] is None:
                assert t[key] is None
            else:
                np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]),
                                           rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("kind", ["class", "feature", "feature_cond"])
    def test_streaming_state_int32_with_valid_mask(self, corral, kind):
        X, y = corral
        tscore, jscore = tscores.MIScore(2, 2), jscores.MIScore(2, 2)
        tgt = y if kind == "class" else X[:, 7].astype(np.int32)
        if kind == "feature_cond":
            tgt = (X[:, 7].astype(np.int32) * 2 + y).astype(np.int32)
        st_t = tscore.init_state(X.shape[1], kind)
        st_j = jscore.init_state(X.shape[1], kind)
        assert st_t.dtype == torch.int32 and tuple(st_t.shape) == st_j.shape
        valid = np.arange(X.shape[0]) < 1400  # the last 100 rows are padding
        for lo in range(0, X.shape[0], 512):
            sl = slice(lo, lo + 512)
            st_t = tscore.accumulate(st_t, torch.from_numpy(X[sl]),
                                     torch.from_numpy(tgt[sl]), torch.from_numpy(valid[sl]))
            st_j = jscore.accumulate(st_j, jnp.asarray(X[sl]), jnp.asarray(tgt[sl]),
                                     jnp.asarray(valid[sl]))
        assert st_t.dtype == torch.int32
        np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
        if kind == "feature_cond":
            ft, fj = tscore.finalize_conditional(st_t), jscore.finalize_conditional(st_j)
            for key in ("marginal", "conditional"):
                np.testing.assert_allclose(ft[key].numpy(), np.asarray(fj[key]),
                                           rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_allclose(tscore.finalize(st_t).numpy(),
                                       np.asarray(jscore.finalize(st_j)),
                                       rtol=RTOL, atol=ATOL)

    def test_use_kernel_validated(self):
        with pytest.raises(ValueError, match="use_kernel"):
            tscores.MIScore(2, 2, use_kernel="sometimes")


class TestCriteria:
    def test_registry_matches_jax(self):
        assert tcrit.available_criteria() == ALL_CRITERIA
        assert set(ALL_CRITERIA) <= set(jcrit.available_criteria())

    @pytest.mark.parametrize("name", ALL_CRITERIA)
    def test_fold_trajectory_matches_jax(self, name):
        rng = np.random.default_rng(len(name))
        n, steps = 40, 6
        rel = rng.random(n).astype(np.float32)
        tc, jc = tcrit.resolve_criterion(name), jcrit.resolve_criterion(name)
        assert (tc.needs_redundancy, tc.needs_conditional_redundancy) == (
            jc.needs_redundancy, jc.needs_conditional_redundancy)
        st_t, st_j = tc.init_state(n), jc.init_state(n)
        for l in range(steps):
            g_t = tc.objective(torch.from_numpy(rel), st_t, l)
            g_j = jc.objective(jnp.asarray(rel), st_j, l)
            np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=RTOL, atol=ATOL)
            marg = (rng.random(n) * 0.1).astype(np.float32)
            cond = (rng.random(n) * 0.1).astype(np.float32)
            st_t = tc.update(st_t, dict(marginal=torch.from_numpy(marg),
                                        conditional=torch.from_numpy(cond)), l)
            st_j = jc.update(st_j, dict(marginal=jnp.asarray(marg),
                                        conditional=jnp.asarray(cond)), l)

    def test_conditional_terms_demand_declaration(self):
        with pytest.raises(ValueError, match="needs_conditional_redundancy"):
            tcrit.conditional_terms(dict(marginal=torch.zeros(3), conditional=None))

    def test_register_custom_and_unknown(self):
        class Twice(tcrit.Criterion):
            name = "twice_mid_test"

            def init_state(self, n, device=None):
                return dict(red_sum=torch.zeros(n, device=device))

            def update(self, state, terms, l):
                return dict(red_sum=state["red_sum"] + tcrit.marginal_terms(terms))

            def objective(self, rel, state, l):
                return rel - 2.0 * state["red_sum"] / float(max(l, 1))

        tcrit.register_criterion(Twice)
        try:
            assert tcrit.resolve_criterion("twice_mid_test").name == "twice_mid_test"
        finally:
            tcrit._CRITERIA.pop("twice_mid_test")
        with pytest.raises(ValueError, match="unknown criterion"):
            tcrit.resolve_criterion("nope")


class TestEngines:
    @pytest.mark.parametrize("criterion", ["mid", "jmi", "cmim"])
    @pytest.mark.parametrize("engine", ["reference", "conventional", "alternative"])
    def test_recompute_path_matches_jax(self, corral, engine, criterion):
        X, y = corral
        rows = np.ascontiguousarray(X.T)
        kw = dict(incremental=False, criterion=criterion)
        if engine == "conventional":
            t = tmrmr.mrmr_conventional(torch.from_numpy(X), torch.from_numpy(y), 5,
                                        tscores.MIScore(2, 2), **kw)
            j = jmrmr.mrmr_conventional(jnp.asarray(X), jnp.asarray(y), 5,
                                        jscores.MIScore(2, 2), **kw)
        else:
            tf = getattr(tmrmr, f"mrmr_{engine}")
            jf = getattr(jmrmr, f"mrmr_{engine}")
            t = tf(torch.from_numpy(rows), torch.from_numpy(y), 5, tscores.MIScore(2, 2), **kw)
            j = jf(jnp.asarray(rows), jnp.asarray(y), 5, jscores.MIScore(2, 2), **kw)
        assert t.selected.dtype == torch.int32 and t.gains.dtype == torch.float32
        np.testing.assert_array_equal(t.selected.numpy(), np.asarray(j.selected))
        np.testing.assert_allclose(t.gains.numpy(), np.asarray(j.gains), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(t.relevance.numpy(), np.asarray(j.relevance),
                                   rtol=RTOL, atol=ATOL)
        assert (t.engine, t.criterion) == (j.engine, j.criterion)

    def test_objective_trajectory_is_jaxs(self, corral):
        """``objective_trajectory`` aliases ``gains``, as JAX's property does."""
        X, y = corral
        rows = np.ascontiguousarray(X.T)
        t = tmrmr.mrmr_reference(torch.from_numpy(rows), torch.from_numpy(y), 4,
                                 tscores.MIScore(2, 2), criterion="mid")
        j = jmrmr.mrmr_reference(jnp.asarray(rows), jnp.asarray(y), 4, jscores.MIScore(2, 2),
                                 criterion="mid")
        assert t.objective_trajectory is t.gains
        np.testing.assert_allclose(t.objective_trajectory.numpy(),
                                   np.asarray(j.objective_trajectory), rtol=RTOL, atol=ATOL)

    def test_incremental_equals_recompute(self, corral):
        X, y = corral
        a = tmrmr.mrmr_conventional(torch.from_numpy(X), torch.from_numpy(y), 6,
                                    tscores.MIScore(2, 2), incremental=True)
        b = tmrmr.mrmr_conventional(torch.from_numpy(X), torch.from_numpy(y), 6,
                                    tscores.MIScore(2, 2), incremental=False)
        assert torch.equal(a.selected, b.selected)

    def test_argmax_ties_go_to_lowest_id(self):
        # Duplicate columns: identical relevance, so every tie must pick the
        # lower id first, as jnp.argmax does.
        X, y = JCorralSource(800, 12, seed=1).materialize()
        X = np.concatenate([X[:, 6:], X[:, :6], X[:, :6]], axis=1)
        t = tmrmr.mrmr_conventional(torch.from_numpy(X), torch.from_numpy(y), 4,
                                    tscores.MIScore(2, 2), criterion="maxrel")
        j = jmrmr.mrmr_conventional(jnp.asarray(X), jnp.asarray(y), 4,
                                    jscores.MIScore(2, 2), criterion="maxrel")
        np.testing.assert_array_equal(t.selected.numpy(), np.asarray(j.selected))

    def test_conditional_criterion_needs_conditional_score(self):
        class Marginal(tscores.ScoreFn):
            pass

        with pytest.raises(ValueError, match="class-conditioned"):
            tmrmr.check_conditional_support(Marginal(), tcrit.resolve_criterion("jmi"))


class TestResultJSON:
    def _jax_result(self):
        return jmrmr.MRMRResult(
            selected=jnp.asarray([3, 1, 2], jnp.int32),
            gains=jnp.asarray([0.5, -0.25, float("inf")], jnp.float32),
            relevance=jnp.asarray([0.1, float("nan"), 0.3, float("-inf")], jnp.float32),
            criterion="jmi", engine="streaming",
            io=dict(passes=3, blocks_read=6, bytes_read=1234, state_bytes=64),
        )

    def test_port_reads_jax_json(self):
        j = self._jax_result()
        t = tmrmr.MRMRResult.from_json(j.to_json())
        assert t.selected.dtype == torch.int32 and t.gains.dtype == torch.float32
        np.testing.assert_array_equal(t.selected.numpy(), np.asarray(j.selected))
        np.testing.assert_array_equal(t.gains.numpy(), np.asarray(j.gains))
        np.testing.assert_array_equal(t.relevance.numpy(), np.asarray(j.relevance))
        assert (t.criterion, t.engine, t.io) == (j.criterion, j.engine, j.io)
        assert t.to_json() == j.to_json()

    def test_jax_reads_port_json(self):
        t = tmrmr.MRMRResult(
            selected=torch.tensor([0, 4], dtype=torch.int32),
            gains=torch.tensor([1.5, float("nan")]),
            relevance=None, criterion="mid", engine="conventional",
        )
        payload = t.to_json()
        json.loads(payload)  # strict JSON
        j = jmrmr.MRMRResult.from_json(payload)
        np.testing.assert_array_equal(np.asarray(j.selected), [0, 4])
        assert math.isnan(float(j.gains[1])) and j.relevance is None
        assert j.to_json() == payload
        assert tmrmr.MRMRResult.from_json(payload).to_json() == payload
