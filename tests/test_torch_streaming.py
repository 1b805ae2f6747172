"""repro_torch streaming engine, sources and placement vs the JAX package.

The port's sources must yield the JAX sources' blocks bitwise for every
``block_obs``; the streaming engine must select what the JAX streaming
engine selects (gains within ``rtol=1e-5, atol=1e-6``) with an identical
I/O ledger (``passes``, ``blocks_read``, ``bytes_read``, ``state_bytes``).
"""

import numpy as np
import pytest
import torch

from repro.core.scores import MIScore as JMIScore
from repro.core.streaming import mrmr_streaming as jstreaming
from repro.data import sources as jsources
from repro.data.synthetic import corral_dataset_np as jcorral_np

from repro_torch import MIScore, MRMRSelector, mrmr_streaming
from repro_torch.data import sources as tsources
from repro_torch.data.synthetic import corral_dataset_np
from repro_torch.dist.streaming import (
    BlockPlacer,
    PrefetchPlacer,
    effective_block_obs,
    resolve_prefetch,
)

RTOL, ATOL = 1e-5, 1e-6
LEDGER = ("passes", "blocks_read", "bytes_read", "state_bytes")


@pytest.fixture(scope="module")
def corral():
    return jsources.CorralSource(1500, 24, seed=3).materialize()


def _same_fit(t, j):
    np.testing.assert_array_equal(t.selected.numpy(), np.asarray(j.selected))
    np.testing.assert_allclose(t.gains.numpy(), np.asarray(j.gains), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.relevance.numpy(), np.asarray(j.relevance),
                               rtol=RTOL, atol=ATOL)
    assert {k: t.io[k] for k in LEDGER} == {k: j.io[k] for k in LEDGER}


class TestSources:
    @pytest.mark.parametrize("block_obs", [1, 7, 128, 999, 4096])
    def test_corral_blocks_bitwise(self, block_obs):
        t = list(tsources.CorralSource(3000, 12, seed=2).iter_blocks(block_obs))
        j = list(jsources.CorralSource(3000, 12, seed=2).iter_blocks(block_obs))
        assert len(t) == len(j)
        for (tx, ty), (jx, jy) in zip(t, j):
            assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)

    @pytest.mark.parametrize("block_obs", [7, 128, 999, 4096])
    def test_array_and_npy_blocks_bitwise(self, corral, tmp_path, block_obs):
        X, y = corral
        np.save(tmp_path / "X.npy", X)
        np.save(tmp_path / "y.npy", y)
        pairs = [
            (tsources.ArraySource(X, y), jsources.ArraySource(X, y)),
            (tsources.NpySource(str(tmp_path / "X.npy"), str(tmp_path / "y.npy")),
             jsources.NpySource(str(tmp_path / "X.npy"), str(tmp_path / "y.npy"))),
        ]
        for t, j in pairs:
            for (tx, ty), (jx, jy) in zip(t.iter_blocks(block_obs), j.iter_blocks(block_obs)):
                np.testing.assert_array_equal(tx, jx)
                np.testing.assert_array_equal(ty, jy)
            assert t.fingerprint() == j.fingerprint()

    def test_stats_and_fingerprint_match_jax(self, corral):
        tsources.clear_stats_memo()
        t = tsources.CorralSource(2000, 16, seed=4)
        j = jsources.CorralSource(2000, 16, seed=4)
        assert t.fingerprint() == j.fingerprint()
        assert t.stats(500) == tsources.SourceStats(True, 2, 2)
        assert (t.stats().num_values, t.stats().num_classes) == (
            j.stats().num_values, j.stats().num_classes)

    def test_negative_categories_and_bad_shapes_raise(self, corral):
        X, y = corral
        Xn = X.astype(np.int16)
        Xn[5, 3] = -2
        tsources.clear_stats_memo()
        with pytest.raises(ValueError, match="negative category"):
            tsources.ArraySource(Xn, y).stats()
        with pytest.raises(ValueError, match="bad shapes"):
            tsources.ArraySource(X, y[:, None])
        with pytest.raises(ValueError, match="at least 9"):
            tsources.CorralSource(10, 8)

    def test_to_npy_round_trip(self, tmp_path):
        src = tsources.CorralSource(500, 10, seed=1)
        src.to_npy(str(tmp_path / "a.npy"), str(tmp_path / "b.npy"), block_obs=64)
        back = tsources.NpySource(str(tmp_path / "a.npy"), str(tmp_path / "b.npy"))
        for a, b in zip(src.materialize(), back.materialize()):
            np.testing.assert_array_equal(a, b)

    def test_corral_dataset_np_matches_jax(self):
        for a, b in zip(corral_dataset_np(3000, 20, seed=7, chunk=1000),
                        jcorral_np(3000, 20, seed=7, chunk=1000)):
            np.testing.assert_array_equal(a, b)


class TestStreamingVsJax:
    @pytest.mark.parametrize("block_obs", [128, 999, 4096])
    def test_mid_three_block_sizes(self, corral, block_obs):
        X, y = corral
        t = mrmr_streaming((X, y), 5, MIScore(2, 2), block_obs=block_obs, device="cpu")
        j = jstreaming((X, y), 5, JMIScore(2, 2), block_obs=block_obs)
        assert t.engine == "streaming" and t.selected.dtype == torch.int32
        _same_fit(t, j)

    @pytest.mark.parametrize("criterion", ["jmi", "cmim", "maxrel", "miq"])
    def test_other_criteria(self, corral, criterion):
        X, y = corral
        t = mrmr_streaming((X, y), 4, MIScore(2, 2), block_obs=999, device="cpu",
                           criterion=criterion)
        j = jstreaming((X, y), 4, JMIScore(2, 2), block_obs=999, criterion=criterion)
        np.testing.assert_array_equal(t.selected.numpy(), np.asarray(j.selected))
        assert t.io == {k: j.io[k] for k in LEDGER}
        if criterion == "maxrel":
            assert t.io["passes"] == 1

    @pytest.mark.parametrize("q", [2, 4])
    def test_batched_candidates(self, corral, q):
        X, y = corral
        t = mrmr_streaming((X, y), 6, MIScore(2, 2), block_obs=512, device="cpu",
                           batch_candidates=q)
        j = jstreaming((X, y), 6, JMIScore(2, 2), block_obs=512, batch_candidates=q)
        _same_fit(t, j)
        plain = mrmr_streaming((X, y), 6, MIScore(2, 2), block_obs=512, device="cpu")
        assert torch.equal(t.selected, plain.selected)
        assert t.io["passes"] <= plain.io["passes"]

    @pytest.mark.parametrize("prefetch", [0, 2])
    def test_prefetch_changes_nothing(self, corral, prefetch):
        X, y = corral
        t = mrmr_streaming((X, y), 5, MIScore(2, 2), block_obs=300, device="cpu",
                           prefetch=prefetch)
        ref = mrmr_streaming((X, y), 5, MIScore(2, 2), block_obs=300, device="cpu")
        assert torch.equal(t.selected, ref.selected) and t.io == ref.io


class TestStreamingFrontDoor:
    def test_source_fit_matches_in_memory(self, corral):
        X, y = corral
        mem = MRMRSelector(5, device="cpu").fit(X, y)
        src = MRMRSelector(5, block_obs=999, device="cpu").fit(tsources.ArraySource(X, y))
        assert src.plan_.encoding == "streaming" and src.plan_.block_obs == 999
        assert src.plan_.prefetch == 0  # "auto" on the CPU
        np.testing.assert_array_equal(src.selected_, mem.selected_)
        np.testing.assert_allclose(src.gains_, mem.gains_, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(
            src.transform(tsources.ArraySource(X, y)), X[:, src.selected_])

    def test_arrays_with_streaming_encoding(self, corral):
        X, y = corral
        a = MRMRSelector(4, encoding="streaming", block_obs=128, device="cpu").fit(X, y)
        assert a.result_.io["blocks_read"] == 4 * 12

    def test_guards(self, corral):
        X, y = corral
        src = tsources.ArraySource(X, y)
        with pytest.raises(ValueError, match="needs in-memory arrays"):
            MRMRSelector(3, encoding="conventional", device="cpu").fit(src)
        with pytest.raises(ValueError, match="y comes from the DataSource"):
            MRMRSelector(3, device="cpu").fit(src, y)
        with pytest.raises(ValueError, match="continuous"):
            MRMRSelector(3, score=MIScore(2, 2), device="cpu").fit(
                tsources.ArraySource(X.astype(np.float32), y))
        with pytest.raises(ValueError, match="batch_candidates"):
            MRMRSelector(3, batch_candidates=0, device="cpu").fit(src)
        with pytest.raises(ValueError, match="num_select"):
            mrmr_streaming(src, 30, MIScore(2, 2), device="cpu")
        with pytest.raises(ValueError, match="prefetch"):
            mrmr_streaming(src, 3, MIScore(2, 2), device="cpu", prefetch=-1)


class TestPlacement:
    def test_stage_pads_and_masks(self):
        p = BlockPlacer(8, "cpu", num_features=3)
        X = np.arange(15, dtype=np.int8).reshape(5, 3)
        Xp, tp, valid = p.stage(X, np.arange(5, dtype=np.int8))
        assert Xp.shape == (8, 3) and tp.shape == (8,)
        np.testing.assert_array_equal(valid, [1, 1, 1, 1, 1, 0, 0, 0])
        Xb, tb, vb = p.stage(X, np.stack([np.arange(5)] * 2))  # (q, B) targets
        assert tb.shape == (2, 8)
        placed = p(X, np.arange(5))
        assert all(isinstance(a, torch.Tensor) for a in placed)
        assert placed[0].dtype == torch.int8 and placed[2].dtype == torch.bool

    def test_stage_rejects_bad_blocks(self):
        p = BlockPlacer(4, "cpu", num_features=3)
        with pytest.raises(ValueError, match="exceeds block_obs"):
            p.stage(np.zeros((5, 3)), np.zeros(5))
        with pytest.raises(ValueError, match="features"):
            p.stage(np.zeros((2, 4)), np.zeros(2))

    def test_prefetch_placer_streams_in_order_and_reraises(self):
        p = BlockPlacer(4, "cpu", num_features=2)
        blocks = [(np.full((3, 2), i, np.int8), np.full(3, i, np.int8)) for i in range(5)]
        out = list(PrefetchPlacer(p, depth=2).stream(iter(blocks)))
        assert [int(x[0, 0]) for x, _, _ in out] == list(range(5))

        def broken():
            yield blocks[0]
            raise OSError("disk gone")

        with pytest.raises(OSError, match="disk gone"):
            list(PrefetchPlacer(p, depth=1).stream(broken()))
        with pytest.raises(ValueError, match="depth"):
            PrefetchPlacer(p, depth=0)

    def test_prefetch_resolution(self):
        assert resolve_prefetch("auto", "cpu") == 0
        assert resolve_prefetch("auto", torch.device("cuda")) == 2
        assert resolve_prefetch(3, "cpu") == 3
        with pytest.raises(ValueError):
            resolve_prefetch("lots", "cpu")
        assert effective_block_obs(999) == 999 and effective_block_obs(10, 4) == 12
