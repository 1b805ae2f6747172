"""repro_torch Pearson score (``PearsonMIScore``) vs the JAX package on the CPU.

The port's plain row correlation (what the dispatcher runs on the CPU) is
held against the JAX ``pearson_rows`` and the JAX Pallas kernel in interpret
mode at ``rtol=1e-4, atol=1e-5`` (float32 sums in another order;
``tests/test_scores.py`` uses the same).  Fits on continuous data — the
alternative engine in memory and the streaming engine's running moments —
must select what the JAX package selects, with gains within the same
tolerance and identical streaming I/O ledgers.  The JAX side runs without a
mesh on one device.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scores as jscores
from repro.core.scores import PearsonMIScore as JPearson
from repro.core.selector import MRMRSelector as JSelector
from repro.core.streaming import mrmr_streaming as jstreaming
from repro.data import sources as jsources
from repro.data.synthetic import corral_dataset_np
from repro.kernels.pearson import pearson_corr_pallas

from repro_torch import (
    ArraySource,
    MRMRSelector,
    PearsonMIScore,
    cor2mi,
    mrmr_streaming,
    pearson_rows,
)
from repro_torch.core.scores import standardize_rows
from repro_torch.data.synthetic import continuous_dataset_np
from repro_torch.kernels import ops, ref
from repro_torch.kernels.pearson import (
    REREAD,
    RING_MAX_M,
    SMEM_MAX,
    STAGE_MAX,
    STAGED,
    STREAM,
    pearson_plan,
)

RTOL, ATOL = 1e-4, 1e-5
LEDGER = ("passes", "blocks_read", "bytes_read", "state_bytes")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def wide():
    """Continuous, wide: 400 observations x 600 features."""
    return continuous_dataset_np(400, 600, seed=2)


@pytest.fixture(scope="module")
def tall():
    return continuous_dataset_np(3000, 20, seed=5)


def _rows(f, t, m, seed):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(f, m)) * 3 + 5).astype(np.float32)
    Y = rng.normal(size=(t, m)).astype(np.float32)
    X[1] = 3.0  # a constant row correlates 0
    return X, Y


class TestCorrelation:
    @pytest.mark.parametrize("f,t,m", [(4, 1, 64), (37, 4, 1000), (130, 9, 1030)])
    def test_plain_matches_jax(self, f, t, m):
        X, Y = _rows(f, t, m, seed=f)
        got = ref.pearson_corr(torch.from_numpy(X), torch.from_numpy(Y))
        assert got.dtype == torch.float32 and got.shape == (f, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(jscores.pearson_rows(X, Y)),
                                   rtol=RTOL, atol=ATOL)
        assert torch.all(got[1] == 0)

    def test_pallas_interpret_agrees(self):
        X, Y = _rows(33, 3, 200, seed=1)
        pallas = np.asarray(pearson_corr_pallas(jnp.asarray(X), jnp.asarray(Y),
                                                interpret=True))
        got = ops.pearson_corr(torch.from_numpy(X), torch.from_numpy(Y))
        np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-4, atol=2e-5)

    def test_pearson_rows_vector_and_view(self):
        X, Y = _rows(50, 1, 300, seed=3)
        Xm = torch.from_numpy(np.ascontiguousarray(X.T)).T  # a transposed view
        got = pearson_rows(Xm, torch.from_numpy(Y[0]))
        assert got.shape == (50,)
        np.testing.assert_allclose(got.numpy(), np.asarray(jscores.pearson_rows(X, Y[0])),
                                   rtol=RTOL, atol=ATOL)

    def test_standardize_and_cor2mi_match_jax(self):
        X, _ = _rows(6, 1, 500, seed=4)
        np.testing.assert_allclose(standardize_rows(torch.from_numpy(X)).numpy(),
                                   np.asarray(jscores.standardize_rows(X)),
                                   rtol=RTOL, atol=ATOL)
        corr = np.linspace(-1.0, 1.0, 41).astype(np.float32)
        np.testing.assert_allclose(cor2mi(torch.from_numpy(corr)).numpy(),
                                   np.asarray(jscores.cor2mi(corr)), rtol=1e-6, atol=1e-6)

    def test_dispatch(self):
        X, Y = _rows(3, 1, 20, seed=5)
        with pytest.raises(ValueError, match="CUDA tensor"):
            ops.pearson_corr(torch.from_numpy(X), torch.from_numpy(Y), use_kernel=True)
        with pytest.raises(ValueError, match="use_kernel"):
            PearsonMIScore(use_kernel="always")


def _plan_case(name):
    """(X view, T) for one geometry the kernel's path rule must sort."""
    z = torch.zeros
    return {
        "contiguous T=1": (z(50, 10000), 1),
        "contiguous T=4": (z(50, 10000), 4),  # Y no longer fits beside the ring
        "small M, T=9": (z(50, 1000), 9),
        "M not a multiple of 4": (z(50, 10001), 1),
        "row stride not a multiple of 4": (z(50, 10002)[:, :10000], 1),
        "misaligned start": (z(50, 10004)[:, 1:10001], 1),
        "one row, odd stride": (z(3, 10002)[2:3, :10000], 1),  # starts 80,016 bytes in
        "longest streamed row": (z(2, RING_MAX_M), 1),
        "longest staged row, unaligned": (z(2, STAGE_MAX - 1), 1),
        "past the stage, unaligned": (z(2, STAGE_MAX + 1), 1),
        "past the ring": (z(2, RING_MAX_M + 4), 1),
    }[name]


@pytest.mark.parametrize("name,plan", [
    ("contiguous T=1", (STREAM, 4, 1)), ("contiguous T=4", (STREAM, 2, 3)),
    ("small M, T=9", (STREAM, 4, 9)), ("M not a multiple of 4", (STAGED, 0, 0)),
    ("row stride not a multiple of 4", (STAGED, 0, 0)), ("misaligned start", (STAGED, 0, 0)),
    ("one row, odd stride", (STREAM, 4, 1)), ("longest streamed row", (STREAM, 2, 0)),
    ("longest staged row, unaligned", (STAGED, 0, 0)),
    ("past the stage, unaligned", (REREAD, 0, 0)),
    ("past the ring", (REREAD, 0, 0)),
])
def test_kernel_path_follows_the_bulk_copy_rule(name, plan):
    # The streaming path moves each row with one bulk copy: a 16-byte-aligned
    # source and a multiple of 16 bytes; two to four row buffers and the Y
    # rows that fit share the block's 227 KB of shared memory.
    X, t = _plan_case(name)
    got = pearson_plan(X, t)
    assert tuple(got) == plan
    if got.path == STREAM:
        m = X.shape[1]
        assert X.data_ptr() % 16 == 0 and m % 4 == 0 and m <= RING_MAX_M
        assert 4 * (got.stages + got.y_rows) * m + 4 * 16 * 6 + 8 * got.stages <= SMEM_MAX


class TestInMemory:
    @pytest.mark.parametrize("criterion", ["mid", "miq", "maxrel"])
    def test_alternative_fit_matches_jax(self, wide, criterion):
        X, y = wide
        t = MRMRSelector(6, criterion=criterion, device="cpu").fit(X, y)
        j = JSelector(6, criterion=criterion, devices=1).fit(X, y)
        assert t.plan_.encoding == j.plan_.encoding == "alternative"
        assert isinstance(t.plan_.score, PearsonMIScore)
        np.testing.assert_array_equal(t.selected_, j.selected_)
        np.testing.assert_allclose(t.scores_, j.scores_, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(t.gains_, j.gains_, rtol=RTOL, atol=ATOL)
        assert t.selected_[0] in (0, 8)

    @pytest.mark.parametrize("encoding", ["reference", "alternative"])
    def test_engines_and_recompute_agree(self, tall, encoding):
        X, y = tall
        t = MRMRSelector(5, encoding=encoding, incremental=False, device="cpu").fit(X, y)
        j = JSelector(5, encoding=encoding, incremental=False, devices=1).fit(X, y)
        np.testing.assert_array_equal(t.selected_, j.selected_)
        np.testing.assert_allclose(t.gains_, j.gains_, rtol=RTOL, atol=ATOL)

    def test_float64_tensor_and_explicit_score(self, tall):
        X, y = tall
        a = MRMRSelector(4, device="cpu").fit(torch.from_numpy(X.astype(np.float64)), y)
        b = MRMRSelector(4, score=PearsonMIScore(use_kernel=False), device="cpu").fit(X, y)
        np.testing.assert_array_equal(a.selected_, b.selected_)
        np.testing.assert_allclose(a.gains_, b.gains_, rtol=RTOL, atol=ATOL)
        # A discrete X scored with Pearson keeps working (the rows are cast).
        Xi, yi = corral_dataset_np(800, 12, seed=1)
        c = MRMRSelector(3, score=PearsonMIScore(), device="cpu").fit(Xi, yi)
        d = JSelector(3, score=JPearson(), devices=1).fit(Xi, yi)
        np.testing.assert_array_equal(c.selected_, d.selected_)

    def test_feature_rows_copy(self):
        X = torch.arange(12, dtype=torch.float64).reshape(3, 4)
        rows = PearsonMIScore().feature_rows(X.T)
        assert rows.dtype == torch.float32 and rows.is_contiguous()
        assert torch.equal(rows, X.T.float())
        same = torch.zeros((2, 5))
        assert PearsonMIScore().feature_rows(same) is same

    def test_conditional_criterion_raises(self, tall):
        X, y = tall
        with pytest.raises(ValueError, match="conditional"):
            MRMRSelector(3, criterion="jmi", device="cpu").fit(X, y)


class TestStreaming:
    @pytest.mark.parametrize("block_obs,q", [(512, 1), (999, 1), (700, 3)])
    def test_streaming_matches_jax(self, tall, block_obs, q):
        X, y = tall
        t = mrmr_streaming((X, y), 5, PearsonMIScore(), block_obs=block_obs,
                           device="cpu", batch_candidates=q)
        j = jstreaming((X, y), 5, JPearson(), block_obs=block_obs, batch_candidates=q)
        np.testing.assert_array_equal(t.selected.numpy(), np.asarray(j.selected))
        np.testing.assert_allclose(t.gains.numpy(), np.asarray(j.gains),
                                   rtol=RTOL, atol=ATOL)
        assert {k: t.io[k] for k in LEDGER} == {k: j.io[k] for k in LEDGER}

    def test_moments_match_in_memory_relevance(self, tall):
        X, y = tall
        mem = MRMRSelector(5, device="cpu").fit(X, y)
        src = MRMRSelector(5, block_obs=640, device="cpu").fit(ArraySource(X, y))
        assert src.plan_.encoding == "streaming"
        assert isinstance(src.plan_.score, PearsonMIScore)
        np.testing.assert_allclose(src.scores_, mem.scores_, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(src.selected_, mem.selected_)
        np.testing.assert_allclose(src.gains_, mem.gains_, rtol=RTOL, atol=ATOL)

    def test_shifted_moments_survive_a_large_mean(self, tall):
        X, y = tall
        Xs = X + np.float32(1000.0)  # |mean| >> std
        a = MRMRSelector(4, block_obs=512, device="cpu").fit(ArraySource(Xs, y))
        b = MRMRSelector(4, block_obs=512, device="cpu").fit(ArraySource(X, y))
        np.testing.assert_array_equal(a.selected_, b.selected_)
        np.testing.assert_allclose(a.scores_, b.scores_, rtol=1e-3, atol=1e-4)

    def test_float64_source_matches_jax(self, tall, tmp_path):
        X, y = tall
        src = jsources.ArraySource(X.astype(np.float64), y)
        xp, yp = src.to_npy(str(tmp_path / "X.npy"), str(tmp_path / "y.npy"))
        from repro_torch import NpySource

        t = MRMRSelector(4, block_obs=1024, device="cpu").fit(NpySource(xp, yp))
        j = jstreaming(jsources.NpySource(xp, yp), 4, JPearson(), block_obs=1024)
        np.testing.assert_array_equal(t.selected_, np.asarray(j.selected))
        assert t.result_.io["bytes_read"] == j.io["bytes_read"]

    def test_state_dict_ledger(self):
        st = PearsonMIScore().init_state(7)
        assert sorted(st) == ["mu_t", "mu_x", "n", "st", "stt", "sx", "sxt", "sxx"]
        jst = JPearson().init_state(7)
        assert sum(v.numel() * v.element_size() for v in st.values()) == sum(
            np.asarray(v).nbytes for v in jst.values())


def test_cli_pearson_matches_jax_selector():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.select", "--rows", "300",
           "--cols", "400", "--select", "4", "--score", "pearson", "--device", "cpu"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, check=True,
                         timeout=120)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["encoding"] == "alternative" and rec["device"] == "cpu"
    X, y = corral_dataset_np(300, 400, seed=0)
    j = JSelector(4, score=JPearson(), devices=1).fit(X.astype(np.float32), y)
    assert rec["selected"] == j.selected_.tolist()
