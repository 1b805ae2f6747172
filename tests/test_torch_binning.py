"""repro_torch quantile binning (``bins=``) vs the JAX package on the CPU.

The port's numpy binner is a copy of the JAX one: fitted edges must be
bitwise equal for every ``block_obs`` and through ``merge``.  Bin codes from
the port's plain ``bin_codes`` (what the dispatcher runs on the CPU) must
equal the JAX ``ref.bin_codes``, the JAX Pallas kernel in interpret mode and
``QuantileBinner.transform`` bitwise, ties on edges included.  Binned fits
(streaming, fused, and in memory) must select what the JAX streaming engine
selects, with gains within ``rtol=1e-5, atol=1e-6`` and identical I/O
ledgers.  The JAX side runs without a mesh on one device.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scores import MIScore as JMIScore
from repro.core.selector import MRMRSelector as JSelector
from repro.core.streaming import mrmr_streaming as jstreaming
from repro.data import binning as jbinning
from repro.data import sources as jsources
from repro.kernels import ref as jref
from repro.kernels.binning import bin_codes_pallas

from repro_torch import (
    ArraySource,
    BinnedSource,
    MIScore,
    MRMRSelector,
    PearsonMIScore,
    QuantileBinner,
    QuantileSketch,
    fit_binned,
    mrmr_streaming,
)
from repro_torch.data import binning as tbinning
from repro_torch.data.synthetic import continuous_dataset_np, corral_dataset_np
from repro_torch.kernels import ops, ref
from repro_torch.kernels.binning import _scalar_plan, bin_codes_plan

RTOL, ATOL = 1e-5, 1e-6
LEDGER = ("passes", "blocks_read", "bytes_read", "state_bytes")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cont():
    return continuous_dataset_np(3000, 24, seed=4)


def _planted(seed=0, b=300, n=7, e=15):
    """Float32 block, sorted edges (one repeated), values planted on edges,
    signed zeros against a 0.0 edge, and +-1e30."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b, n)).astype(np.float32)
    edges = rng.normal(size=(n, e)).astype(np.float32)
    edges[0, e // 2] = 0.0
    edges = np.sort(edges, axis=1)
    if e >= 2:
        edges[:, 1] = edges[:, 0]  # a duplicate edge leaves a bin empty
    X[::5] = edges[np.arange(n), rng.integers(0, e, n)]  # ties go up
    X[1, :] = -0.0
    X[2, :] = 0.0
    X[3, :] = 1e30
    X[4, :] = -1e30
    return X, edges


class TestSketch:
    @pytest.mark.parametrize("block_obs", [64, 999, 4096])
    def test_edges_bitwise_like_jax(self, cont, block_obs):
        X, y = cont
        t = QuantileBinner(16, sketch_k=64).fit(ArraySource(X, y), block_obs)
        j = jbinning.QuantileBinner(16, sketch_k=64).fit(
            jsources.ArraySource(X, y), block_obs)
        assert t.edges_.dtype == np.float32
        np.testing.assert_array_equal(t.edges_, j.edges_)
        assert (t.num_classes_, t.n_obs_) == (j.num_classes_, j.n_obs_)

    def test_merge_bitwise_like_jax(self, cont):
        X, _ = cont
        qs = np.arange(1, 8) / 8

        def merged(mod):
            a = mod.QuantileSketch(24, k=32, seed=3).update(X[:1700])
            b = mod.QuantileSketch(24, k=32, seed=3).update(X[1700:])
            return a.merge(b)

        t, j = merged(tbinning), merged(jbinning)
        assert (t.count, t.levels) == (j.count, j.levels)
        np.testing.assert_array_equal(t.quantiles(qs), j.quantiles(qs))

    def test_rejects_nonfinite_and_geometry(self):
        s = QuantileSketch(3, k=8)
        with pytest.raises(ValueError, match="non-finite"):
            s.update(np.array([[0.0, np.nan, 1.0]]))
        with pytest.raises(ValueError, match="geometry"):
            s.merge(QuantileSketch(4, k=8))
        with pytest.raises(ValueError, match="bins"):
            QuantileBinner(1)


class TestCodes:
    @pytest.mark.parametrize("e", [1, 15, 63, 70])
    def test_plain_bitwise_like_jax_and_host(self, e):
        X, edges = _planted(seed=e, e=e)
        got = ref.bin_codes(torch.from_numpy(X), torch.from_numpy(edges))
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(jref.bin_codes(X, edges)))
        binner = QuantileBinner(e + 1)
        binner.edges_ = edges
        np.testing.assert_array_equal(got.numpy(), binner.transform(X))

    def test_pallas_interpret_agrees(self):
        X, edges = _planted(seed=5, b=260, n=130)
        pallas = np.asarray(bin_codes_pallas(jnp.asarray(X), jnp.asarray(edges),
                                             interpret=True))
        got = ops.bin_codes(torch.from_numpy(X), torch.from_numpy(edges))
        np.testing.assert_array_equal(got.numpy(), pallas)

    def test_float64_and_strided_input(self):
        X, edges = _planted(seed=6)
        X64 = X.astype(np.float64)
        X64[7, 0] = np.nextafter(np.float64(edges[0, 4]), -np.inf)  # rounds onto it
        want = np.asarray(jref.bin_codes(X64, edges))
        got = ref.bin_codes(torch.from_numpy(X64), torch.from_numpy(edges))
        np.testing.assert_array_equal(got.numpy(), want)
        sliced = torch.from_numpy(X)[::3]
        np.testing.assert_array_equal(
            ref.bin_codes(sliced, torch.from_numpy(edges)).numpy(),
            np.asarray(jref.bin_codes(X[::3], edges)))

    def test_empty_and_dispatch(self):
        edges = torch.zeros((4, 3))
        assert ref.bin_codes(torch.zeros((0, 4)), edges).shape == (0, 4)
        with pytest.raises(ValueError, match="CUDA tensor"):
            ops.bin_codes(torch.zeros((2, 4)), edges, use_kernel=True)
        with pytest.raises(ValueError, match="use_kernel"):
            ops.bin_codes(torch.zeros((2, 4)), edges, use_kernel="yes")


class _RowsGeom:
    """A row-major float32 (b, n) block's geometry without its memory."""

    def __init__(self, b, n):
        self.shape = (b, n)

    def stride(self, dim=None):
        return (self.shape[1], 1) if dim is None else (self.shape[1], 1)[dim]

    def data_ptr(self):
        return 1 << 20


class TestBinCodesPlan:
    """The kernel's host-side plan (``kernels/binning.py::bin_codes_plan``);
    the kernel itself runs on the card only (``tests/test_torch_cuda.py``)."""

    @staticmethod
    def _covers(plan, b, n):
        lanes = max(plan.fpl, 1)
        assert plan.threads % 32 == 0 and 1 <= plan.grid <= plan.items
        assert plan.items % plan.feat_items == 0
        assert plan.feat_items * 32 * lanes >= n > (plan.feat_items - 1) * 32 * lanes
        row_items = plan.items // plan.feat_items
        assert plan.rows_per_item * row_items >= b > plan.rows_per_item * (row_items - 1)

    @pytest.mark.parametrize("b,n", [(65536, 1000), (1_000_000, 1000), (65499, 1000),
                                     (1, 1), (7, 70), (300, 4096)])
    @pytest.mark.parametrize("e", [1, 15, 31, 63, 70])
    def test_covers_every_row_and_feature(self, b, n, e):
        plan = bin_codes_plan(_RowsGeom(b, n), e, sms=132)
        self._covers(plan, b, n)

    @pytest.mark.parametrize("e,want", [(1, 4), (15, 4), (16, 4), (17, 1), (31, 1), (32, 1),
                                        (33, 1), (63, 1), (64, 1), (65, 0), (70, 0)])
    def test_path_by_edges(self, e, want):
        assert bin_codes_plan(torch.empty((512, 1000)), e).fpl == want

    def test_views_take_the_scalar_width(self):
        X = torch.empty((2000, 50))
        assert bin_codes_plan(X[3:1500:2], 15).fpl == 1  # 600 bytes in: 8-aligned only
        assert bin_codes_plan(X[3:1500:2, 1:], 15).fpl == 1  # 604 bytes in
        assert bin_codes_plan(X[:, 1:], 15).fpl == 1
        Z = torch.empty((2000, 48))
        assert bin_codes_plan(Z[4:1500:2], 15).fpl == 4  # 768 bytes in, 384-byte rows
        assert bin_codes_plan(Z[:, 2:], 15).fpl == 1  # 8 bytes in
        Y = torch.empty((64, 1000))
        assert bin_codes_plan(Y[:, :998], 15).fpl == 1  # N a multiple of 2, not 4
        assert bin_codes_plan(Y[::3], 15).fpl == 4  # a row stride, aligned
        assert _scalar_plan(Y, 15).fpl == 1
        assert _scalar_plan(Y, 70).fpl == 0  # no register path past 64 edges

    def test_grid_is_persistent(self):
        plan = bin_codes_plan(_RowsGeom(1_000_000, 1000), 15, sms=132)
        assert plan.grid <= 132 * 2 and plan.items >= plan.grid


class TestBinnedSource:
    def test_blocks_and_stats(self, cont):
        X, y = cont
        src = BinnedSource(ArraySource(X, y), 8, sketch_k=64)
        jsrc = jbinning.BinnedSource(jsources.ArraySource(X, y), 8, sketch_k=64)
        for (tx, ty), (jx, jy) in zip(src.iter_blocks(700), jsrc.iter_blocks(700)):
            assert tx.dtype == jx.dtype == np.int32 and ty.dtype == jy.dtype
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
        st = src.stats()
        assert (st.discrete, st.num_values, st.num_classes) == (True, 8, 2)
        assert src.feature_dtype == np.int32

    def test_memo_and_fingerprint(self, cont):
        X, y = cont
        tbinning.clear_binner_memo()
        base = ArraySource(X, y)
        first = fit_binned(base, 8).binner
        assert BinnedSource(base, 8).binner is first  # no second sketch pass
        assert BinnedSource(base, 8).fingerprint() != BinnedSource(base, 16).fingerprint()
        tbinning.clear_binner_memo()
        assert BinnedSource(base, 8).binner is not first

    def test_guards(self, cont):
        X, y = cont
        src = ArraySource(X, y)
        with pytest.raises(ValueError, match="already binned"):
            BinnedSource(BinnedSource(src, 4), 4)
        with pytest.raises(TypeError, match="DataSource"):
            BinnedSource(np.zeros((2, 2)), 4)
        with pytest.raises(ValueError, match="exactly one"):
            BinnedSource(src)
        with pytest.raises(ValueError, match="exactly one"):
            BinnedSource(src, 4, binner=QuantileBinner(4))

    def test_target_labels(self):
        assert tbinning._as_class_labels(np.array([0.0, 1.0, 2.0])).dtype == np.int32
        with pytest.raises(ValueError, match="non-integral"):
            tbinning._as_class_labels(np.array([0.5, 1.0]))
        with pytest.raises(ValueError, match="negative"):
            tbinning._as_class_labels(np.array([-1, 1]))


def _jax_binned(X, y, L, criterion="mid", block_obs=512, q=1, bins=16):
    return jstreaming(
        jbinning.BinnedSource(jsources.ArraySource(X, y), bins, fit_block_obs=block_obs),
        L, JMIScore(bins, 2), block_obs=block_obs, criterion=criterion,
        batch_candidates=q)


def _same_fit(t, j):
    np.testing.assert_array_equal(t.selected.numpy(), np.asarray(j.selected))
    np.testing.assert_allclose(t.gains.numpy(), np.asarray(j.gains), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.relevance.numpy(), np.asarray(j.relevance),
                               rtol=RTOL, atol=ATOL)
    assert {k: t.io[k] for k in LEDGER} == {k: j.io[k] for k in LEDGER}


class TestBinnedStreaming:
    @pytest.mark.parametrize("criterion,q", [("mid", 1), ("jmi", 1), ("mid", 3)])
    def test_fused_fit_matches_jax(self, cont, criterion, q):
        X, y = cont
        t = mrmr_streaming(
            BinnedSource(ArraySource(X, y), 16, fit_block_obs=512), 5, MIScore(16, 2),
            block_obs=512, device="cpu", criterion=criterion, batch_candidates=q)
        _same_fit(t, _jax_binned(X, y, 5, criterion, q=q))
        # the fused path counts the RAW float blocks, as the JAX engine does
        assert t.io["bytes_read"] == t.io["passes"] * (X.nbytes + y.nbytes)

    @pytest.mark.parametrize("block_obs", [128, 999, 4096])
    def test_selector_streaming_equals_in_memory(self, cont, block_obs):
        X, y = cont
        mem = MRMRSelector(5, bins=16, device="cpu").fit(X, y)
        src = MRMRSelector(5, bins=16, block_obs=block_obs, device="cpu").fit(
            ArraySource(X, y))
        assert (mem.plan_.bins, src.plan_.bins) == (16, 16)
        assert mem.plan_.encoding == "conventional" and src.plan_.encoding == "streaming"
        assert mem.plan_.score == MIScore(16, 2)
        np.testing.assert_array_equal(src.selected_, mem.selected_)
        np.testing.assert_allclose(src.gains_, mem.gains_, rtol=RTOL, atol=ATOL)

    def test_in_memory_matches_jax_selector(self, cont):
        X, y = cont
        t = MRMRSelector(5, bins=16, device="cpu").fit(torch.from_numpy(X), y)
        j = JSelector(5, bins=16, devices=1).fit(X, y)
        np.testing.assert_array_equal(t.selected_, j.selected_)
        np.testing.assert_allclose(t.gains_, j.gains_, rtol=RTOL, atol=ATOL)
        assert t.plan_.bins == j.plan_.bins == 16

    def test_float64_source_and_wide_alternative(self, cont):
        X, y = cont
        a = MRMRSelector(4, bins=8, block_obs=700, device="cpu").fit(
            ArraySource(X.astype(np.float64), y))
        b = MRMRSelector(4, bins=8, encoding="alternative", device="cpu").fit(X, y)
        c = MRMRSelector(4, device="cpu").fit(BinnedSource(ArraySource(X, y), 8))
        np.testing.assert_array_equal(a.selected_, b.selected_)
        np.testing.assert_array_equal(a.selected_, c.selected_)
        assert c.plan_.bins == 8
        assert a.result_.io["bytes_read"] == 4 * (X.astype(np.float64).nbytes + y.nbytes)

    def test_plain_versions_select_the_same(self, cont):
        X, y = cont
        a = MRMRSelector(5, bins=16, device="cpu").fit(X, y)
        b = MRMRSelector(5, score=MIScore(16, 2, use_kernel=False), bins=16,
                         device="cpu").fit(X, y)
        np.testing.assert_array_equal(a.selected_, b.selected_)
        np.testing.assert_allclose(a.gains_, b.gains_, rtol=RTOL, atol=ATOL)


def test_nan_rows_of_a_fitted_binner_take_the_top_code_like_jax(cont):
    """A fitted binner handed to BinnedSource skips the sketch and its
    finiteness check, so NaN reaches the encode: it takes code E (the top
    bin, as searchsorted sorts it) in the port's plain codes, the host
    binner and the JAX package, and the port's streamed and in-memory fits
    select what the JAX fit selects, relevance and gains included."""
    X, y = cont
    binner = QuantileBinner(8).fit(ArraySource(X, y))
    jbinner = jbinning.QuantileBinner(8).fit(jsources.ArraySource(X, y))
    Xn = X.copy()
    Xn[::3, 1] = np.nan  # a third of one relevant column
    codes = ops.bin_codes(torch.from_numpy(Xn), torch.from_numpy(binner.edges_))
    jcodes, jlabels = jbinning.BinnedSource(
        jsources.ArraySource(Xn, y), binner=jbinner).materialize(700)
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    np.testing.assert_array_equal(codes.numpy(), binner.transform(Xn))
    assert np.all(codes.numpy()[::3, 1] == 7)
    j = JSelector(5, devices=1).fit(
        jbinning.BinnedSource(jsources.ArraySource(Xn, y), binner=jbinner))
    streamed = MRMRSelector(5, block_obs=700, device="cpu").fit(
        BinnedSource(ArraySource(Xn, y), binner=binner))
    in_memory = MRMRSelector(5, device="cpu").fit(codes, torch.from_numpy(jlabels))
    for t in (streamed, in_memory):
        np.testing.assert_array_equal(t.selected_, j.selected_)
        np.testing.assert_allclose(t.scores_, j.scores_, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(t.gains_, j.gains_, rtol=RTOL, atol=ATOL)


class TestSelectorGuards:
    def test_explicit_score_num_values_guard(self, cont):
        X, y = cont
        with pytest.raises(ValueError, match="num_values"):
            MRMRSelector(2, score=MIScore(4, 2), bins=16, device="cpu").fit(X, y)
        with pytest.raises(ValueError, match="num_values"):
            MRMRSelector(2, score=MIScore(4, 2), bins=16, device="cpu").fit(
                ArraySource(X, y))

    def test_continuous_target_raises(self, cont):
        X, y = cont
        yf = y + 0.25
        with pytest.raises(ValueError, match="non-integral"):
            MRMRSelector(2, bins=8, device="cpu").fit(X, yf)
        with pytest.raises(ValueError, match="non-integral"):
            MRMRSelector(2, bins=8, device="cpu").fit(ArraySource(X, yf))

    def test_continuous_mi_early_error(self, cont):
        X, y = cont
        with pytest.raises(ValueError, match="bins="):
            MRMRSelector(2, score=MIScore(2, 2), device="cpu").fit(X, y)
        with pytest.raises(ValueError, match="bins="):
            MRMRSelector(2, score=MIScore(2, 2), device="cpu").fit(ArraySource(X, y))

    def test_bins_ignored_for_discrete_and_pearson(self, cont):
        rng = np.random.default_rng(14)
        Xd = rng.integers(0, 3, size=(400, 5))
        yd = rng.integers(0, 2, size=400)
        fd = MRMRSelector(2, bins=16, device="cpu").fit(Xd, yd)
        jd = JSelector(2, bins=16, devices=1).fit(Xd, yd)
        assert fd.plan_.bins is None and jd.plan_.bins is None
        np.testing.assert_array_equal(fd.selected_, jd.selected_)
        sd = MRMRSelector(2, bins=16, block_obs=128, device="cpu").fit(ArraySource(Xd, yd))
        assert sd.plan_.bins is None
        X, y = cont
        fp = MRMRSelector(2, bins=16, score=PearsonMIScore(), device="cpu").fit(X, y)
        assert fp.plan_.bins is None and isinstance(fp.plan_.score, PearsonMIScore)
        sp = MRMRSelector(2, bins=16, score=PearsonMIScore(), device="cpu").fit(
            ArraySource(X, y))
        assert sp.plan_.bins is None and sp.plan_.encoding == "streaming"


def test_cli_bins_matches_jax_selector():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.select", "--rows", "2000",
           "--cols", "20", "--select", "4", "--bins", "8", "--device", "cpu"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, check=True,
                         timeout=120)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["bins"] == 8 and rec["device"] == "cpu"
    X, y = corral_dataset_np(2000, 20, seed=0)
    j = JSelector(4, bins=8, devices=1).fit(X.astype(np.float32), y)
    assert rec["selected"] == j.selected_.tolist()
