"""repro_torch kernels and dispatch vs the JAX package's Pallas kernels.

The port's CUDA kernels cannot run here (no card, no nvcc), so on the CPU
the dispatcher runs their plain PyTorch versions; these tests hold those,
bitwise for counts and within ``rtol=1e-5, atol=1e-6`` for MI, against the
JAX Pallas kernels run in interpret mode (as ``tests/test_kernels.py`` runs
them) and the JAX core functions, on the same numpy inputs.  The kernels
themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import contingency as jcont
from repro.core import scores as jscores
from repro.kernels.contingency import (
    conditional_tables_pallas,
    contingency_tables_pallas,
)
from repro.kernels.mi_score import mi_scores_pallas

from repro_torch.core import scores as tscores
from repro_torch.core.contingency import OOR
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.contingency import (
    GLOBAL,
    SHARED,
    SMEM_MAX,
    SWAR,
    _forced_plan,
    swar_tile,
    conditional_tables_cuda,
    contingency_plan,
    contingency_tables_cuda,
)
from repro_torch.kernels.mi_score import mi_plan, mi_scores_cuda

RTOL, ATOL = 1e-5, 1e-6


def _counts_data(m, f, v, c, np_dtype, seed, dirty=False):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, v, (m, f)).astype(np.int64)
    y = rng.integers(0, c, m).astype(np.int64)
    if dirty:
        X[rng.random((m, f)) < 0.05] = -1
        y[rng.random(m) < 0.05] = -3
        y[rng.random(m) < 0.05] = OOR
        if np.dtype(np_dtype).itemsize == 4:
            X[rng.random((m, f)) < 0.05] = OOR
    return X.astype(np_dtype), y.astype(np.int32)


def _as_int(a):
    return np.asarray(a).astype(np.int64)


class TestContingency:
    @pytest.mark.parametrize("np_dtype", [np.int8, np.int16, np.int32])
    @pytest.mark.parametrize(
        "m,f,v,c,dirty",
        [
            (16, 4, 2, 2, False),
            (100, 7, 3, 2, True),    # ragged M, negatives + sentinels
            (1030, 33, 5, 4, True),  # ragged on both axes
            (64, 1, 2, 2, False),    # single feature
        ],
    )
    def test_matches_pallas_and_batched_counts(self, np_dtype, m, f, v, c, dirty):
        X, y = _counts_data(m, f, v, c, np_dtype, seed=m * 31 + f, dirty=dirty)
        got = ops.contingency_tables(torch.from_numpy(X), torch.from_numpy(y), v, c)
        assert got.dtype == torch.int32 and got.shape == (f, v, c)
        pallas = contingency_tables_pallas(
            jnp.asarray(X), jnp.asarray(y), v, c, interpret=True
        )
        jref = jcont.batched_counts(jnp.asarray(X), jnp.asarray(y), v, c, block=8)
        np.testing.assert_array_equal(got.numpy(), _as_int(pallas))
        np.testing.assert_array_equal(got.numpy(), _as_int(jref))

    def test_feature_major_view_counts_like_columns(self):
        X, y = _counts_data(300, 40, 3, 2, np.int8, seed=5)
        rows = torch.from_numpy(np.ascontiguousarray(X.T))  # (F, M) storage
        got = ops.contingency_tables(rows.T, torch.from_numpy(y), 3, 2)
        want = jcont.batched_counts(jnp.asarray(X), jnp.asarray(y), 3, 2)
        np.testing.assert_array_equal(got.numpy(), _as_int(want))

    @pytest.mark.parametrize("m,f,v,c", [(200, 9, 2, 2), (513, 17, 3, 4)])
    def test_conditional_matches_pallas(self, m, f, v, c):
        X, y = _counts_data(m, f, v, c, np.int32, seed=7, dirty=True)
        xj = X[:, 2].copy()
        got = ops.conditional_tables(
            torch.from_numpy(X), torch.from_numpy(xj), torch.from_numpy(y), v, c
        )
        assert got.shape == (f, v, v, c)
        pallas = conditional_tables_pallas(
            jnp.asarray(X), jnp.asarray(xj), jnp.asarray(y), v, c, interpret=True
        )
        jref = jcont.conditional_counts(
            jnp.asarray(X), jnp.asarray(xj), jnp.asarray(y), v, v, c
        )
        np.testing.assert_array_equal(got.numpy(), _as_int(pallas))
        np.testing.assert_array_equal(got.numpy(), _as_int(jref))

    def test_all_padding_counts_nothing(self):
        X = torch.tensor([[0], [1], [OOR]], dtype=torch.int32)
        y = torch.tensor([0, 1, OOR], dtype=torch.int32)
        got = ops.contingency_tables(X, y, 2, 2)
        np.testing.assert_array_equal(got[0].numpy(), [[1, 0], [0, 1]])


class TestMIScores:
    # (1000, 16, 16): the binned fits' redundancy tables; (2000, 2, 2): the
    # class slices of a (1000, 2, 2, 2) conditional stack.
    @pytest.mark.parametrize("shape", [(1, 2, 2), (37, 3, 4), (300, 2, 2), (64, 5, 3),
                                       (1000, 16, 16), (2000, 2, 2)])
    def test_matches_pallas_and_mi_from_counts(self, shape):
        rng = np.random.default_rng(sum(shape))
        counts = rng.integers(0, 50, shape).astype(np.int32)
        counts[::5] = 0  # all-zero tables
        counts[1::5, 0] = 0  # zero cells
        got = ops.mi_scores(torch.from_numpy(counts))
        assert got.dtype == torch.float32 and got.shape == shape[:1]
        pallas = mi_scores_pallas(jnp.asarray(counts, jnp.float32), interpret=True)
        jref = jscores.mi_from_counts(jnp.asarray(counts))
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=RTOL, atol=ATOL)
        assert np.all(got.numpy()[::5] == 0)

    @pytest.mark.parametrize("shape", [(1000, 2, 2, 2), (60, 16, 16, 2)])
    def test_conditional_view_matches_pallas_and_cmi(self, shape):
        rng = np.random.default_rng(sum(shape))
        stack = rng.integers(0, 50, shape).astype(np.int32)
        stack[::9] = 0
        view = torch.from_numpy(stack).movedim(-1, -3)  # what the kernel reads in place
        got = ops.mi_scores(view)
        assert got.shape == view.shape[:2]
        slices = np.ascontiguousarray(np.moveaxis(stack, -1, -3)).reshape(-1, *shape[1:3])
        pallas = mi_scores_pallas(jnp.asarray(slices, jnp.float32), interpret=True)
        np.testing.assert_allclose(got.reshape(-1).numpy(), np.asarray(pallas),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tscores.cmi_from_counts(torch.from_numpy(stack)).numpy(),
                                   np.asarray(jscores.cmi_from_counts(jnp.asarray(stack))),
                                   rtol=RTOL, atol=ATOL)

    def test_float_counts(self):
        counts = np.random.default_rng(0).integers(0, 9, (20, 2, 3)).astype(np.float32)
        got = ref.mi_scores(torch.from_numpy(counts))
        want = jscores.mi_from_counts(jnp.asarray(counts))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


class TestDispatch:
    def test_auto_on_cpu_runs_plain_and_counts_no_launch(self):
        X, y = _counts_data(50, 4, 2, 2, np.int8, seed=1)
        before = contingency_tables_cuda.launches, mi_scores_cuda.launches
        ops.mi_scores(ops.contingency_tables(torch.from_numpy(X), torch.from_numpy(y), 2, 2))
        assert (contingency_tables_cuda.launches, mi_scores_cuda.launches) == before

    @pytest.mark.parametrize("fn", ["contingency", "mi"])
    def test_forced_kernel_on_cpu_raises(self, fn):
        X, y = _counts_data(50, 4, 2, 2, np.int8, seed=1)
        with pytest.raises(ValueError, match="CUDA tensor"):
            if fn == "contingency":
                ops.contingency_tables(
                    torch.from_numpy(X), torch.from_numpy(y), 2, 2, use_kernel=True
                )
            else:
                ops.mi_scores(torch.zeros((3, 2, 2)), use_kernel=True)

    def test_forced_plain_matches_auto(self):
        X, y = _counts_data(80, 6, 3, 2, np.int16, seed=2)
        a = ops.contingency_tables(torch.from_numpy(X), torch.from_numpy(y), 3, 2)
        b = ops.contingency_tables(
            torch.from_numpy(X), torch.from_numpy(y), 3, 2, use_kernel=False
        )
        assert torch.equal(a, b)

    @pytest.mark.parametrize("bad", ["yes", None, 1.0])
    def test_bad_use_kernel_raises(self, bad):
        with pytest.raises(ValueError, match="use_kernel"):
            ops.mi_scores(torch.zeros((1, 2, 2)), use_kernel=bad)

    @pytest.mark.parametrize(
        "wrapper,args",
        [
            (contingency_tables_cuda, (torch.zeros((4, 2), dtype=torch.int8),
                                       torch.zeros(4, dtype=torch.int32), 2, 2)),
            (conditional_tables_cuda, (torch.zeros((4, 2), dtype=torch.int8),
                                       torch.zeros(4, dtype=torch.int32),
                                       torch.zeros(4, dtype=torch.int32), 2, 2)),
            (mi_scores_cuda, (torch.zeros((3, 2, 2)),)),
        ],
    )
    def test_kernel_wrappers_refuse_cpu_tensors(self, wrapper, args):
        with pytest.raises(ValueError, match="CUDA tensor"):
            wrapper(*args)


class TestBuildAndGeometry:
    def test_library_key_follows_source_and_flags(self):
        a = _build._lib_path("contingency")
        b = _build._lib_path("mi_score")
        assert a != b and a.parent.parent == _build.BUILD
        assert a == _build._lib_path("contingency")  # stable

    def test_every_source_has_a_signature(self):
        sources = {p.stem for p in _build.CSRC.glob("*.cu")}
        assert sources == set(_build.SIGNATURES)

    def test_missing_nvcc_raises(self, monkeypatch):
        monkeypatch.setenv("PATH", "")
        monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc()

    @pytest.mark.parametrize(
        "m,f,cells,lanes_on_rows",
        [(65536, 1000, 4, False), (1_000_000, 1000, 8, False),
         (10_000, 50_000, 4, True), (37, 3, 2048, False), (1, 1, 4, True)],
    )
    def test_launch_geometry_covers_every_row_and_feature(self, m, f, cells, lanes_on_rows):
        v, c = {4: (2, 2), 8: (2, 4), 2048: (32, 64)}[cells]
        dtype = torch.int16 if cells == 2048 else torch.int8
        X = _geometry(m, f, dtype, "feature-major" if lanes_on_rows else "row-major")
        plan = contingency_plan(X, v, c, sms=132)
        _assert_covers(plan, m, f, v, c)
        assert plan.lanes_on_rows == lanes_on_rows
        assert plan.path == (GLOBAL if cells == 2048 else SHARED if lanes_on_rows else SWAR)


class _Geom:
    """Shape, strides, element size and address of a tensor, without its
    memory: the plan reads nothing else."""

    def __init__(self, shape, strides, itemsize, ptr=1 << 20):
        self.shape, self._strides, self._itemsize, self._ptr = shape, strides, itemsize, ptr

    def stride(self):
        return self._strides

    def element_size(self):
        return self._itemsize

    def data_ptr(self):
        return self._ptr


def _geometry(m, f, dtype, layout, offset=0):
    size = torch.empty((), dtype=dtype).element_size()
    strides = (f, 1) if layout == "row-major" else (1, m)
    return _Geom((m, f), strides, size, (1 << 20) + offset * size)


def _assert_covers(plan, m, f, v=2, c=2):
    """Every row and feature lies in exactly one work item; the launch fits."""
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert 0 <= plan.smem <= SMEM_MAX
    if plan.path == GLOBAL:
        assert plan.grid >= 1 and plan.vec == 1
        return
    assert 1 <= plan.grid <= plan.items
    assert plan.items % plan.feat_items == 0
    row_items = plan.items // plan.feat_items
    assert plan.rows_per_item * row_items >= m > plan.rows_per_item * (row_items - 1)
    if plan.lanes_on_rows:  # one feature per warp, rows in 32 x vec chunks
        warps = plan.threads // 32
        assert plan.feat_items * warps >= f > (plan.feat_items - 1) * warps
        assert plan.rows_per_item % (32 * plan.vec) == 0
    else:  # feature tiles, rows in groups of 32
        tile = swar_tile(v, c) if plan.path == SWAR else 32 * plan.vec
        assert plan.feat_items * tile >= f > (plan.feat_items - 1) * tile
        assert plan.rows_per_item % 32 == 0


class TestContingencyPlan:
    @pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.int16, torch.int32,
                                       torch.int64])
    @pytest.mark.parametrize("layout", ["row-major", "feature-major"])
    @pytest.mark.parametrize("m,f,v,c", [(65536, 1000, 2, 2), (1_000_000, 1000, 16, 16),
                                         (70001, 333, 2, 4), (10_000, 50_000, 16, 2),
                                         (5, 7, 16, 32), (3, 1, 2, 2)])
    def test_covers_every_row_and_feature(self, dtype, layout, m, f, v, c):
        plan = contingency_plan(_geometry(m, f, dtype, layout), v, c, sms=132)
        _assert_covers(plan, m, f, v, c)

    @pytest.mark.parametrize("m,f,dtype,layout,v,c,want", [
        # CorrAL's 1000-byte rows: 8-byte words; 1024-byte rows and columns: 16.
        (1_000_000, 1000, torch.int8, "row-major", 2, 2, (SWAR, False, 8)),
        (65536, 1024, torch.int8, "row-major", 2, 4, (SWAR, False, 16)),
        (10_000, 50_000, torch.int8, "feature-major", 2, 2, (SHARED, True, 16)),
        (10_000, 50_000, torch.uint8, "row-major", 4, 2, (SHARED, False, 16)),
        # int32 bin codes: shared tables, 16-byte loads.
        (65536, 1000, torch.int32, "row-major", 16, 2, (SHARED, False, 4)),
        (1_000_000, 1000, torch.int32, "row-major", 16, 16, (SHARED, False, 4)),
        (65536, 1000, torch.int64, "feature-major", 16, 2, (SHARED, True, 2)),
        (65536, 1000, torch.int8, "row-major", 16, 2, (SHARED, False, 8)),
        # Beyond shared memory: global atomics (a feature-major warp's own
        # 2048-cell table still fits).
        (5000, 20, torch.int16, "row-major", 32, 64, (GLOBAL, False, 1)),
        (5000, 20, torch.int16, "feature-major", 32, 64, (SHARED, True, 8)),
        (5000, 20, torch.int16, "feature-major", 64, 512, (GLOBAL, True, 1)),
    ])
    def test_paths(self, m, f, dtype, layout, v, c, want):
        plan = contingency_plan(_geometry(m, f, dtype, layout), v, c, sms=132)
        assert (plan.path, plan.lanes_on_rows, plan.vec) == want

    def test_shared_tables_fit_and_keep_threads(self):
        # 256 cells x 128 features: 128 KB, one block of 1024 threads per SM.
        plan = contingency_plan(_geometry(65536, 1000, torch.int32, "row-major"), 16, 16)
        assert plan.smem == 256 * 128 * 4 and plan.threads == 1024
        # 512 cells keep a shared table by halving the load width.
        plan = contingency_plan(_geometry(65536, 1000, torch.int32, "row-major"), 16, 32)
        assert (plan.path, plan.vec, plan.smem) == (SHARED, 2, 512 * 64 * 4)
        assert plan.smem <= SMEM_MAX

    def test_unaligned_views_take_the_scalar_width(self):
        X = torch.zeros((3000, 257), dtype=torch.int8)
        for view in (X[:, 3:200:2], X[:, 1:], X[1:], X[:, 5:6]):
            plan = contingency_plan(view, 2, 2)
            assert plan.vec == 1 and plan.path == SHARED
        Y = torch.zeros((300, 1000), dtype=torch.int8)
        assert contingency_plan(Y[1:], 2, 2).vec in (8, 16)  # 1000-byte rows, 8-byte aligned
        assert contingency_plan(Y[:, 1:], 2, 2).vec == 1

    def test_forced_paths(self):
        X = _geometry(65536, 1000, torch.int8, "row-major")
        assert _forced_plan(X, 2, 2, vec=1)[:3] == (SHARED, False, 1)
        assert _forced_plan(X, 2, 2, path=SHARED).path == SHARED
        assert _forced_plan(X, 2, 2, path=GLOBAL).path == GLOBAL
        with pytest.raises(ValueError, match="SWAR"):
            _forced_plan(_geometry(64, 8, torch.int32, "row-major"), 2, 2, path=SWAR)
        with pytest.raises(ValueError, match="SWAR"):
            _forced_plan(_geometry(10_000, 50_000, torch.int8, "feature-major"), 2, 2, path=SWAR)

    def test_grid_follows_the_card(self):
        X = _geometry(1_000_000, 1000, torch.int8, "row-major")
        small, large = contingency_plan(X, 2, 2, sms=66), contingency_plan(X, 2, 2, sms=132)
        assert small.grid < large.grid and large.grid <= 132 * 3


class TestMIPlan:
    @pytest.mark.parametrize("tables,v,c", [
        (1000, 2, 2), (50000, 2, 2), (1000, 16, 2), (1000, 16, 16), (2000, 2, 2),
        (300, 5, 7), (8, 300, 40), (3, 13000, 2), (40, 1, 1), (5, 0, 2), (33, 3, 11),
        (7, 20000, 20000),
    ])
    def test_every_table_has_lanes_and_marginals_fit(self, tables, v, c):
        plan = mi_plan(tables, v, c, sms=132)
        assert plan.threads % 32 == 0 and plan.threads <= 256
        if v * c <= 32:  # a group of lanes a table, a power of two >= V*C
            g = plan.group
            assert g & (g - 1) == 0 and v * c <= g <= 32 and 32 % g == 0
            assert plan.grid * plan.threads >= tables * g
            assert (plan.smem_bytes, plan.scratch) == (0, 0)
        else:  # a warp a table; V + C floats of marginals a warp
            warps = plan.threads // 32
            assert plan.group == 0
            if plan.scratch == 0:
                assert plan.grid * warps >= tables
                assert plan.smem_bytes == warps * 4 * (v + c) <= 48 * 1024
            else:  # past shared memory: global scratch, a grid walking the tables
                assert 4 * (v + c) > 48 * 1024 and plan.smem_bytes == 0
                assert plan.scratch == plan.grid * warps * (v + c) and plan.grid <= 132

    def test_main_path_shapes(self):
        assert mi_plan(1000, 2, 2).group == 4  # 8 tables a warp, one 128-byte load
        assert mi_plan(1000, 16, 2).group == 32
        assert mi_plan(1000, 16, 16)[:4] == (0, 256, 125, 8 * 4 * 32)



class TestLastPublicOps:
    """``ops.mi_tables`` (the counts, then the MI) and
    ``contingency.counts_with_column`` against the JAX package's, on the
    same seeded numpy inputs."""

    @pytest.mark.parametrize("m,f,v,c,seed", [(500, 7, 3, 2, 0), (1000, 65, 5, 4, 1),
                                              (64, 1, 2, 2, 2)])
    def test_mi_tables_equal_jax(self, m, f, v, c, seed):
        from repro.kernels import ops as jops

        X, y = _counts_data(m, f, v, c, np.int32, seed)
        got = ops.mi_tables(torch.from_numpy(X), torch.from_numpy(y), v, c)
        want = jops.mi_tables(jnp.asarray(X), jnp.asarray(y), v, c)
        assert got.shape == (f,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        # the counts and the MI of the dispatcher, in one call
        counts = ops.contingency_tables(torch.from_numpy(X), torch.from_numpy(y), v, c)
        assert torch.equal(got, ops.mi_scores(counts))

    @pytest.mark.parametrize("m,f,v,block,seed", [(300, 10, 4, 64, 3), (257, 130, 3, 32, 4),
                                                  (50, 3, 6, 1, 5)])
    def test_counts_with_column_equal_jax(self, m, f, v, block, seed):
        from repro_torch.core import contingency as tcont

        rng = np.random.default_rng(seed)
        X = rng.integers(0, v, (m, f)).astype(np.int32)
        xj = X[:, rng.integers(0, f)].copy()
        got = tcont.counts_with_column(torch.from_numpy(X), torch.from_numpy(xj), v,
                                       block=block)
        want = jcont.counts_with_column(jnp.asarray(X), jnp.asarray(xj), v, block=block)
        assert got.shape == (f, v, v) and got.dtype == torch.int32
        assert np.array_equal(_as_int(got), _as_int(want))
        assert int(got.sum()) == m * f
