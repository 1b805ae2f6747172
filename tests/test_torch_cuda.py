"""Kernel-vs-plain checks on the card for ``repro_torch`` (no JAX here).

Every test is ``cuda``-marked and skips, from inside the ``cuda`` fixture,
where torch sees no CUDA device.  On a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Contingency counts and bin codes (NaN, +-inf and -0.0 included) must equal
the plain versions bitwise; MI agrees within ``rtol=1e-5, atol=1e-6`` (sums
in another order), equal tables give bit-equal MI and a strided view is
read in place;
row correlations within ``rtol=2e-4, atol=2e-5`` (float32 sums over M in
another order, the JAX kernel test's own tolerance); flash attention within
``rtol=2e-5, atol=2e-5`` in float32 and ``rtol=3e-2, atol=3e-2`` in bfloat16
(the JAX kernel tests' tolerances) and, since at S in the thousands the
outputs shrink inside that atol, each output row within a relative error of
``1e-2``; a two-layer smoke model's prefill through it within
``rtol=1e-4, atol=1e-4`` of the plain attention.
"""

import numpy as np
import pytest
import torch

from repro_torch import (
    ArraySource,
    CorralSource,
    MIScore,
    MRMRSelector,
    PearsonMIScore,
    QuantileBinner,
)
from repro_torch.core.contingency import OOR
from repro_torch.data.synthetic import continuous_dataset_np
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.binning import _scalar_plan, bin_codes_cuda, bin_codes_plan
from repro_torch.kernels.contingency import (
    GLOBAL,
    SHARED,
    _forced_plan,
    conditional_tables_cuda,
    contingency_tables_cuda,
)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.mi_score import mi_scores_cuda
from repro_torch.kernels.pearson import (
    REREAD,
    STAGED,
    STREAM,
    pearson_corr_cuda,
    pearson_plan,
)
from repro_torch.configs import smoke_config
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(m, f, v, c, dtype, seed=0, dirty=False):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, v, (m, f))
    y = rng.integers(0, c, m)
    if dirty:  # negatives and sentinels count nothing
        X[rng.random((m, f)) < 0.05] = -1
        y[rng.random(m) < 0.05] = OOR
        if dtype == torch.int32 or dtype == torch.int64:
            X[rng.random((m, f)) < 0.05] = OOR
    X = torch.as_tensor(X).to(dtype)
    return X, torch.as_tensor(y).to(torch.int32)


def test_build_all(cuda):
    libs = _build.build_all()
    assert set(libs) == {"contingency", "mi_score", "bin_codes", "pearson",
                         "flash_attention"}
    assert all(p.exists() for p in libs.values())


@pytest.mark.parametrize(
    "dtype", [torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64]
)
@pytest.mark.parametrize("m,f,v,c", [(4096, 100, 2, 2), (1037, 33, 3, 4)])
def test_contingency_bitwise(cuda, dtype, m, f, v, c):
    X, y = _data(m, f, v, c, dtype, dirty=dtype != torch.uint8)
    want = ref.contingency_tables(X, y, v, c)
    got = contingency_tables_cuda(X.to(cuda), y.to(cuda), v, c)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("layout", ["feature_major_view", "sliced", "column"])
def test_contingency_strided_layouts(cuda, layout):
    X, y = _data(3000, 257, 2, 2, torch.int8, seed=1)
    Xd = X.to(cuda)
    if layout == "feature_major_view":  # what the alternative engine hands over
        Xd = Xd.T.contiguous().T
    elif layout == "sliced":
        Xd = Xd[:, 3:200:2]
        X = X[:, 3:200:2]
    else:
        Xd = Xd[:, 5:6]
        X = X[:, 5:6]
    got = contingency_tables_cuda(Xd, y.to(cuda), 2, 2)
    assert torch.equal(got.cpu(), ref.contingency_tables(X, y, 2, 2))


def test_contingency_large_table_global_atomics(cuda):
    # 32 x 64 cells per feature is too large for private shared-memory tables.
    X, y = _data(5000, 20, 32, 64, torch.int16, seed=2, dirty=True)
    got = contingency_tables_cuda(X.to(cuda), y.to(cuda), 32, 64)
    assert torch.equal(got.cpu(), ref.contingency_tables(X, y, 32, 64))


_CELLS = {4: (2, 2), 8: (2, 4), 32: (16, 2), 256: (16, 16), 512: (16, 32)}
_FORCED = ({}, {"vec": 1}, {"path": SHARED}, {"path": GLOBAL})


def _check_plans(X, y, v, c, want=None, forced=_FORCED):
    """Every forced plan of X against the plain version; -> paths reached."""
    want = ref.contingency_tables(X.cpu(), y.cpu(), v, c) if want is None else want
    seen = set()
    for force in forced:
        plan = _forced_plan(X, v, c, torch.cuda.get_device_properties(X.device)
                            .multi_processor_count, **force)
        got = contingency_tables_cuda(X, y, v, c, plan=plan)
        assert torch.equal(got.cpu(), want), (force, plan)
        seen.add((plan.path, plan.vec > 1))
    return seen


@pytest.mark.parametrize(
    "dtype", [torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64]
)
@pytest.mark.parametrize("layout", ["row-major", "feature-major"])
@pytest.mark.parametrize("cells", sorted(_CELLS))
def test_contingency_every_plan_path(cuda, dtype, layout, cells):
    # 2080 rows x 1000 features: ragged against every row range; 1000-byte
    # int8 rows are 8-byte aligned only.
    v, c = _CELLS[cells]
    X, y = _data(2080 + 19, 1000, v + 1, c + 1, dtype, seed=cells, dirty=dtype != torch.uint8)
    Xd = X.to(cuda)
    if layout == "feature-major":
        Xd = Xd.T.contiguous().T
    seen = _check_plans(Xd, y.to(cuda), v, c, ref.contingency_tables(X, y, v, c))
    assert (GLOBAL, False) in seen and any(p == SHARED for p, _ in seen)


@pytest.mark.parametrize("view", ["rows 8 bytes in", "base 3 bytes in", "strided features",
                                  "one column", "feature-major 1 row in", "1024-byte rows"])
def test_contingency_unaligned_views(cuda, view):
    X, y = _data(4099, 1024, 3, 3, torch.int8, seed=9, dirty=True)
    Xd, yd = X.to(cuda), y.to(cuda)
    Xv, yv = {
        "rows 8 bytes in": (Xd[1:, 8:], yd[1:]),
        "base 3 bytes in": (Xd[:, 3:], yd),
        "strided features": (Xd[:, 3:200:2], yd),
        "one column": (Xd[:, 5:6], yd),
        "feature-major 1 row in": (Xd.T.contiguous()[:, 1:].T, yd[1:]),
        "1024-byte rows": (Xd, yd),
    }[view]
    _check_plans(Xv, yv, 2, 2, ref.contingency_tables(Xv.cpu(), yv.cpu(), 2, 2))


@pytest.mark.parametrize("layout", ["row-major", "feature-major"])
def test_contingency_counter_overflow(cuda, layout):
    # 300,000 rows of one (value, class) in every feature: a byte or 16-bit
    # counter that is not flushed in time wraps and shows as a wrong count.
    X = torch.zeros((300_000, 40), dtype=torch.int8, device=cuda)
    X[:, 7] = 1
    y = torch.zeros(300_000, dtype=torch.int32, device=cuda)
    if layout == "feature-major":
        X = X.T.contiguous().T
    want = torch.zeros((40, 2, 2), dtype=torch.int32)
    want[:, 0, 0] = 300_000
    want[7] = 0
    want[7, 1, 0] = 300_000
    _check_plans(X, y, 2, 2, want, forced=({}, {"vec": 1}, {"path": SHARED}))


def test_int64_targets_past_int32_count_nothing(cuda):
    X, y = _data(2000, 9, 2, 2, torch.int8, seed=6)
    y64 = y.to(torch.int64)
    y64[::3] = 2**32 + 1  # would wrap to 1 if narrowed
    got = contingency_tables_cuda(X.to(cuda), y64.to(cuda), 2, 2)
    assert torch.equal(got.cpu(), ref.contingency_tables(X, y64, 2, 2))


def test_conditional_bitwise(cuda):
    X, y = _data(9000, 70, 2, 2, torch.int8, seed=3)
    xj = X[:, 4].clone()
    got = conditional_tables_cuda(X.to(cuda), xj.to(cuda), y.to(cuda), 2, 2)
    assert torch.equal(got.cpu(), ref.conditional_tables(X, xj, y, 2, 2))


# The main path's tables (tall and wide passes, the binned relevance and
# redundancy passes), odd shapes, V=300 (a warp a table, marginals in shared
# memory) and V=13,000 (marginals in global scratch).
@pytest.mark.parametrize("shape", [(1000, 2, 2), (1000, 2, 4), (50000, 2, 2), (300, 5, 7),
                                   (1000, 16, 2), (1000, 16, 16), (8, 300, 40),
                                   (3, 13000, 2), (40, 1, 1), (33, 3, 11)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_mi_scores(cuda, shape, dtype):
    rng = np.random.default_rng(4)
    counts = torch.as_tensor(rng.integers(0, 5000, shape)).to(dtype)
    counts[::7] = 0  # all-zero rows give 0
    got = mi_scores_cuda(counts.to(cuda)).cpu()
    np.testing.assert_allclose(got, ref.mi_scores(counts), rtol=1e-5, atol=1e-6)
    assert torch.all(got[::7] == 0)


@pytest.mark.parametrize("shape", [(1000, 2, 2, 2), (300, 16, 16, 2), (50, 3, 5, 4)])
def test_mi_scores_read_the_conditional_view_in_place(cuda, shape):
    rng = np.random.default_rng(5)
    stack = torch.as_tensor(rng.integers(0, 5000, shape)).to(torch.int32).to(cuda)
    view = stack.movedim(-1, -3)  # (F, C, V, W): what cmi_from_counts hands over
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    got = mi_scores_cuda(view)
    torch.cuda.synchronize()
    # One allocation, the output: no copy of the (F, V, W, C) stack.
    assert torch.cuda.max_memory_allocated(cuda) - before <= -(-got.numel() * 4 // 512) * 512
    assert got.shape == view.shape[:2]
    assert torch.equal(got, mi_scores_cuda(view.contiguous()))
    np.testing.assert_allclose(got.cpu(), ref.mi_scores(view.cpu()), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(999, 2, 2), (200, 16, 16), (60, 5, 7)])
def test_mi_scores_equal_tables_bit_equal(cuda, shape):
    rng = np.random.default_rng(6)
    counts = torch.as_tensor(rng.integers(0, 5000, shape)).to(torch.int32)
    counts[3::10] = counts[1]  # one table at many places in the grid
    got = mi_scores_cuda(counts.to(cuda)).cpu()
    assert torch.all(got[3::10] == got[1])
    assert torch.equal(mi_scores_cuda(counts[1:2].to(cuda)).cpu(), got[1:2])
    zero = mi_scores_cuda(torch.zeros(shape, dtype=torch.int32, device=cuda))
    assert torch.all(zero == 0)


def test_dispatch_counts_launches(cuda):
    X, y = _data(500, 10, 2, 2, torch.int8)
    before = contingency_tables_cuda.launches, mi_scores_cuda.launches
    ops.mi_scores(ops.contingency_tables(X.to(cuda), y.to(cuda), 2, 2))
    assert contingency_tables_cuda.launches == before[0] + 1
    assert mi_scores_cuda.launches == before[1] + 1
    with pytest.raises(ValueError):
        ops.contingency_tables(X, y, 2, 2, use_kernel=True)


@pytest.mark.parametrize("encoding", ["conventional", "alternative", "streaming"])
@pytest.mark.parametrize("criterion", ["mid", "jmi"])
def test_fit_kernel_matches_plain(cuda, encoding, criterion):
    X, y = CorralSource(20000, 64, seed=5).materialize()
    kw = dict(encoding=encoding, criterion=criterion, block_obs=4096)
    on_card = MRMRSelector(6, **kw).fit(X, y)
    plain = MRMRSelector(6, score=MIScore(2, 2, use_kernel=False), **kw).fit(X, y)
    on_cpu = MRMRSelector(6, device="cpu", **kw).fit(X, y)
    np.testing.assert_array_equal(on_card.selected_, plain.selected_)
    np.testing.assert_array_equal(on_card.selected_, on_cpu.selected_)
    np.testing.assert_allclose(on_card.gains_, on_cpu.gains_, rtol=1e-5, atol=1e-6)


def _binned_block(b, n, e, seed=0):
    """Float32 block and sorted edges with values planted on edges."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b, n)).astype(np.float32)
    edges = np.sort(rng.normal(size=(n, e)).astype(np.float32), axis=1)
    X[::7] = edges[np.arange(n), rng.integers(0, e, n)]
    X[1, :], X[2, :], X[3, :], X[4, :] = -0.0, 1e30, np.inf, -np.inf
    return X, edges


@pytest.mark.parametrize("b,n,e", [(4096, 100, 15), (1037, 33, 63), (513, 40, 1),
                                   (300, 70, 70)])
def test_bin_codes_bitwise(cuda, b, n, e):
    X, edges = _binned_block(b, n, e, seed=e)
    got = bin_codes_cuda(torch.from_numpy(X).to(cuda), torch.from_numpy(edges).to(cuda))
    assert got.dtype == torch.int32
    want = ref.bin_codes(torch.from_numpy(X), torch.from_numpy(edges))
    assert torch.equal(got.cpu(), want)
    binner = QuantileBinner(e + 1)
    binner.edges_ = edges
    np.testing.assert_array_equal(got.cpu().numpy(), binner.transform(X))


def test_bin_codes_strided_rows(cuda):
    X, edges = _binned_block(2000, 50, 15, seed=1)
    Xd = torch.from_numpy(X).to(cuda)[3:1500:2]  # a row stride, no copy
    got = bin_codes_cuda(Xd, torch.from_numpy(edges).to(cuda))
    assert torch.equal(got.cpu(), ref.bin_codes(torch.from_numpy(X[3:1500:2]),
                                                torch.from_numpy(edges)))


@pytest.mark.parametrize("e,fpl", [(15, 4), (63, 1), (70, 0)])
def test_bin_codes_nan_takes_the_top_code(cuda, e, fpl):
    X, edges = _binned_block(2003, 1000, e, seed=e + 11)
    edges[:, e // 2] = 0.0  # -0.0 and 0.0 against a 0.0 edge
    edges.sort(axis=1)
    X[5::9, 3::7], X[6::9, 2::5], X[7::9, 4::6], X[8::9, 1::3] = np.nan, np.inf, -np.inf, -0.0
    X[9::9, 6::5] = 0.0
    Xd, ed = torch.from_numpy(X).to(cuda), torch.from_numpy(edges).to(cuda)
    plan = bin_codes_plan(Xd, e, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert plan.fpl == fpl  # the 4- and 1-feature register paths, the cache kernel
    got = bin_codes_cuda(Xd, ed, plan=plan)
    assert torch.equal(got, ref.bin_codes(Xd, ed))
    assert torch.equal(got.cpu(), ref.bin_codes(torch.from_numpy(X), torch.from_numpy(edges)))
    assert torch.all(got[torch.isnan(Xd)] == e)


@pytest.mark.parametrize("e", [1, 15, 63, 70])
@pytest.mark.parametrize("view", ["rows", "strided rows", "base 4 bytes in"])
def test_bin_codes_every_plan_path(cuda, e, view):
    X, edges = _binned_block(3001, 1000, e, seed=e + 3)
    Xd, ed = torch.from_numpy(X).to(cuda), torch.from_numpy(edges).to(cuda)
    if view == "strided rows":
        Xd = Xd[3:2900:2]
    elif view == "base 4 bytes in":
        Xd, ed = Xd[:, 1:], ed[1:]
    want = ref.bin_codes(Xd.cpu(), ed.cpu())
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    seen = set()
    for plan in (bin_codes_plan(Xd, e, sms), _scalar_plan(Xd, e, sms)):
        assert torch.equal(bin_codes_cuda(Xd, ed, plan=plan).cpu(), want), plan
        seen.add(plan.fpl)
    assert seen == ({0} if e > 64 else {1} if view == "base 4 bytes in" else
                    {4, 1} if e <= 16 else {1})


def _corr_rows(f, t, m, seed):
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.normal(size=(f, m)) * 2 + 3, dtype=torch.float32)
    Y = torch.as_tensor(rng.normal(size=(t, m)), dtype=torch.float32)
    if f > 1:
        X[1] = 2.5  # constant row: correlation 0
    return X, Y


@pytest.mark.parametrize("f,t,m,plan", [
    (500, 1, 10000, (STREAM, 4, 1)),   # the wide fit's shape, Y in shared memory
    (300, 4, 2000, (STREAM, 4, 4)),
    (37, 9, 1031, (STAGED, 0, 0)),     # M not a multiple of 4 floats
    (20, 2, 20000, (STREAM, 2, 0)),    # Y too large for shared memory beside the ring
    (300, 1, 10001, (STAGED, 0, 0)),   # rows not 16-byte aligned
    (30, 1, 30000, (REREAD, 0, 0)),    # M above the ring and the scalar stage
    (200, 9, 10000, (STREAM, 2, 3)),   # T = 9: three Y rows shared, six from L2
    (1, 1, 10000, (STREAM, 4, 1)),
    (1, 3, 777, (STAGED, 0, 0)),
])
def test_pearson_corr(cuda, f, t, m, plan):
    X, Y = _corr_rows(f, t, m, seed=f)
    Xd = X.to(cuda)
    assert tuple(pearson_plan(Xd, t)) == plan
    got = pearson_corr_cuda(Xd, Y.to(cuda)).cpu()
    np.testing.assert_allclose(got, ref.pearson_corr(X, Y), rtol=2e-4, atol=2e-5)
    assert f == 1 or torch.all(got[1] == 0)


def test_pearson_corr_transposed_view(cuda):
    X, Y = _corr_rows(200, 1, 3000, seed=3)
    Xv = X.T.contiguous().to(cuda).T  # what the alternative engine holds
    got = pearson_corr_cuda(Xv, Y[0].to(cuda)[None]).cpu()
    np.testing.assert_allclose(got, ref.pearson_corr(X, Y), rtol=2e-4, atol=2e-5)


def test_new_kernels_count_launches(cuda):
    X, edges = _binned_block(100, 8, 15)
    before = bin_codes_cuda.launches, pearson_corr_cuda.launches
    ops.bin_codes(torch.from_numpy(X).to(cuda), torch.from_numpy(edges).to(cuda))
    ops.pearson_corr(torch.from_numpy(X.T.copy()).to(cuda),
                     torch.from_numpy(X[:, :1].T.copy()).to(cuda))
    assert (bin_codes_cuda.launches, pearson_corr_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    ops.bin_codes(torch.from_numpy(X).to(cuda), torch.from_numpy(edges).to(cuda),
                  use_kernel=False)
    assert bin_codes_cuda.launches == before[0] + 1


@pytest.mark.parametrize("streaming", [False, True])
def test_binned_fit_kernel_matches_plain(cuda, streaming):
    X, y = continuous_dataset_np(20000, 48, seed=6)
    data = (ArraySource(X, y),) if streaming else (X, y)
    before = bin_codes_cuda.launches
    on_card = MRMRSelector(5, bins=16, block_obs=4096).fit(*data)
    assert bin_codes_cuda.launches - before == (5 * 5 if streaming else 1)
    plain = MRMRSelector(5, bins=16, block_obs=4096,
                         score=MIScore(16, 2, use_kernel=False)).fit(*data)
    on_cpu = MRMRSelector(5, bins=16, block_obs=4096, device="cpu").fit(*data)
    np.testing.assert_array_equal(on_card.selected_, plain.selected_)
    np.testing.assert_array_equal(on_card.selected_, on_cpu.selected_)
    np.testing.assert_allclose(on_card.gains_, on_cpu.gains_, rtol=1e-5, atol=1e-6)


def test_pearson_fit_kernel_matches_plain(cuda):
    X, y = continuous_dataset_np(2000, 5000, seed=7)
    before = pearson_corr_cuda.launches
    on_card = MRMRSelector(6).fit(X, y)
    assert on_card.plan_.encoding == "alternative"
    assert pearson_corr_cuda.launches - before == 6
    plain = MRMRSelector(6, score=PearsonMIScore(use_kernel=False)).fit(X, y)
    on_cpu = MRMRSelector(6, device="cpu").fit(X, y)
    np.testing.assert_array_equal(on_card.selected_, plain.selected_)
    np.testing.assert_array_equal(on_card.selected_, on_cpu.selected_)
    np.testing.assert_allclose(on_card.gains_, plain.gains_, rtol=2e-4, atol=2e-5)
    streamed = MRMRSelector(6, block_obs=512).fit(ArraySource(X, y))
    np.testing.assert_array_equal(streamed.selected_, on_card.selected_)


def _flash_close(got, want):
    """Elementwise within the JAX kernel tests' tolerance for the dtype, and
    every output row within a relative error of 1e-2 (L2 over D)."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    tol = dict(rtol=3e-2, atol=3e-2) if bf16 else dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, want, **tol)
    row = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    assert row <= 1e-2, f"max row error {row}"


def _attn(b, s, t, h, kv, d, dtype, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, s, h, d), generator=gen, device=device).to(dtype)
    k = torch.randn((b, t, kv, d), generator=gen, device=device).to(dtype)
    v = torch.randn((b, t, kv, d), generator=gen, device=device).to(dtype)
    return q, k, v


# Shapes run in both dtypes: bf16 goes through the wgmma + TMA body, float32
# through the CUDA-core body.
_FLASH_BOTH = [
    (2, 256, 256, 8, 8, 64, True),     # MHA
    (2, 1, 1, 8, 4, 128, True),        # S = 1
    (1, 1, 300, 8, 4, 128, True),      # one query, long context
    (2, 1000, 1000, 8, 2, 64, True),   # ragged S
    (2, 64, 256, 8, 2, 32, True),      # s < t, causal
    (2, 200, 333, 8, 4, 128, False),   # non-causal
    (1, 96, 40, 4, 2, 32, True),       # s > t: rows with no key
    (2, 100, 100, 8, 2, 128, True),    # T within one KV tile
    (2, 20, 90, 4, 4, 64, False),      # T within one KV tile, non-causal
    (1, 129, 129, 8, 2, 128, True),    # one query row past a 128-row tile
]


@pytest.mark.parametrize(
    "b,s,t,h,kv,d,causal,dtype",
    [
        (4, 2048, 2048, 32, 4, 128, True, torch.bfloat16),  # the serve prefill
        (4, 1000, 1000, 32, 4, 128, True, torch.bfloat16),  # the ragged wave
        (1, 8192, 8192, 32, 4, 128, True, torch.bfloat16),  # a long prompt
    ]
    + [case + (dtype,) for case in _FLASH_BOTH for dtype in (torch.float32, torch.bfloat16)],
)
def test_flash_attention(cuda, b, s, t, h, kv, d, causal, dtype):
    q, k, v = _attn(b, s, t, h, kv, d, dtype, seed=s + t, device=cuda)
    got = flash_attention_cuda(q, k, v, causal=causal)
    want = ref.flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == (b, s, h, d)
    _flash_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_projection_views(cuda, dtype):
    b, s, h, kv, d = 2, 300, 8, 2, 64
    x = torch.randn((b, s, (h + 2 * kv) * d), device=cuda).to(dtype)
    q = x[..., : h * d].unflatten(-1, (h, d))
    k = x[..., h * d:(h + kv) * d].unflatten(-1, (kv, d))
    v = x[..., (h + kv) * d:].unflatten(-1, (kv, d))
    assert not q.is_contiguous()
    got = flash_attention_cuda(q, k, v, causal=True)
    want = flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    assert torch.equal(got, want)
    odd = torch.randn((b * s * h * d + 3,), device=cuda).to(dtype)[3:].view(b, s, h, d)
    _flash_close(  # a misaligned start is copied, not misread
        flash_attention_cuda(odd, k, v, causal=True), ref.flash_attention(odd, k, v, causal=True))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(*_attn(1, 8, 8, 2, 2, 48, torch.float32, 0, cuda), causal=True)


def test_flash_attention_counts_launches(cuda):
    q, k, v = _attn(1, 64, 64, 4, 2, 32, torch.float32, 0, cuda)
    before = flash_attention_cuda.launches
    ops.flash_attention(q, k, v, causal=True)
    ops.flash_attention(q, k, v, causal=True, use_kernel=False)
    assert flash_attention_cuda.launches == before + 1


def test_smoke_model_prefill_through_the_kernel(cuda):
    cfg = smoke_config("yi-6b")  # two layers, GQA
    model = build_model(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    tokens = torch.randint(0, cfg.vocab_size, (3, 77), device=cuda)
    before = flash_attention_cuda.launches
    got, caches = model.prefill(tokens)
    assert flash_attention_cuda.launches - before == cfg.num_layers
    want, want_caches = model.prefill(tokens, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(caches[0]["k"], want_caches[0]["k"])  # before any attention
    for c, w in zip(caches, want_caches):
        torch.testing.assert_close(c["v"], w["v"], rtol=1e-4, atol=1e-4)
    reqs = [Request(tokens[i, : 20 + 10 * i].tolist(), 6) for i in range(3)]
    assert ServeEngine(model).serve(reqs) == ServeEngine(model, use_kernel=False).serve(reqs)


# -- the out-of-core path: spilled int8 bin codes, and kernels first launched
#    from two threads at once (the selection service's workers) ------------

@pytest.fixture(scope="module")
def spilled_codes(tmp_path_factory):
    """One 65,536 x 1000 block of bins=16 codes as the spill cache replays
    it: a float32 base memmapped from .npy, binned, spilled at int8 on the
    first pass and read back memmapped on the second."""
    from repro_torch import BinnedSource, NpySource
    from repro_torch.data.block_cache import BlockCacheSource

    d = tmp_path_factory.mktemp("spill")
    X, y = continuous_dataset_np(65536, 1000, seed=9)
    np.save(d / "X.npy", X)
    np.save(d / "y.npy", y)
    base = NpySource(str(d / "X.npy"), str(d / "y.npy"))
    cache = BlockCacheSource(BinnedSource(base, 16), str(d / "cache"))
    (staged,) = list(cache.iter_blocks(65536))
    (replayed,) = list(cache.iter_blocks(65536))
    assert cache.counters["parse_passes"] == cache.counters["replay_passes"] == 1
    return staged, replayed


@pytest.mark.parametrize("c", [2, 16])
def test_spilled_int8_codes_count_bitwise(cuda, spilled_codes, c):
    from repro_torch.dist.streaming import BlockPlacer

    staged, (Xr, yr) = spilled_codes
    assert isinstance(Xr, np.memmap) and Xr.dtype == np.int8 and Xr.shape == (65536, 1000)
    np.testing.assert_array_equal(Xr, staged[0])
    tgt = yr if c == 2 else np.ascontiguousarray(Xr[:, 7])  # relevance / redundancy
    # Placed as the streaming engine places it: a read-only memmap copied
    # once into pinned memory, then to the card.
    [[(Xd, td, valid)]] = BlockPlacer(65536, cuda, num_features=1000)(Xr, tgt)
    assert Xd.dtype == torch.int8 and bool(valid.all())
    before = contingency_tables_cuda.launches
    got = contingency_tables_cuda(Xd, td.to(torch.int32), 16, c)
    assert contingency_tables_cuda.launches == before + 1
    want = ref.contingency_tables(torch.from_numpy(np.array(Xr)),
                                  torch.from_numpy(np.array(tgt)).to(torch.int32), 16, c)
    assert torch.equal(got.cpu(), want)


def test_first_launches_from_two_threads_build_once(cuda, tmp_path, monkeypatch):
    import threading

    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")  # nothing built yet
    monkeypatch.setattr(_build, "_LOADED", {})
    started = []
    real_start = _build._start

    def counting_start(name, lib):
        started.append(name)
        return real_start(name, lib)

    monkeypatch.setattr(_build, "_start", counting_start)
    X, y = _data(20000, 300, 2, 2, torch.int8)
    Xd, yd = X.to(cuda), y.to(cuda)
    want = ref.contingency_tables(X, y, 2, 2)
    reps, errors = 50, []
    before = contingency_tables_cuda.launches, mi_scores_cuda.launches
    barrier = threading.Barrier(2)

    def work():
        try:
            barrier.wait()
            for _ in range(reps):
                counts = contingency_tables_cuda(Xd, yd, 2, 2)
                mi = mi_scores_cuda(counts)
            torch.cuda.synchronize()
            assert torch.equal(counts.cpu(), want)
            np.testing.assert_allclose(mi.cpu(), ref.mi_scores(want), rtol=1e-5, atol=1e-6)
        except BaseException as exc:  # re-raised below, in the test's thread
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert sorted(started) == ["contingency", "mi_score"]  # each source built once
    assert (contingency_tables_cuda.launches - before[0],
            mi_scores_cuda.launches - before[1]) == (2 * reps, 2 * reps)


@pytest.mark.parametrize("score", ["mi", "pearson"])
def test_custom_score_batches_into_one_launch_a_chunk(cuda, monkeypatch, score):
    """``mrmr_custom_score`` vmapped over candidate chunks on the card: each
    chunk's relevance and redundancy are one launch of each kernel they
    reach, and the scores equal the plain version's on the same tensors.
    The class is float32, as the engines hand it to a custom score."""
    from repro_torch.core import scores
    from repro_torch.core.scores import mrmr_custom_score

    g = torch.Generator().manual_seed(8)
    M, F, L, chunk = 3000, 70, 4, 16
    X = torch.randint(0, 2, (F, M), generator=g, dtype=torch.int8)
    y = torch.randint(0, 2, (M,), generator=g).to(torch.float32)
    if score == "pearson":
        X = X.to(torch.float32) + 0.1 * torch.randn(F, M, generator=g)
    sel = torch.zeros((L, M), dtype=torch.float32)
    sel[:2] = X[[5, 9]].to(torch.float32)
    Xd, yd, seld = X.to(cuda), y.to(cuda), sel.to(cuda)
    make = {"mi": lambda k: MIScore(2, 2, use_kernel=k),
            "pearson": lambda k: PearsonMIScore(use_kernel=k)}[score]
    monkeypatch.setattr(scores, "_CUSTOM_CHUNK_ELEMS", chunk * M * (L + 1))
    wrappers = ([contingency_tables_cuda, mi_scores_cuda] if score == "mi"
                else [pearson_corr_cuda])
    before = [w.launches for w in wrappers]
    got = mrmr_custom_score(make(True)).full_score(Xd, yd, seld, 2)
    chunks = -(-F // chunk)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [2 * chunks] * len(wrappers)
    want = mrmr_custom_score(make(False)).full_score(Xd, yd, seld, 2)
    tol = dict(rtol=1e-5, atol=1e-6) if score == "mi" else dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.cpu(), want.cpu(), **tol)


def test_two_gloo_workers_share_the_card_bitwise(cuda, tmp_path):
    """``select_multihost --device cuda`` with two workers on one card: each
    reads half the rows (two blocks a pass), launches the contingency and MI
    kernels, and the merged fit is bitwise the single-process card fit."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    from repro_torch.data.synthetic import corral_dataset_np

    X, y = corral_dataset_np(131_072, 64, seed=0)
    np.save(tmp_path / "X.npy", X)
    np.save(tmp_path / "y.npy", y)
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.select_multihost",
         "--num-processes", "2", "--input", str(tmp_path / "X.npy"),
         "--target", str(tmp_path / "y.npy"), "--select", "4",
         "--block-obs", "32768", "--timeout", "300"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": src},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    one = MRMRSelector(4, score=MIScore(2, 2), block_obs=32768).fit(ArraySource(X, y))
    assert out["selected"] == one.selected_.tolist()
    assert out["gains"] == [float(g) for g in one.gains_]
    assert out["hosts"]["grid"] == [2, 1]
    for w in out["workers"].values():
        assert w["device"] == "cuda:0"
        assert w["device_name"] == torch.cuda.get_device_name(0)
        # 2 blocks x 4 passes counted, one MI launch a pass.
        assert w["launches"] == dict(contingency_tables=8, mi_scores=4)


# ---------------------------------------------------------------------------
# the in-process device mesh: four positions on one card
# ---------------------------------------------------------------------------

def _card_mesh(cuda, shape, axes):
    from repro_torch.dist.meshes import make_mesh

    return make_mesh(shape, axes, devices=[cuda] * 4)


def _launches():
    return contingency_tables_cuda.launches, mi_scores_cuda.launches


@pytest.mark.parametrize("engine,shape,axes,crit,want", [
    # L=5 picks: one count a shard a pass; MI once a feature group a pass
    # (a conditional pass twice: the marginal and the class-major view).
    ("conventional", (4,), ("data",), "mid", (4 * 5, 5)),
    ("conventional", (3,), ("data",), "cmim", (3 * 5, 1 + 2 * 4)),  # padded rows
    ("alternative", (4,), ("model",), "mid", (4 * 5, 4 * 5)),
    ("alternative", (3,), ("model",), "jmi", (3 * 5, 3 + 3 * 2 * 4)),  # padded rows
    ("grid", (2, 2), ("data", "model"), "jmi", (4 * 5, 2 + 2 * 2 * 4)),
    ("grid", (2, 2), ("data", "model"), "miq", (4 * 5, 2 * 5)),
])
def test_mesh_engines_on_one_card_bitwise(cuda, engine, shape, axes, crit, want):
    """Each engine on a mesh of positions on ``cuda:0``: the one-device card
    fit's picks, bitwise its gains, the launches reckoned from the engine."""
    X, y = CorralSource(20_000, 301, seed=1).materialize()
    Xd, yd = torch.from_numpy(X).to(cuda), torch.from_numpy(y).to(cuda)
    one = MRMRSelector(5, score=MIScore(2, 2), criterion=crit,
                       encoding="alternative" if engine == "alternative" else "conventional",
                       ).fit(Xd, yd)
    mesh = _card_mesh(cuda, shape, axes)
    before = _launches()
    got = MRMRSelector(5, score=MIScore(2, 2), criterion=crit, encoding=engine,
                       mesh=mesh).fit(Xd, yd)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_launches(), before)) == want
    assert got.mesh_ is mesh and got.result_.engine == engine
    np.testing.assert_array_equal(got.selected_, one.selected_)
    assert np.array_equal(got.gains_, one.gains_)  # bitwise
    assert np.array_equal(got.scores_, one.scores_)


def test_mesh_pearson_on_one_card(cuda):
    X, y = continuous_dataset_np(4000, 3001, seed=2)
    Xd, yd = torch.from_numpy(X).to(cuda), torch.from_numpy(y).to(cuda)
    one = MRMRSelector(5).fit(Xd, yd)
    before = pearson_corr_cuda.launches
    got = MRMRSelector(5, mesh=_card_mesh(cuda, (4,), ("model",))).fit(Xd, yd)
    assert pearson_corr_cuda.launches - before == 4 * 5  # a shard: 1 relevance + 4 folds
    np.testing.assert_array_equal(got.selected_, one.selected_)
    np.testing.assert_allclose(got.gains_, one.gains_, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shape,axes,tiles,groups", [
    ((4,), ("data",), 4, 1), ((4,), ("model",), 4, 4), ((2, 2), ("data", "model"), 4, 2),
])
def test_mesh_streaming_on_one_card_bitwise(cuda, shape, axes, tiles, groups):
    """Streamed on the mesh (4 blocks a pass of 8,192 rows, L=4): one count a
    tile a block, MI once a feature group a pass; q=2 and bins= too."""
    X, y = CorralSource(30_000, 200, seed=2).materialize()
    mesh = _card_mesh(cuda, shape, axes)
    one = MRMRSelector(4, score=MIScore(2, 2), block_obs=8192).fit(ArraySource(X, y))
    before = _launches()
    got = MRMRSelector(4, score=MIScore(2, 2), block_obs=8192, mesh=mesh).fit(ArraySource(X, y))
    assert tuple(a - b for a, b in zip(_launches(), before)) == (4 * tiles * 4, groups * 4)
    np.testing.assert_array_equal(got.selected_, one.selected_)
    assert np.array_equal(got.gains_, one.gains_)
    assert got.result_.io["blocks_read"] == one.result_.io["blocks_read"] == 16
    q2 = MRMRSelector(4, score=MIScore(2, 2), block_obs=8192, batch_candidates=2,
                      mesh=mesh).fit(ArraySource(X, y))
    np.testing.assert_array_equal(q2.selected_, one.selected_)
    assert np.array_equal(q2.gains_, one.gains_)
    Xc, yc = continuous_dataset_np(30_000, 200, seed=3)
    bone = MRMRSelector(4, bins=8, block_obs=8192).fit(ArraySource(Xc, yc))
    before = bin_codes_cuda.launches
    bgot = MRMRSelector(4, bins=8, block_obs=8192, mesh=mesh).fit(ArraySource(Xc, yc))
    assert bin_codes_cuda.launches - before == 4 * tiles * 4  # the fused encode, a tile
    np.testing.assert_array_equal(bgot.selected_, bone.selected_)
    assert np.array_equal(bgot.gains_, bone.gains_)


def test_a_mesh_mixing_cpu_and_cuda_raises(cuda):
    from repro_torch.dist.meshes import make_mesh

    with pytest.raises(ValueError, match="every position on CUDA or every one on the CPU"):
        make_mesh((2,), ("data",), devices=["cpu", cuda])
    mesh = _card_mesh(cuda, (4,), ("data",))
    with pytest.raises(ValueError, match="mesh positions are cuda devices"):
        MRMRSelector(3, mesh=mesh, device="cpu")


@pytest.mark.parametrize("engine", ["conventional", "alternative", "grid"])
def test_engines_refuse_card_data_on_a_cpu_mesh(cuda, engine):
    """Card tensors on a mesh of CPU positions: each in-memory engine raises
    before placing a shard, so no shard leaves the card."""
    from repro_torch import mrmr_alternative, mrmr_conventional, mrmr_grid
    from repro_torch.dist.meshes import make_mesh

    X, y = CorralSource(2000, 40, seed=1).materialize()
    Xd, yd = torch.from_numpy(X).to(cuda), torch.from_numpy(y).to(cuda)
    mesh = make_mesh((4,), ("data",), devices=["cpu"] * 4)
    call = dict(
        conventional=lambda: mrmr_conventional(Xd, yd, 3, MIScore(2, 2), mesh=mesh),
        alternative=lambda: mrmr_alternative(Xd.T, yd, 3, MIScore(2, 2), mesh=mesh,
                                             feat_axes=("data",)),
        grid=lambda: mrmr_grid(Xd, yd, 3, MIScore(2, 2), mesh=mesh, feat_axes=()),
    )[engine]
    before = _launches()
    with pytest.raises(ValueError, match="mesh positions are cpu devices but device='cuda:0'"):
        call()
    assert _launches() == before
