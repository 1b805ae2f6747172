"""Kernel-vs-plain checks on the card for ``repro_torch`` (no JAX here).

Every test is ``cuda``-marked and skips, from inside the ``cuda`` fixture,
where torch sees no CUDA device.  On a machine with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Contingency counts must equal the plain version bitwise; MI agrees within
``rtol=1e-5, atol=1e-6`` (only ``logf`` rounding differs).
"""

import numpy as np
import pytest
import torch

from repro_torch import CorralSource, MIScore, MRMRSelector
from repro_torch.core.contingency import OOR
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.contingency import (
    conditional_tables_cuda,
    contingency_tables_cuda,
)
from repro_torch.kernels.mi_score import mi_scores_cuda

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
    assert set(libs) == {"contingency", "mi_score"}
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


@pytest.mark.parametrize("shape", [(1000, 2, 2), (1000, 2, 4), (50000, 2, 2), (300, 5, 7)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_mi_scores(cuda, shape, dtype):
    rng = np.random.default_rng(4)
    counts = torch.as_tensor(rng.integers(0, 5000, shape)).to(dtype)
    counts[::7] = 0  # all-zero rows give 0
    got = mi_scores_cuda(counts.to(cuda)).cpu()
    np.testing.assert_allclose(got, ref.mi_scores(counts), rtol=1e-5, atol=1e-6)
    assert torch.all(got[::7] == 0)


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
