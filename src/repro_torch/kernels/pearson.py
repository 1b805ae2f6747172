"""Row correlations on the card: the CUDA port of the TPU kernel
``src/repro/kernels/pearson.py::pearson_corr_pallas``.

The kernel (``csrc/pearson.cu``) computes ``corr[f, t]``, the Pearson
correlation of row ``f`` of ``X (F, M)`` with row ``t`` of ``Y (T, M)``,
with the standardisation fused: each X row is read from device memory
once, and its two-pass statistics (mean, then mean squared deviation; the
standard deviation clamped at 1e-12) and the products against every
standardised Y row come from that one read.  Y's statistics come from a
small reduction kernel of the same source, which standardises Y into a
scratch buffer once per call.

:func:`pearson_plan` picks the kernel's path from X's geometry: rows that a
bulk copy can move (16-byte aligned, M a multiple of 4 floats, at most
``RING_MAX_M``) stream through persistent blocks and a ring of 2-4 row
buffers, with as many standardised Y rows in shared memory as fit beside
the ring and the rest read from L2; other rows take the scalar path, one
block per row, staged in shared memory up to ``STAGE_MAX`` floats and read
twice beyond.

X rows must be contiguous along M: a strided X (such as the ``X.T`` view
of a row-major matrix) is copied to row-major float32 first, which costs
one extra read and write of X per call.  The alternative engine avoids it
by making one feature-major float32 copy per fit
(:meth:`repro_torch.core.scores.PearsonMIScore.feature_rows`).

The plain version is :func:`repro_torch.kernels.ref.pearson_corr`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build


# Path codes of ``pearson_corr_launch`` (csrc/pearson.cu).
REREAD, STAGED, STREAM = 0, 1, 2
SMEM_MAX = 232448  # bytes of shared memory a block may use (227 KB)
RING_MAX_M = 24576  # floats per row on the streaming path: two row buffers
RING_STAGES_MAX = 4
STAGE_MAX = 48 * 1024 // 4 - 8 * 5  # floats per row the scalar path stages
_RING_SCRATCH = 4 * 16 * 6 + 8 * RING_STAGES_MAX  # reduction scratch, the ring's barriers


class PearsonPlan(NamedTuple):
    path: int
    stages: int = 0  # row buffers in the ring (STREAM)
    y_rows: int = 0  # standardised Y rows kept in shared memory (STREAM)


def pearson_plan(X: torch.Tensor, t: int) -> PearsonPlan:
    """The kernel path for float32 rows ``X`` (F, M), contiguous along M,
    against ``t`` Y rows.  A bulk copy needs a 16-byte-aligned source and a
    multiple of 16 bytes, so streaming needs every row start aligned; then
    two row buffers come first in the block's shared memory, the Y rows
    next (as many as fit; the rest are read from L2), and up to two more
    row buffers in what is left."""
    f, m = X.shape
    aligned = m % 4 == 0 and (f == 1 or X.stride(0) % 4 == 0) and X.data_ptr() % 16 == 0
    if not (aligned and m <= RING_MAX_M):
        return PearsonPlan(STAGED if m <= STAGE_MAX else REREAD)
    row = 4 * m
    room = SMEM_MAX - _RING_SCRATCH - 2 * row
    y_rows = min(t, room // row)
    room -= y_rows * row
    return PearsonPlan(STREAM, 2 + min(RING_STAGES_MAX - 2, room // row), y_rows)


def _rows_f32(A: torch.Tensor) -> torch.Tensor:
    A = A.to(torch.float32)
    if A.shape[1] > 1 and A.stride(1) != 1:
        A = A.contiguous()
    return A


def pearson_corr_cuda(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """(F, M), (T, M) real tensors on the card -> (F, T) float32 correlations."""
    if not (X.is_cuda or X.is_meta):
        raise ValueError("pearson_corr_cuda needs a CUDA tensor")
    if X.dim() != 2 or Y.dim() != 2 or X.shape[1] != Y.shape[1]:
        raise ValueError(
            f"need X (F, M) and Y (T, M); got {tuple(X.shape)} and {tuple(Y.shape)}"
        )
    if Y.device != X.device:
        raise ValueError(f"Y must lie on {X.device}; got {Y.device}")
    if X.dtype.is_complex or Y.dtype.is_complex:
        raise ValueError("complex rows have no Pearson correlation here")
    F, M = X.shape
    T = Y.shape[0]
    if M == 0:
        raise ValueError("rows of length 0 have no correlation")
    charge = pearson_charge(F, M, T)
    if X.is_meta:
        return _build.meta_result(pearson_corr_cuda, (F, T), torch.float32, *charge)
    out = torch.empty((F, T), dtype=torch.float32, device=X.device)
    if F == 0 or T == 0:
        return out
    X, Y = _rows_f32(X), _rows_f32(Y)
    ys = torch.empty((T, M), dtype=torch.float32, device=X.device)
    lib = _build.load("pearson")
    err = lib.pearson_corr_launch(
        X.data_ptr(), F, M, X.stride(0), Y.data_ptr(), T, Y.stride(0),
        ys.data_ptr(), out.data_ptr(), *pearson_plan(X, T),
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check(err, "pearson_corr_launch")
    _build.count_launch(pearson_corr_cuda, *charge)
    return out


def pearson_charge(F: int, M: int, T: int) -> tuple[int, int]:
    """(operations, bytes) of one call: the rows' standardisation and the
    products; float32 X and Y read once, the correlations written once."""
    return 4 * F * M + 2 * F * M * T, (F * M + T * M + F * T) * 4


pearson_corr_cuda.launches = 0
