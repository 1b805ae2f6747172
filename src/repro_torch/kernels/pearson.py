"""Row correlations on the card: the CUDA port of the TPU kernel
``src/repro/kernels/pearson.py::pearson_corr_pallas``.

The kernel (``csrc/pearson.cu``) computes ``corr[f, t]``, the Pearson
correlation of row ``f`` of ``X (F, M)`` with row ``t`` of ``Y (T, M)``,
with the standardisation fused: one block per X row reads the row once,
takes its two-pass statistics (mean, then mean squared deviation; the
standard deviation clamped at 1e-12) and the products against every
standardised Y row.  Y's statistics come from a small reduction kernel of
the same source, which standardises Y into a scratch buffer once per call.

X rows must be contiguous along M: a strided X (such as the ``X.T`` view
of a row-major matrix) is copied to row-major float32 first, which costs
one extra read and write of X per call.  The alternative engine avoids it
by making one feature-major float32 copy per fit
(:meth:`repro_torch.core.scores.PearsonMIScore.feature_rows`).

The plain version is :func:`repro_torch.kernels.ref.pearson_corr`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _rows_f32(A: torch.Tensor) -> torch.Tensor:
    A = A.to(torch.float32)
    if A.shape[1] > 1 and A.stride(1) != 1:
        A = A.contiguous()
    return A


def pearson_corr_cuda(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """(F, M), (T, M) real tensors on the card -> (F, T) float32 correlations."""
    if not X.is_cuda:
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
    out = torch.empty((F, T), dtype=torch.float32, device=X.device)
    if F == 0 or T == 0:
        return out
    X, Y = _rows_f32(X), _rows_f32(Y)
    ys = torch.empty((T, M), dtype=torch.float32, device=X.device)
    lib = _build.load("pearson")
    err = lib.pearson_corr_launch(
        X.data_ptr(), F, M, X.stride(0), Y.data_ptr(), T, Y.stride(0),
        ys.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check(err, "pearson_corr_launch")
    pearson_corr_cuda.launches += 1
    return out


pearson_corr_cuda.launches = 0
