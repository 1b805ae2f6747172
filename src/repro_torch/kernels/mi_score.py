"""Mutual information from contingency tables on the card: the CUDA port of
the TPU kernel ``src/repro/kernels/mi_score.py::mi_scores_pallas``.

The kernel (``csrc/mi_score.cu``) reduces stacked ``(F, V, C)`` tables to
per-row MI in nats, one thread per row, reading the int32 counts the
contingency kernel wrote (or float32 tables) without a float copy.  The
plain version is :func:`repro_torch.kernels.ref.mi_scores`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.int32: 0, torch.float32: 1}


def mi_scores_cuda(counts: torch.Tensor) -> torch.Tensor:
    """(F, V, C) int32 or float32 counts on the card -> (F,) float32 MI."""
    if not counts.is_cuda:
        raise ValueError("mi_scores_cuda needs a CUDA tensor")
    if counts.dim() != 3:
        raise ValueError(f"counts must be (F, V, C); got {tuple(counts.shape)}")
    if counts.dtype not in _DTYPES:
        counts = counts.to(torch.float32)
    counts = counts.contiguous()
    F, V, C = counts.shape
    out = torch.empty((F,), dtype=torch.float32, device=counts.device)
    if F == 0:
        return out
    lib = _build.load("mi_score")
    err = lib.mi_scores_launch(
        counts.data_ptr(), _DTYPES[counts.dtype], F, V, C, out.data_ptr(),
        torch.cuda.current_stream(counts.device).cuda_stream,
    )
    _build.check(err, "mi_scores_launch")
    mi_scores_cuda.launches += 1
    return out


mi_scores_cuda.launches = 0
