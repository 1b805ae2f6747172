"""Dispatch between the CUDA kernels and their plain versions.

``use_kernel`` decides on the device of the tensor it is given:

  * ``"auto"`` — a CUDA tensor runs the kernel, a CPU tensor the plain
    PyTorch version.
  * ``True``  — the kernel; a CPU tensor raises (there is no interpreter
    for a CUDA kernel).
  * ``False`` — the plain version, wherever the tensor lies.

A CUDA tensor never falls back to the plain version under ``"auto"``: a
kernel that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.binning import bin_codes_cuda
from repro_torch.kernels.contingency import (
    conditional_tables_cuda,
    contingency_tables_cuda,
)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.mi_score import mi_scores_cuda
from repro_torch.kernels.pearson import pearson_corr_cuda


def check_use_kernel(use_kernel) -> None:
    if use_kernel is not True and use_kernel is not False and use_kernel != "auto":
        raise ValueError(
            f"use_kernel must be True, False or 'auto'; got {use_kernel!r}"
        )


def _decide(use_kernel, t: torch.Tensor) -> bool:
    """-> whether to run the kernel on ``t``."""
    check_use_kernel(use_kernel)
    if use_kernel is False:
        return False
    if use_kernel is True and not t.is_cuda:
        raise ValueError(
            f"use_kernel=True needs a CUDA tensor; got one on {t.device}"
        )
    return t.is_cuda


def contingency_tables(
    X: torch.Tensor, y: torch.Tensor, num_values: int, num_classes: int,
    use_kernel="auto",
) -> torch.Tensor:
    """(M, F), (M,) -> (F, V, C) int32 contingency tables."""
    if _decide(use_kernel, X):
        return contingency_tables_cuda(X, y, num_values, num_classes)
    return ref.contingency_tables(X, y, num_values, num_classes)


def conditional_tables(
    X: torch.Tensor, xj: torch.Tensor, y: torch.Tensor, num_values: int,
    num_classes: int, use_kernel="auto",
) -> torch.Tensor:
    """(M, F), (M,), (M,) -> (F, V, V, C) int32 class-conditioned tables."""
    if _decide(use_kernel, X):
        return conditional_tables_cuda(X, xj, y, num_values, num_classes)
    return ref.conditional_tables(X, xj, y, num_values, num_classes)


def mi_scores(counts: torch.Tensor, use_kernel="auto") -> torch.Tensor:
    """(F, V, C) or (A, B, V, C) counts -> (F,) or (A, B) float32 MI (nats)."""
    if _decide(use_kernel, counts):
        return mi_scores_cuda(counts)
    return ref.mi_scores(counts)


def bin_codes(X: torch.Tensor, edges: torch.Tensor, use_kernel="auto") -> torch.Tensor:
    """(B, N) floats x (N, E) sorted edges -> (B, N) int32 bin codes."""
    if _decide(use_kernel, X):
        return bin_codes_cuda(X, edges)
    return ref.bin_codes(X, edges)


def pearson_corr(X: torch.Tensor, Y: torch.Tensor, use_kernel="auto") -> torch.Tensor:
    """(F, M), (T, M) -> (F, T) float32 row correlations."""
    if _decide(use_kernel, X):
        return pearson_corr_cuda(X, Y)
    return ref.pearson_corr(X, Y)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    use_kernel="auto",
) -> torch.Tensor:
    """(B, S, H, D) x (B, T, KV, D) -> (B, S, H, D) GQA softmax attention."""
    if _decide(use_kernel, q):
        return flash_attention_cuda(q, k, v, causal=causal)
    return ref.flash_attention(q, k, v, causal=causal)
