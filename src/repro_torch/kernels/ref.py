"""Plain PyTorch versions of the kernels in this package.

Each function is the semantic ground truth its CUDA kernel is held against
(on the card by ``chip_smoke.py`` and the ``cuda``-marked tests) and what the
dispatcher in :mod:`repro_torch.kernels.ops` runs for a tensor on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.core import contingency as _contingency

_EPS = 1e-12


def contingency_tables(
    X: torch.Tensor, y: torch.Tensor, num_values: int, num_classes: int
) -> torch.Tensor:
    """(M, F) int, (M,) int -> (F, V, C) int32 contingency tables.

    Out-of-range entries (padding, negatives) contribute zero counts.
    """
    return _contingency.batched_counts(
        X, y, num_values, num_classes, block=max(1, min(64, X.shape[1]))
    )


def conditional_tables(
    X: torch.Tensor, xj: torch.Tensor, y: torch.Tensor, num_values: int,
    num_classes: int,
) -> torch.Tensor:
    """(M, F), (M,), (M,) -> (F, V, V, C) int32 class-conditioned pair tables."""
    return _contingency.conditional_counts(
        X, xj, y, num_values, num_values, num_classes,
        block=max(1, min(64, X.shape[1])),
    )


def mi_scores(counts: torch.Tensor) -> torch.Tensor:
    """(F, V, C) counts -> (F,) float32 mutual information in nats.

    The total is clamped to at least 1 and zero cells add 0; the sums run
    over the class axis first, then over the value axis.
    """
    counts = counts.to(torch.float32)
    total = torch.clamp_min(counts.sum(dim=(-1, -2), keepdim=True), 1.0)
    p = counts / total
    px = p.sum(dim=-1, keepdim=True)  # (F, V, 1)
    py = p.sum(dim=-2, keepdim=True)  # (F, 1, C)
    ratio = p / torch.clamp_min(px * py, _EPS)
    terms = torch.where(
        p > 0, p * torch.log(torch.clamp_min(ratio, _EPS)), torch.zeros_like(p)
    )
    return terms.sum(dim=-1).sum(dim=-1)
