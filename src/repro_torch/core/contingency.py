"""Contingency-table math, plain PyTorch — the paper's mapper/combiner payload.

In the paper's conventional encoding every mapper emits, per observation and
per (candidate, target) pair, a one-hot contingency table; the combiner and
reducer sum them.  This module is the plain version of that count (the
oracle for :mod:`repro_torch.kernels.contingency`):

    counts[f, v, c] = sum_m  onehot(X[m, f])[v] * onehot(y[m])[c]

computed as a one-hot einsum over feature blocks, so the one-hot expansion
never materialises at full (M, F, V) size.  Counts come back as int32 and
are exact: the einsum accumulates in float32 while every sum stays below
2**24 rows, and in float64 beyond.  Out-of-range values (negatives, the
``2**31-1`` sentinel) one-hot to all-zero rows and count nothing.
"""

from __future__ import annotations

import torch

from repro_torch.runtime import tracing

# Out-of-range sentinel for fused and padded targets: one-hots to an
# all-zero row, so invalid (padded / masked) observations vanish from the
# counts.
OOR = 2**31 - 1

_F32_EXACT = 2**24


def _onehot(x: torch.Tensor, depth: int, dtype) -> torch.Tensor:
    """One-hot along a new trailing axis. Out-of-range values map to zeros."""
    iota = torch.arange(depth, device=x.device)
    return (x.unsqueeze(-1) == iota).to(dtype)


def _acc_dtype(num_obs: int):
    return torch.float32 if num_obs < _F32_EXACT else torch.float64


def pair_counts(x: torch.Tensor, y: torch.Tensor, vx: int, vy: int) -> torch.Tensor:
    """(M,), (M,) -> (vx, vy) int32 contingency table of one column pair."""
    dt = _acc_dtype(x.shape[0])
    tab = torch.einsum("mv,mc->vc", _onehot(x, vx, dt), _onehot(y, vy, dt))
    return tab.round().to(torch.int32)


def batched_counts(
    X: torch.Tensor, y: torch.Tensor, vx: int, vy: int, *, block: int = 64
) -> torch.Tensor:
    """Contingency tables of every column of ``X`` against ``y``.

    Args:
      X: (M, F) int — feature matrix (discrete values in [0, vx)); any
        strides (a transposed feature-major view works as is).
      y: (M,) int — target values in [0, vy).
      block: feature-block size; the (M, block, vx) one-hot is the largest
        intermediate.
    Returns:
      (F, vx, vy) int32 counts.
    """
    M, F = X.shape
    if F == 0:
        return torch.zeros((0, vx, vy), dtype=torch.int32, device=X.device)
    dt = _acc_dtype(M)
    y_oh = _onehot(y, vy, dt)  # (M, vy)
    # Blocks joined with cat, not written into a preallocated output, so
    # the count also runs under torch.func.vmap.
    return torch.cat([
        torch.einsum("mfv,mc->fvc", _onehot(X[:, lo : lo + block], vx, dt), y_oh)
        .round().to(torch.int32)
        for lo in range(0, F, block)
    ])


def counts_with_column(X: torch.Tensor, xj: torch.Tensor, v: int, *,
                       block: int = 64) -> torch.Tensor:
    """(F, v, v) int32 tables of every column of ``X`` against one feature
    column ``xj`` (both in [0, v))."""
    return batched_counts(X, xj, v, v, block=block)


def fuse_targets(
    other: torch.Tensor, cls: torch.Tensor, vy: int, num_classes: int
) -> torch.Tensor:
    """Fuse a target column with the class column into one int32 code.

    ``code = other * num_classes + cls`` lands in ``[0, vy * num_classes)``
    exactly when both inputs are in range; any out-of-range input (padding
    sentinels, negatives) maps to :data:`OOR`, so fused padding vanishes
    from the counts just like unfused padding.  The product is formed in
    int64 behind the range mask, so ``sentinel * num_classes`` can never
    wrap back into the valid code range.
    """
    with tracing.span("mrmr.fuse_targets"):
        o = other.to(torch.int64)
        c = cls.to(torch.int64)
        ok = (o >= 0) & (o < vy) & (c >= 0) & (c < num_classes)
        code = torch.where(ok, o * num_classes + c, torch.full_like(o, OOR))
        return code.to(torch.int32)


def conditional_counts(
    X: torch.Tensor,
    xj: torch.Tensor,
    y: torch.Tensor,
    vx: int,
    vy: int,
    num_classes: int,
    *,
    block: int = 64,
) -> torch.Tensor:
    """3-way counts of every column of ``X`` against ``(xj, y)`` jointly.

    The class axis rides fused into the target (:func:`fuse_targets`), so
    this is an ordinary pair count against ``vy * num_classes`` target
    values, unflattened to ``(F, vx, vy, num_classes)``: ``sum(-1)`` is the
    marginal pair table, each ``[..., c]`` slice the within-class table.
    """
    fused = fuse_targets(xj, y, vy, num_classes)
    cnt = batched_counts(X, fused, vx, vy * num_classes, block=block)
    return cnt.reshape(cnt.shape[0], vx, vy, num_classes)
