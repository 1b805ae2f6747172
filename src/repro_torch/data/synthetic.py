"""Synthetic data — the paper's CorrAL-style generator (Eq. 3), a
continuous dataset for the binned and Pearson paths (numpy) and the LM
token batches (torch).

The paper evaluates on binary artificial datasets where the class depends on
8 features:

    c = ((x1 ^ x2) v (x3 ^ x4)) ^ ((x5 ^ x6) v (x7 ^ x8))        (Eq. 3)

with the remaining features irrelevant noise, plus (as in CorrAL) one
column that agrees with the class 75% of the time.  Same draws as
``repro.data.synthetic.corral_dataset_np`` for the same arguments.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

RELEVANT = 8  # features participating in Eq. 3 (placed at indices 0..7)
_CONT_CHUNK = 65536  # rows generated at a time by continuous_dataset_np


def corral_dataset_np(
    num_rows: int,
    num_cols: int,
    *,
    seed: int = 0,
    flip_prob: float = 0.05,
    chunk: int = 1_000_000,
) -> tuple[np.ndarray, np.ndarray]:
    """(num_rows, num_cols) int8 features in {0,1} and (num_rows,) int8
    labels, built chunk by chunk without a (rows, cols) float allocation.
    Columns 0..7 are relevant (Eq. 3), 8 partially class-correlated, the
    rest iid noise; ``flip_prob`` injects label noise."""
    rng = np.random.default_rng(seed)
    X = np.empty((num_rows, num_cols), dtype=np.int8)
    y = np.empty((num_rows,), dtype=np.int8)
    for start in range(0, num_rows, chunk):
        stop = min(start + chunk, num_rows)
        blk = rng.integers(0, 2, size=(stop - start, num_cols), dtype=np.int8)
        x = [blk[:, i].astype(bool) for i in range(8)]
        c = (((x[0] & x[1]) | (x[2] & x[3]))
             & ((x[4] & x[5]) | (x[6] & x[7])))
        agree = rng.random(stop - start) < 0.75
        blk[:, RELEVANT] = np.where(agree, c, ~c)
        if flip_prob > 0:
            flips = rng.random(stop - start) < flip_prob
            c = np.where(flips, ~c, c)
        X[start:stop] = blk
        y[start:stop] = c.astype(np.int8)
    return X, y


def continuous_dataset_np(
    num_rows: int,
    num_cols: int,
    *,
    seed: int = 0,
    signal_cols: int = 8,
    noise: float = 0.5,
) -> tuple[np.ndarray, np.ndarray]:
    """(num_rows, num_cols) float32 features and (num_rows,) int32 classes.

    The numpy counterpart of ``repro.data.synthetic.continuous_wide_dataset``
    (same construction, other random numbers): a balanced binary class;
    columns ``0..signal_cols-1`` carry graded linear signal
    ``y * s_j + noise * N(0, 1)`` with ``s_j`` from 1.5 down to 0.5, so later
    signal columns are partly redundant with earlier ones; column
    ``signal_cols`` is a shadow of column 0 (``x_0 + 0.1 * N(0, 1)``) that
    mRMR should down-rank; the rest are iid ``N(0, 1)`` noise.  Built
    65,536 rows at a time into the output, so the largest temporary is one
    such chunk.
    """
    rng = np.random.default_rng(seed)
    X = np.empty((num_rows, num_cols), dtype=np.float32)
    y = (rng.random(num_rows) < 0.5).astype(np.int32)
    strengths = np.linspace(1.5, 0.5, signal_cols).astype(np.float32)
    for start in range(0, num_rows, _CONT_CHUNK):
        stop = min(start + _CONT_CHUNK, num_rows)
        blk = X[start:stop]
        rng.standard_normal(dtype=np.float32, out=blk)
        yc = y[start:stop, None].astype(np.float32)
        blk[:, :signal_cols] = yc * strengths + np.float32(noise) * blk[:, :signal_cols]
        if num_cols > signal_cols:
            shadow = rng.standard_normal(stop - start, dtype=np.float32)
            blk[:, signal_cols] = blk[:, 0] + np.float32(0.1) * shadow
    return X, y


def corral_dataset(num_rows: int, num_cols: int, *, seed: int = 0,
                   flip_prob: float = 0.05) -> tuple[np.ndarray, np.ndarray]:
    """:func:`corral_dataset_np` under the JAX package's name.  The JAX
    ``corral_dataset`` draws with ``jax.random``, so its bits differ from
    these (the same construction, other random numbers)."""
    return corral_dataset_np(num_rows, num_cols, seed=seed, flip_prob=flip_prob)


# ---------------------------------------------------------------------------
# LM token stream for the architecture workloads
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LMBatch:
    tokens: torch.Tensor  # (B, S) int32
    targets: torch.Tensor  # (B, S) int32 (next-token shifted)
    mask: torch.Tensor  # (B, S) float32 loss mask


def lm_token_batches(seed: int, batch: int, seq_len: int, vocab: int,
                     num_batches: int = 1):
    """Deterministic synthetic token batches (Zipf-like marginal: a squared
    uniform times the vocabulary), drawn on the host from a
    ``torch.Generator`` seeded with ``seed``.  The JAX package draws the
    same construction with ``jax.random``: the bits differ, the shapes and
    the marginal do not."""
    gen = torch.Generator().manual_seed(seed)
    for _ in range(num_batches):
        u = torch.rand((batch, seq_len + 1), generator=gen)
        tokens = (u * u * vocab).to(torch.int32)
        yield LMBatch(tokens=tokens[:, :-1], targets=tokens[:, 1:],
                      mask=torch.ones((batch, seq_len), dtype=torch.float32))
