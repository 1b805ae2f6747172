"""Synthetic data — the paper's CorrAL-style generator (Eq. 3), numpy only.

The paper evaluates on binary artificial datasets where the class depends on
8 features:

    c = ((x1 ^ x2) v (x3 ^ x4)) ^ ((x5 ^ x6) v (x7 ^ x8))        (Eq. 3)

with the remaining features irrelevant noise, plus (as in CorrAL) one
column that agrees with the class 75% of the time.  Same draws as
``repro.data.synthetic.corral_dataset_np`` for the same arguments.
"""

from __future__ import annotations

import numpy as np

RELEVANT = 8  # features participating in Eq. 3 (placed at indices 0..7)


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
