"""The paper's CorrAL-style data (arXiv:1709.02327, Eq. 3), made on the
device from a seed.

Every feature is an independent fair bit.  Each of ``targets`` class
vectors depends on 8 columns of its own,

    c = ((x1 & x2) | (x3 & x4)) & ((x5 & x6) | (x7 & x8))        (Eq. 3)

and one further column of its own agrees with that class ``agree`` of the
time; the label is then flipped with probability ``flip``.  The 9 columns
of each target are drawn from the seed, disjoint across targets, so every
target sees the others' columns as noise.  The same seed on the same kind
of device gives the same bits.
"""

from __future__ import annotations

import torch

RELEVANT = 8  # columns of Eq. 3 a target
X_DTYPE = torch.int8  # the type X is made in and handed to ``fit`` in


def corral(config: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> ``(X, Y, columns)``: ``X`` (rows, cols) ``X_DTYPE`` in {0, 1}, ``Y``
    (targets, rows) int32 labels, ``columns`` (targets, 9) int64 on the host:
    each target's Eq. 3 columns, then its agreeing column."""
    rows, cols, targets = int(config["rows"]), int(config["cols"]), int(config["targets"])
    if config["num_values"] != 2 or config["num_classes"] != 2:
        raise ValueError("Eq. 3 data is binary: num_values and num_classes must be 2")
    if targets * (RELEVANT + 1) > cols:
        raise ValueError(f"{targets} targets need {targets * (RELEVANT + 1)} columns; have {cols}")
    g = torch.Generator(device=device).manual_seed(int(seed) % 2**64)
    X = torch.empty((rows, cols), dtype=X_DTYPE, device=device).random_(0, 2, generator=g)
    columns = torch.randperm(cols, generator=g, device=device)[: targets * (RELEVANT + 1)]
    columns = columns.view(targets, RELEVANT + 1).cpu()
    Y = torch.empty((targets, rows), dtype=torch.int32, device=device)
    for k in range(targets):
        x = X[:, columns[k, :RELEVANT].to(device)].bool()
        c = (((x[:, 0] & x[:, 1]) | (x[:, 2] & x[:, 3]))
             & ((x[:, 4] & x[:, 5]) | (x[:, 6] & x[:, 7])))
        agree = torch.rand(rows, generator=g, device=device) < float(config["agree"])
        X[:, int(columns[k, RELEVANT])] = (agree == c).to(X_DTYPE)
        flip = torch.rand(rows, generator=g, device=device) < float(config["flip"])
        Y[k] = (c ^ flip).to(torch.int32)
    return X, Y, columns
