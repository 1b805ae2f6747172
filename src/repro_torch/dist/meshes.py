"""Grid factorisation for the §III planners (numpy-free arithmetic).

``factor_mesh`` splits a device or host count into a 2-D ``(obs, feat)``
grid.  The selector's both-large rule and the multi-host shard rule
(:func:`repro_torch.dist.multihost.resolve_host_shards`) both go through
it, as in the JAX package, so the two planners cannot drift.
"""

from __future__ import annotations

import math


def factor_mesh(n_devices: int, *, bias: float = 1.0) -> tuple[int, int]:
    """Split ``n_devices`` into a 2-D grid ``(a, b)``, ``a*b == n_devices``.

    ``bias`` > 1 pushes devices toward the first axis (the planner gives the
    longer data axis more shards).  Prefers balanced factorisations; falls
    back to ``(n, 1)`` for primes.
    """
    if n_devices <= 0:
        raise ValueError(f"n_devices must be positive, got {n_devices}")
    target = math.sqrt(n_devices * bias)
    best = (n_devices, 1)
    best_err = float("inf")
    for a in range(1, n_devices + 1):
        if n_devices % a:
            continue
        err = abs(math.log(a / target)) if target > 0 else float(a)
        if err < best_err:
            best, best_err = (a, n_devices // a), err
    return best


__all__ = ["factor_mesh"]
