"""Custom feature-score functions on the PyTorch port (paper §IV.D,
Listings 7-8; the counterpart of ``examples/custom_score.py``).

    PYTHONPATH=src python examples/custom_score_torch.py               # on the card
    PYTHONPATH=src python examples/custom_score_torch.py --device cpu

The paper's alternative encoding exposes ``getResult(variableArray,
classArray, selectedVariablesArray) -> Double``.  The port's equivalent is
a ``CustomScore`` whose ``get_result(v, cls, selected, n_selected)`` is
written for one candidate in torch operations and mapped over the feature
shard with ``torch.func.vmap``, a chunk of candidates a call — the same
contract.  Custom scores go through the same ``MRMRSelector`` front door as
everything else: the planner routes them to the feature-sharded (map-only)
encoding automatically, and the selector owns the layout transposition.

Two scores are shown:
  1. the paper's own example — Pearson-correlation MI approximation
     (Listing 8: f = -0.5*log(1-rho^2));
  2. a user-defined score the paper never shipped — an ANOVA-F-style
     signal-to-noise ratio, demonstrating that anything expressible in
     vmappable torch operations drops in.
"""

import argparse

import torch

from repro_torch import CustomScore, MRMRSelector, PearsonMIScore, cor2mi
from repro_torch.data.synthetic import continuous_dataset_np
from repro_torch.device import resolve_device


def _pcc(a, b):
    """Pearson correlation along the last dim (broadcasting the rest)."""
    a = a - a.mean(-1, keepdim=True)
    b = b - b.mean(-1, keepdim=True)
    return (a * b).sum(-1) / torch.sqrt((a * a).sum(-1) * (b * b).sum(-1) + 1e-12)


# --- 1. paper Listing 8, literally -----------------------------------------
def listing8_get_result(v, cls, selected, n_selected):
    """v (M,), cls (M,), selected (L, M); rows >= n_selected are zeros."""
    sc = cor2mi(_pcc(v, cls.to(v.dtype)))
    live = torch.arange(selected.shape[0], device=v.device) < n_selected
    sfs = torch.where(live, cor2mi(_pcc(selected, v)), 0.0).sum()
    coeff = torch.where(n_selected > 0, 1.0 / torch.clamp_min(n_selected, 1), 1.0)
    return sc - coeff * sfs


# --- 2. a user-defined score ------------------------------------------------
def anova_f_get_result(v, cls, selected, n_selected):
    """Relevance = between/within-class variance; redundancy = |rho|."""
    pos = cls > 0.5
    m1 = torch.where(pos, v, 0.0).sum() / torch.clamp_min(pos.sum(), 1)
    m0 = torch.where(~pos, v, 0.0).sum() / torch.clamp_min((~pos).sum(), 1)
    within = v.var(correction=0) + 1e-6
    rel = (m1 - m0) ** 2 / within
    live = torch.arange(selected.shape[0], device=v.device) < n_selected
    red = torch.where(live, torch.abs(_pcc(selected, v)), 0.0).sum()
    return rel - red / torch.clamp_min(n_selected, 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    X, y = continuous_dataset_np(2_000, 4_096, seed=0)
    X = torch.from_numpy(X).to(dev)  # conventional orientation (obs × features)

    for name, score in [
        ("built-in PearsonMI", PearsonMIScore()),
        ("Listing 8 (custom)", CustomScore(get_result=listing8_get_result)),
        ("ANOVA-F (custom)", CustomScore(get_result=anova_f_get_result)),
    ]:
        fs = MRMRSelector(num_select=8, score=score, device=str(dev)).fit(X, y)
        sel = fs.selected_.tolist()
        print(f"{name:>20s}: selected {sel} "
              f"(encoding={fs.plan_.encoding})")
        print(f"{'':>20s}  signal cols (0-7) recovered: "
              f"{len(set(sel) & set(range(8)))}/8, "
              f"redundant shadow col 8 picked: {8 in sel}")


if __name__ == "__main__":
    main()
