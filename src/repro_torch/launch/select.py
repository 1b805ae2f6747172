"""Feature-selection command line — the paper's job as a command line, on the card.

    # CorrAL synthetic data (paper §V), tall: plans the conventional engine
    PYTHONPATH=src python -m repro_torch.launch.select --rows 100000 --cols 1000 \
        --select 10

    # Out-of-core: stream a memmapped .npy block by block
    PYTHONPATH=src python -m repro_torch.launch.select \
        --input X.npy --target y.npy --block-obs 65536 --select 10

    # Any registered criterion, any engine; --device cpu runs the plain
    # PyTorch versions instead of the CUDA kernels
    PYTHONPATH=src python -m repro_torch.launch.select --criterion jmi \
        --encoding alternative --device cpu

    # Continuous features: quantile-bin into 16 codes and select with exact
    # MI, or score with the paper's Pearson approximation (Listing 8)
    PYTHONPATH=src python -m repro_torch.launch.select \
        --input X.npy --target y.npy --bins 16
    PYTHONPATH=src python -m repro_torch.launch.select --score pearson

Prints one JSON line: the plan, the device it ran on, the picks and gains
(and the streaming engine's I/O ledger, and the bins of a binned fit).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.criteria import available_criteria, resolve_criterion
from repro_torch.core.scores import MIScore, PearsonMIScore
from repro_torch.core.selector import MRMRSelector, check_num_select
from repro_torch.data.sources import NpySource
from repro_torch.data.synthetic import corral_dataset_np
from repro_torch.device import device_name


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", default=None,
                    help=".npy feature matrix (observations x features)")
    ap.add_argument("--target", default=None,
                    help="target-vector .npy for --input")
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--cols", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--select", type=int, default=10)
    ap.add_argument("--criterion", default="mid",
                    help=f"greedy objective: {', '.join(available_criteria())}")
    ap.add_argument("--score", default="mi", choices=["mi", "pearson"],
                    help="exact discrete MI, or the Pearson approximation "
                         "for continuous features (alternative encoding)")
    ap.add_argument("--bins", type=int, default=0,
                    help="quantile-discretise continuous features into this "
                         "many equal-frequency bins (one sketch pass) and "
                         "select with exact discrete MI; 0 = off")
    ap.add_argument("--num-values", type=int, default=2)
    ap.add_argument("--num-classes", type=int, default=2)
    ap.add_argument("--block-obs", type=int, default=65536,
                    help="observations per streamed block (.npy inputs)")
    ap.add_argument("--encoding", default="auto",
                    choices=("auto", "conventional", "alternative", "streaming"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        resolve_criterion(args.criterion)
    except ValueError:
        raise SystemExit(
            f"--criterion {args.criterion!r} is not registered; "
            f"available: {', '.join(available_criteria())}"
        ) from None

    if args.input is not None:
        if not args.target:
            raise SystemExit("--target <y.npy> is required with --input")
        data = (NpySource(args.input, args.target),)
        n_features = data[0].num_features
    else:
        X, y = corral_dataset_np(args.rows, args.cols, seed=args.seed)
        data = (X, y)
        n_features = X.shape[1]
    try:
        check_num_select(args.select, n_features)
    except ValueError as e:
        raise SystemExit(f"--select invalid: {e}") from None

    if args.bins:
        # Auto-resolve: the selector wraps continuous inputs for binning
        # and sizes the MI score from the bin config.
        score = None
    elif args.score == "mi":
        score = MIScore(num_values=args.num_values, num_classes=args.num_classes)
    else:
        score = PearsonMIScore()
    if (args.bins or args.score == "pearson") and args.input is None:
        data = (data[0].astype(np.float32), data[1])  # as the JAX CLI casts

    sel = MRMRSelector(
        num_select=args.select, score=score,
        criterion=args.criterion, encoding=args.encoding,
        block_obs=args.block_obs, device=args.device, bins=args.bins or None,
    )
    t0 = time.perf_counter()
    sel.fit(*data)
    if sel._device.type == "cuda":
        torch.cuda.synchronize(sel._device)
    seconds = time.perf_counter() - t0
    out = {
        "encoding": sel.plan_.encoding,
        "criterion": sel.result_.criterion,
        "device": device_name(sel._device),
        "selected": sel.selected_.tolist(),
        "gains": [float(g) for g in sel.gains_],
        "seconds": seconds,
    }
    if sel.result_.io is not None:
        out["block_obs"] = sel.plan_.block_obs
        out["io"] = sel.result_.io
    if sel.plan_.bins is not None:
        out["bins"] = sel.plan_.bins
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
