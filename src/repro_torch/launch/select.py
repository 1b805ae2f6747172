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

    # A 2-D (observation x feature) mesh: REPRO_DEVICES=4 gives four mesh
    # positions, cycled over the local devices of --device (four on one card)
    REPRO_DEVICES=4 PYTHONPATH=src python -m repro_torch.launch.select \
        --rows 4096 --cols 4096 --encoding grid --mesh-obs 2 --mesh-feat 2

    # The L-pass I/O knobs of a streamed fit (CSV, Parquet or .npy input):
    # speculate 8 redundancy candidates per pass, spill parsed blocks so
    # passes 2..L replay memmapped chunks, read the next pass ahead
    PYTHONPATH=src python -m repro_torch.launch.select \
        --input data.csv --select 32 --batch-candidates 8 \
        --spill-dir /tmp/spill --readahead 2 --output result.json

Inputs: ``--input data.npz`` (arrays ``X``, ``y``) fits in memory;
``--input X.npy --target y.npy`` memmaps and streams; ``--input data.csv``
streams a CSV and ``--input data.parquet`` Parquet row batches (pyarrow),
target = last column; default is the paper's CorrAL generator.

The selector plans over the local devices of ``--device`` (one on a
one-card machine); ``REPRO_DEVICES=N`` makes N mesh positions cycled over
them, the counterpart of the JAX command line's forced host devices, so the
mesh engines run on one card.  ``--encoding grid`` places a 2-D mesh
(shape from ``--mesh-obs`` / ``--mesh-feat``, or auto-factored); the same
mesh flags apply to streamed inputs (tall sources shard blocks over the
observation axis, wide ones blocks and statistics over the feature axis).

Prints one JSON line: the plan and its mesh, the device it ran on, the
picks and gains (and the streaming engine's I/O ledger, and the bins of a
binned fit); ``--output`` also writes the full ``MRMRResult`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.core.criteria import available_criteria, resolve_criterion
from repro_torch.core.scores import MIScore, PearsonMIScore
from repro_torch.core.selector import MRMRSelector, available_encodings, check_num_select
from repro_torch.data.sources import CSVSource, NpySource
from repro_torch.data.synthetic import corral_dataset_np
from repro_torch.device import device_name
from repro_torch.dist.meshes import local_devices, make_mesh


def mesh_positions(device) -> list:
    """The devices the selector plans over: ``REPRO_DEVICES=N`` (N > 1) mesh
    positions cycled over the local devices of ``device``, else those
    devices themselves."""
    devs = local_devices(device)
    n = int(os.environ.get("REPRO_DEVICES", "0"))
    return [devs[i % len(devs)] for i in range(n)] if n > 1 else devs


def _load_input(args) -> tuple:
    """``(X, y)`` arrays for an in-memory fit, or ``(source,)`` to stream."""
    path = args.input
    if path is None:
        return corral_dataset_np(args.rows, args.cols, seed=args.seed)
    if path.endswith(".npz"):
        data = np.load(path)
        return data["X"], data["y"]
    if path.endswith(".npy"):
        if not args.target:
            raise SystemExit("--target <y.npy> is required with a .npy input")
        return (NpySource(path, args.target),)
    if path.endswith(".csv"):
        # Binned fits read float columns (the sketch pass discretises);
        # plain MI expects integer categories.
        dtype = np.int32 if args.score == "mi" and not args.bins else np.float32
        return (CSVSource(path, dtype=dtype),)
    if path.endswith(".parquet"):
        from repro_torch.data.sources import ParquetSource

        try:  # block dtypes from the file's schema; target = last column
            return (ParquetSource(path),)
        except ImportError as e:
            raise SystemExit(str(e)) from None
    raise SystemExit(f"unsupported --input {path!r} (.npz, .npy, .csv or .parquet)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", default=None,
                    help=".npz with X, y | .npy matrix (see --target) | .csv | .parquet")
    ap.add_argument("--target", default=None,
                    help="target-vector .npy for a .npy --input")
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
    ap.add_argument("--incremental", type=int, default=1,
                    help="1: running criterion fold; 0: the paper's "
                         "per-pick recomputation (in-memory engines)")
    ap.add_argument("--block", type=int, default=64,
                    help="accepted for the JAX command line; the kernels "
                         "pick their own tiling")
    ap.add_argument("--block-obs", type=int, default=65536,
                    help="observations per streamed block (file inputs)")
    ap.add_argument("--prefetch", default="auto",
                    help="streamed blocks staged ahead of the device "
                         "(0 = synchronous; 'auto' = 2 on the card, 0 on the CPU)")
    ap.add_argument("--batch-candidates", type=int, default=1,
                    help="redundancy vectors speculated per streamed pass "
                         "(q): L-1 redundancy passes drop toward "
                         "ceil((L-1)/q); selections are identical")
    ap.add_argument("--spill-dir", default=None,
                    help="encoded-block spill cache directory: pass 1 "
                         "spills parsed/encoded blocks as .npy chunks, "
                         "passes 2..L replay them memmapped")
    ap.add_argument("--spill-budget-mb", type=int, default=0,
                    help="LRU byte budget for --spill-dir in MiB (0 = unbounded)")
    ap.add_argument("--readahead", type=int, default=0,
                    help="raw blocks read ahead across pass boundaries "
                         "(0 = off; replaces --prefetch)")
    ap.add_argument("--output", default=None,
                    help="write the full MRMRResult (selected, gains, "
                         "relevance, provenance, io) as JSON to this path")
    ap.add_argument("--encoding", default="auto",
                    choices=("auto",) + available_encodings())
    ap.add_argument("--mesh-obs", type=int, default=0,
                    help="observation-axis mesh extent (0 = auto)")
    ap.add_argument("--mesh-feat", type=int, default=0,
                    help="feature-axis mesh extent (0 = auto)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        resolve_criterion(args.criterion)
    except ValueError:
        raise SystemExit(
            f"--criterion {args.criterion!r} is not registered; "
            f"available: {', '.join(available_criteria())}"
        ) from None

    data = _load_input(args)
    n_features = data[0].num_features if len(data) == 1 else data[0].shape[1]
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
    if (args.bins or args.score == "pearson") and len(data) == 2:
        data = (data[0].astype(np.float32), data[1])  # as the JAX CLI casts

    devices = mesh_positions(args.device)
    mesh = None
    if args.mesh_obs or args.mesh_feat:
        obs = args.mesh_obs or max(len(devices) // max(args.mesh_feat, 1), 1)
        feat = args.mesh_feat or max(len(devices) // obs, 1)
        mesh = make_mesh((obs, feat), ("data", "model"), devices=devices)

    sel = MRMRSelector(
        num_select=args.select, score=score,
        criterion=args.criterion, encoding=args.encoding, mesh=mesh,
        devices=devices,
        incremental=bool(args.incremental), block=args.block,
        block_obs=args.block_obs,
        prefetch=args.prefetch if args.prefetch == "auto" else int(args.prefetch),
        bins=args.bins or None, batch_candidates=args.batch_candidates,
        spill_dir=args.spill_dir,
        spill_budget_bytes=args.spill_budget_mb * 2**20 or None,
        readahead=args.readahead, device=args.device,
    )
    t0 = time.perf_counter()
    sel.fit(*data)
    if sel._device.type == "cuda":
        torch.cuda.synchronize(sel._device)
    seconds = time.perf_counter() - t0
    out = {
        "encoding": sel.plan_.encoding,
        "criterion": sel.result_.criterion,
        "mesh": dict(zip(sel.plan_.mesh_axes, sel.plan_.mesh_shape)),
        "devices": len(devices),
        "device": device_name(sel._device),
        "selected": sel.selected_.tolist(),
        "gains": [float(g) for g in sel.gains_],
        "seconds": seconds,
    }
    plan = sel.plan_
    if plan.encoding == "streaming":
        out["block_obs"] = plan.block_obs
        out["prefetch"] = plan.prefetch  # resolved ("auto" -> int)
        if plan.batch_candidates > 1:
            out["batch_candidates"] = plan.batch_candidates
        if plan.spill_dir is not None:
            out["spill_dir"] = plan.spill_dir
        if plan.readahead:
            out["readahead"] = plan.readahead
        out["io"] = sel.result_.io
    if plan.bins is not None:
        out["bins"] = plan.bins
    if args.output:
        # MRMRResult.to_json, the payload the service's result cache keeps.
        with open(args.output, "w") as f:
            f.write(sel.result_.to_json())
        out["output"] = args.output
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
