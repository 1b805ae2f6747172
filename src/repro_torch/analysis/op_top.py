"""Rank a dry-run step's ops by bytes, collective traffic and FLOPs (the
port's counterpart of ``repro.analysis.hlo_top``).

The profiling loop without a card: rank every op of the counted step
(:func:`~repro_torch.analysis.op_analysis.analyze_step` with ``keep_ops``)
by its contribution to the roofline terms, and attribute it to the model
code that issued it: the innermost frame under ``src/repro_torch/models/``
(``hlo_top`` attributes by XLA's ``op_name``), or the autograd node of a
backward op.  Three rankings: ops by HBM bytes, collectives by operand
bytes, matmuls (and the hand kernels' charges) by FLOPs, all per device.

    PYTHONPATH=src python -m repro_torch.analysis.op_top results/dryrun_torch/single/X.ops.json
    PYTHONPATH=src python -m repro_torch.analysis.op_top qwen1.5-0.5b__decode_32k --mesh single

The first form reads the op list ``launch.dryrun --keep-ops`` saved beside a
record; the second runs the cell (``arch__shape``) on the production mesh.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict


def totals(ops: list) -> dict:
    """The per-device sums of an op list: bytes, flops, collective bytes."""
    return {"bytes": sum(o[0] for o in ops), "flops": sum(o[1] for o in ops),
            "collective_bytes": sum(o[2] for o in ops)}


def _rank(ops: list, col: int, key) -> list:
    agg = defaultdict(lambda: [0.0, 0])
    for o in ops:
        if o[col]:
            slot = agg[key(o)]
            slot[0] += o[col]
            slot[1] += 1
    return sorted(agg.items(), key=lambda kv: -kv[1][0])


def report(ops: list, top_n: int = 25) -> None:
    """Print the three rankings of ``ops``."""
    print("== top ops by HBM bytes (per device) ==")
    rows = _rank(ops, 0, lambda o: (o[3], o[4]))
    total_b = sum(v[0] for _, v in rows) or 1.0
    for (kind, at), (b, n) in rows[:top_n]:
        print(f"  {b/1e9:10.3f} GB {100*b/total_b:5.1f}% x{n:<5d} {kind:<22s} {at}")
    print(f"  total: {total_b/1e9:.3f} GB")

    print("\n== collectives (per device) ==")
    rows = _rank(ops, 2, lambda o: (o[3], o[4]))
    total_c = sum(v[0] for _, v in rows) or 1.0
    for (kind, at), (cb, n) in rows[:top_n]:
        print(f"  {cb/1e9:10.4f} GB {100*cb/total_c:5.1f}% x{n:<5d} {kind:<24s} {at}")
    print(f"  total: {total_c/1e9:.4f} GB")

    print("\n== top matmuls by FLOPs (per device) ==")
    rows = _rank(ops, 1, lambda o: o[4])
    total_f = sum(v[0] for _, v in rows) or 1.0
    for at, (fl, n) in rows[:top_n]:
        print(f"  {fl/1e12:10.4f} TF {100*fl/total_f:5.1f}% x{n:<5d} {at}")
    print(f"  total: {total_f/1e12:.4f} TFLOP")


def _cell_ops(cell: str, mesh_kind: str, overrides: dict) -> list:
    from repro_torch.analysis.op_analysis import analyze_step
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.launch.mesh import make_production_mesh

    arch, shape = cell.split("__")
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    fn, args, arg_bytes, _, _ = build_cell(arch, shape, mesh, overrides)
    return analyze_step(fn, *args, num_partitions=mesh.size, argument_bytes=arg_bytes,
                        keep_ops=True)["ops"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("source", help="an .ops.json from launch.dryrun --keep-ops, or a cell "
                                   "arch__shape to run")
    ap.add_argument("top_n", nargs="?", type=int, default=25)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="config override key=value for a cell (repeatable)")
    args = ap.parse_args(argv)
    if args.source.endswith(".json"):
        with open(args.source) as f:
            ops = json.load(f)
    else:
        ops = _cell_ops(args.source, args.mesh, dict(kv.split("=", 1) for kv in args.overrides))
    report(ops, args.top_n)


if __name__ == "__main__":
    main()
