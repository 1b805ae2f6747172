"""The readings that a cell's limits are set from, at the cell's own size
in one process: the program's numbers (``relevance_err``, ``gain_err``,
``pick_gap``) over many seeds, the control's (the reference in the
program's place, in bfloat16) over a few, and each planted fault's
(``faults.py``) over a few.  The benchmark's runs never run this; it is
how ``workloads/<cell>.json``'s limits were found.

    python3 mrmr_bench/readings.py --workload tall.mid --seeds 1-12 --control-seeds 1-3 \
        --fault-seeds 1-3

Prints one JSON line a seed and side, then a summary line: for each
number, the largest program reading and the smallest of the control's and
of each fault's; and for each side, the seeds on which it came out not
correct under the cell's limits.
"""

import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out += list(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from mrmr_bench import data, faults, harness, reference
    from mrmr_bench.data import RELEVANT

    cell = harness.load_cell(args.workload, ROOT)
    device = torch.device(args.device)
    job = dict(cell.traffic, num_classes=cell.config["num_classes"])
    names = list(cell.limits)
    seeds = {"program": _seeds(args.seeds), "control": _seeds(args.control_seeds)}
    seeds.update({f: _seeds(args.fault_seeds) for f in faults.FAULTS})
    worst = {side: {n: [] for n in names} for side in seeds}
    failed = {side: [] for side in seeds}
    for seed in sorted(set().union(*seeds.values())):
        X, Y, columns = data.corral(cell.config, seed, device)
        tables = reference.Tables(X, cell.config["num_values"])
        targets = harness.checked_targets(seed, list(range(Y.shape[0])), harness.CHECKED_FITS)
        for side in [s for s in seeds if seed in seeds[s]]:
            line = {n: 0.0 for n in names}
            informative = RELEVANT + 1
            t0 = time.perf_counter()
            for k in targets:
                if side == "control":
                    got = reference.control_fit(tables, Y[k], job)
                else:
                    planted = faults.planted(side) if side != "program" else contextlib.nullcontext()
                    with planted:
                        sel = harness.fit_once(X, Y[k], cell, device)
                    got = (sel.selected_, sel.gains_, sel.scores_)
                read = reference.judge(tables, Y[k], job, *got)
                for n in names:
                    line[n] = max(line[n], read[n])
                designed = set(columns[k].tolist())
                informative = min(informative, sum(int(s) in designed for s in got[0]))
            for n in names:
                worst[side][n].append(line[n])
            if any(line[n] > cell.limits[n] for n in names):
                failed[side].append(seed)
            print(json.dumps(dict(seed=seed, side=side, targets=targets, seconds=time.perf_counter() - t0,
                                  informative_picks_min=informative, **line)), flush=True)
        del X, Y, tables
        if device.type == "cuda":
            torch.cuda.empty_cache()
    summary = {n: {(f"{side}_max" if side == "program" else f"{side}_min"):
                   (max if side == "program" else min)(worst[side][n], default=None)
                   for side in seeds} for n in names}
    print(json.dumps(dict(workload=args.workload, limits=cell.limits, summary=summary,
                          not_correct_on={s: failed[s] for s in seeds if seeds[s]})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
