"""One run of one cell: set-up, a closed loop of fits over a timed window,
the trace, the comparison with the reference, and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Its files are
found by name under the benchmark's folder: ``configs/`` (through the
configuration's ``file``), ``traffic/<traffic>.json``,
``workloads/<cell>.json`` and ``metrics/<metric>.py``.  A metric file
defines ``UNIT`` and ``read(run) -> float | None``, where ``run`` is the
:class:`Run` below; ``None`` leaves the metric out of the line.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

from mrmr_bench import data, reference, trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_DIR = "mrmr_bench"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
# Every kernel wrapper of the program that keeps a ``launches`` counter.
KERNEL_MODULES = ("contingency", "mi_score", "binning", "pearson", "flash_attention")
WARM_FITS = 2  # set-up fits, on the first targets of the cycle
CHECKED_FITS = 8  # targets whose last fit in the window is compared


@dataclasses.dataclass
class Cell:
    """A cell and the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict  # workloads/<cell>.json: each compared number's limit
    metrics: dict  # {"end_to_end": [entry, ...], "per_layer": [...]} of this cell
    bench: pathlib.Path  # the benchmark's folder


def _read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root=ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files."""
    root = pathlib.Path(root)
    spec = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / BENCH_DIR
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_read_json(root / configs[w["config"]]["file"]),
        traffic=_read_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=_read_json(bench / "workloads" / f"{name}.json")["limits"],
        metrics={kind: [m for m in spec[kind] if _applies(m, name)]
                 for kind in ("end_to_end", "per_layer")},
        bench=bench,
    )


def load_metric(bench: pathlib.Path, name: str):
    """The module ``metrics/<name>.py`` (a name may hold dots)."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"mrmr_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Run:
    """What one run measured, for the metric files."""

    cell: Cell
    setup_s: float
    fits: int  # completed fits in the window
    window_s: float  # host clock, first fit's start to last fit's end
    fit_s: list  # every fit's seconds, host clock to synchronize()
    peak_bytes: int
    launches: dict  # kernel wrapper -> launches in the window
    trace: trace.Summary | None  # with --trace 1


def launch_counts() -> dict:
    """Every kernel wrapper's ``launches`` counter, by wrapper name."""
    out = {}
    for mod_name in KERNEL_MODULES:
        mod = sys.modules.get(f"repro_torch.kernels.{mod_name}")
        for attr, obj in vars(mod or object()).items():
            if callable(obj) and isinstance(getattr(obj, "launches", None), int):
                out[attr] = obj.launches
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit_once(X, y, cell: Cell, device: torch.device):
    """The timed path: one fit in the configuration's encoding, ended by a
    synchronize.  -> the selector."""
    from repro_torch import MRMRSelector

    sel = MRMRSelector(num_select=int(cell.traffic["num_select"]),
                       criterion=cell.traffic["criterion"], encoding=cell.config["encoding"],
                       device=str(device), devices=1)
    sel.fit(X, y)
    _sync(device)
    return sel


def target_order(seed: int, targets: int) -> list:
    """The order the fits cycle over the targets: a permutation drawn from
    the seed, so every seed runs the same targets the same number of times."""
    g = torch.Generator().manual_seed(int(seed) % 2**64)
    return torch.randperm(targets, generator=g).tolist()


def checked_targets(seed: int, done: list, count: int) -> list:
    """The targets whose last fit is compared: ``count`` of those completed,
    drawn from the seed."""
    rng = np.random.default_rng(int(seed) % 2**64)
    done = sorted(done)
    return sorted(rng.choice(done, size=min(count, len(done)), replace=False).tolist())


def window(X, Y, cell: Cell, order: list, seconds: float, device, traced: bool):
    """Fits back to back, cycling over ``order``, until ``seconds`` have
    passed (the last one runs to its end); a traced run profiles the last
    ``trace.TRACE_SECONDS`` of them.  -> (fit seconds, last result of each
    target, failures, attempted, window seconds, trace summary)."""
    fit_s, last, failed = [], {}, 0
    prof = None
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    start = time.perf_counter()
    end = start
    i = 0
    while end - start < seconds:
        k = order[i % len(order)]
        i += 1
        if traced and prof is None and end - start >= seconds - trace.TRACE_SECONDS:
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        t0 = time.perf_counter()
        try:
            if prof is not None:
                with torch.profiler.record_function(f"{trace.FIT_SPAN}{cell.name}:target{k}"):
                    sel = fit_once(X, Y[k], cell, device)
            else:
                sel = fit_once(X, Y[k], cell, device)
        except RuntimeError as e:  # a failed fit counts against the attempted ones
            print(f"fit {i} (target {k}) failed: {e}", file=sys.stderr)
            failed += 1
            sel = None
        end = time.perf_counter()
        if sel is not None:
            fit_s.append(end - t0)
            last[k] = (sel.selected_, sel.gains_, sel.scores_)
    window_s = end - start
    summary = None
    if prof is not None:
        t = [time.perf_counter()]
        prof.__exit__(None, None, None)
        t.append(time.perf_counter())
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            t.append(time.perf_counter())
            summary = trace.summarize(path)
        t.append(time.perf_counter())
        print("trace: stop %.1f s, export %.1f s, read %.1f s" % tuple(np.diff(t)), file=sys.stderr)
    return fit_s, last, failed, i, window_s, summary


def compare(X, Y, cell: Cell, last: dict, seed: int) -> dict:
    """The numbers compared, each the worst over the checked fits, beside
    its limit."""
    job = dict(cell.traffic, num_classes=cell.config["num_classes"])
    tables = reference.Tables(X, cell.config["num_values"])
    worst = {name: 0.0 for name in cell.limits}
    for k in checked_targets(seed, list(last), CHECKED_FITS):
        got = reference.judge(tables, Y[k], job, *last[k])
        for name in worst:
            worst[name] = max(worst[name], got[name])
    return {name: {"value": worst[name], "limit": float(limit)}
            for name, limit in cell.limits.items()}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
             started: float | None = None) -> dict:
    """One run of ``cell``; -> the result line as a dict (``checks`` last)."""
    started = time.perf_counter() if started is None else started
    device = torch.device(device)
    phases = {}
    mark = [started]

    def phase(name):
        _sync(device)
        now = time.perf_counter()
        phases[name] = now - mark[0]
        mark[0] = now

    import repro_torch  # noqa: F401  (set-up: the program and its kernels)
    from repro_torch.kernels import _build

    phase("import")
    if device.type == "cuda":
        torch.empty(1, device=device)
        phase("context")
        _build.build_all(cell.config["kernels"])
        phase("build")
    X, Y, _ = data.corral(cell.config, seed, device)
    phase("data")
    order = target_order(seed, Y.shape[0])
    for k in order[:WARM_FITS]:
        fit_once(X, Y[k], cell, device)
    gc.collect()
    gc.freeze()  # the set-up's objects leave the collector's scans
    phase("warm")
    setup_s = time.perf_counter() - started

    before = launch_counts()
    fit_s, last, failed, attempted, window_s, summary = window(
        X, Y, cell, order, seconds, device, traced)
    after = launch_counts()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    run = Run(cell=cell, setup_s=setup_s, fits=len(fit_s),
              window_s=window_s, fit_s=fit_s, peak_bytes=peak,
              launches={n: after[n] - before.get(n, 0) for n in after}, trace=summary)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell.metrics[kind]:
        value = load_metric(cell.bench, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(X, Y, cell, last, seed)
    correct = (failed == 0 and len(fit_s) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    dev = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["setup_phases_s"] = phases
    out["checks"] = checks
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def report(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """Each compared number beside its limit as the last lines of ``err``,
    then the result as the last line of ``out``."""
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()

