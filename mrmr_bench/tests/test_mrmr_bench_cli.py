"""The command line and what it loads, in fresh processes on the CPU."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

from mrmr_bench.tests.conftest import BENCH, ROOT

# Imports every file of the harness and the program's fit path, runs a small
# cell on the CPU, and prints the top-level names of the loaded modules.
_PROBE = """
import json, pathlib, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
from mrmr_bench import data, harness, peaks, reference, trace, work  # noqa: F401
from mrmr_bench import run  # noqa: F401
root = pathlib.Path(sys.argv[2])
cell = harness.load_cell("tall.jmi", root)
for m in cell.metrics["end_to_end"] + cell.metrics["per_layer"]:
    harness.load_metric(cell.bench, m["name"])
out = harness.run_cell(cell, 3, 0.2, True, "cpu")
print(json.dumps(dict(correct=out["correct"], modules=sorted({m.split(".")[0] for m in sys.modules}))))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_harness_loads_neither_jax_nor_the_jax_package(small):
    proc = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT), str(small)],
                          capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.splitlines()[-1])
    assert got["correct"] is True
    assert "repro_torch" in got["modules"] and "torch" in got["modules"]
    assert not set(got["modules"]) & {"jax", "jaxlib", "flax", "repro"}


def test_harness_reads_nothing_of_the_old_benchmarks():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "benchmarks/" not in text and "import benchmarks" not in text, path
        assert "import jax" not in text and "from repro " not in text and "import repro\n" not in text


def _cli(cwd, *args):
    return subprocess.run(
        [sys.executable, "mrmr_bench/run.py", "--workload", "tall.mid", "--seed", "5",
         "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, env=_env(), timeout=300)


def test_cli_refuses_without_a_card():
    proc = _cli(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_cli_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(BENCH, tmp_path / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = _cli(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
    assert not (tmp_path / "src").exists()


def test_benchmark_json_keeps_to_its_shape():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == [BENCH.name]
    assert all(not w.startswith("/") and ".." not in w for w in spec["command"])
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in spec["end_to_end"] + spec["per_layer"]:
        mod = pathlib.Path(BENCH / "metrics" / f"{m['name']}.py")
        assert mod.exists(), m["name"]
        assert f'UNIT = "{m["unit"]}"' in mod.read_text(), m["name"]
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in spec["workloads"]:
        assert (BENCH / "workloads" / f"{w['name']}.json").exists()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert w["chips"] == 1
    for c in spec["configs"]:
        assert c["file"].startswith(BENCH.name + "/") and (ROOT / c["file"]).exists()


def test_readings_separate_the_program_from_the_control(small):
    """``readings.py`` at small sizes: the program's numbers under the
    cell's limits; the control's and each required fault's over them, on
    every seed."""
    (small / "src").symlink_to(ROOT / "src")
    proc = subprocess.run(
        [sys.executable, "mrmr_bench/readings.py", "--workload", "tall.jmi", "--seeds", "1-2",
         "--control-seeds", "2", "--fault-seeds", "2", "--device", "cpu"],
        cwd=small, capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    limits = json.loads((BENCH / "workloads" / "tall.jmi.json").read_text())["limits"]
    faults = ["state_unchanged", "half_the_rows", "answer_altered", "last_pick_altered"]
    assert [(d["seed"], d["side"]) for d in lines[:-1]] == [
        (1, "program"), (2, "program"), (2, "control")] + [(2, f) for f in faults]
    for d in lines[:-1]:
        over = [d[n] > limit for n, limit in limits.items()]
        if d["side"] == "program":
            assert not any(over) and d["informative_picks_min"] == 9, d
        elif d["side"] != "last_pick_altered":
            assert any(over), d
    last = lines[-1]
    assert set(last["summary"]) == set(limits) and last["limits"] == limits
    assert set(last["summary"]["gain_err"]) == {"program_max", "control_min"} | {
        f"{f}_min" for f in faults}
    assert last["not_correct_on"]["program"] == [] and last["not_correct_on"]["control"] == [2]
