"""Whole runs of the harness on the CPU at small sizes (the look for a card
skipped): the result line's schema, a sound run coming out correct, and the
control and each fault a cell can have coming out not correct."""

import io
import json
import math

import numpy as np
import pytest
import torch

from mrmr_bench import data, faults, harness, reference
from mrmr_bench.tests.conftest import small_root

CELLS = ("tall.mid", "wide.mid", "tall.jmi", "wide.jmi")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("bench"))


def _run(root, cell, seed=2**31 + 5, traced=False, seconds=0.3):
    return harness.run_cell(harness.load_cell(cell, root), seed, seconds, traced, "cpu")


def test_result_line_schema(root):
    out = _run(root, "tall.mid")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"fits_per_s", "fit_p95_ms", "setup_s"}  # no card: no peak
    for m in out["metrics"].values():
        assert isinstance(m["value"], float) and m["value"] > 0 and m["unit"]
    assert out["device"] == dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    stdout, stderr = io.StringIO(), io.StringIO()
    harness.report(out, stdout, stderr)
    assert json.loads(stdout.getvalue().splitlines()[-1]) == json.loads(json.dumps(out))
    last = stderr.getvalue().splitlines()[-len(out["checks"]):]
    assert [line.split()[1] for line in last] == list(out["checks"])


def test_traced_line_schema(root):
    out = _run(root, "tall.jmi", traced=True)
    assert out["correct"] is True
    assert set(out["metrics"]) <= {"launches_per_fit", "fit_roofline", "contingency_roofline",
                                   "mi_score_roofline", "device_idle"}
    assert "fit_roofline" in out["metrics"] and "fits_per_s" not in out["metrics"]
    assert out["device"]["window_s"] > 0 and out["device"]["busy_s"] >= 0
    for key in ("device_ops", "idle_gaps"):
        rows = out["breakdown"][key]
        assert len(rows) <= 10 and all(isinstance(s, float) for _, s in rows)
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    out = _run(root, cell, seed=31 + CELLS.index(cell))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_rows", "answer_altered"])
def test_fault_comes_out_not_correct(root, cell, fault):
    with faults.planted(fault):
        out = _run(root, cell, seed=77)
    assert out["correct"] is False, (fault, out["checks"])


def test_planted_faults_are_taken_out_again(root):
    from repro_torch.core.selector import MRMRSelector

    before = dict(vars(MRMRSelector))
    for fault in faults.FAULTS:
        with faults.planted(fault):
            pass
    assert dict(vars(MRMRSelector)) == before
    assert _run(root, "tall.mid", seed=78)["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(root, cell):
    """The reference computed in bfloat16, put in the program's place and
    judged by the cell's own limits, fails at least one of them."""
    c = harness.load_cell(cell, root)
    X, Y, _ = data.corral(c.config, 123, "cpu")
    job = dict(c.traffic, num_classes=c.config["num_classes"])
    tables = reference.Tables(X, c.config["num_values"])
    for k in range(Y.shape[0]):
        got = reference.judge(tables, Y[k], job, *reference.control_fit(tables, Y[k], job))
        assert any(got[n] > limit for n, limit in c.limits.items()), got


def test_limits_lie_above_the_program_at_small_sizes(root):
    """The program's float32 readings at the tests' sizes sit far under the
    limits (which were set from the card's readings at the cells' sizes)."""
    for cell in CELLS:
        out = _run(root, cell, seed=5)
        for c in out["checks"].values():
            assert c["value"] <= c["limit"] / 10, (cell, c)


@pytest.mark.parametrize("cell,engine", [("tall.mid", "conventional"), ("wide.jmi", "alternative")])
def test_fits_run_in_the_configurations_encoding(root, cell, engine):
    c = harness.load_cell(cell, root)
    X, Y, _ = data.corral(c.config, 4, "cpu")
    assert harness.fit_once(X, Y[0], c, torch.device("cpu")).result_.engine == engine


def test_checked_targets_come_from_the_seed():
    a = harness.checked_targets(9, list(range(16)), 8)
    assert a == harness.checked_targets(9, list(range(16)), 8) and len(set(a)) == 8
    assert harness.checked_targets(9, [3, 1], 8) == [1, 3]
    assert sorted(harness.target_order(2**31 + 9, 16)) == list(range(16))
    assert harness.target_order(1, 16) != harness.target_order(2, 16)


def test_judge_takes_the_worst_pick():
    X, Y, _ = data.corral(dict(rows=8192, cols=40, targets=1, num_values=2, num_classes=2,
                               agree=0.75, flip=0.05), 3, "cpu")
    tables = reference.Tables(X, 2)
    job = dict(criterion="mid", num_select=4, num_classes=2)
    sel, gains, rel = reference.control_fit(tables, Y[0], job, dtype=torch.float64)
    off = list(gains)
    off[2] += 1e-3
    got = reference.judge(tables, Y[0], job, sel, off, rel)
    assert got["gain_err"] == pytest.approx(1e-3) and got["pick_gap"] == 0.0
    nan_rel = np.full(40, math.nan, dtype=np.float32)
    assert reference.judge(tables, Y[0], job, sel, gains, nan_rel)["relevance_err"] == math.inf


@pytest.mark.cuda
def test_cells_run_correct_on_the_card(cuda, root):
    for cell in CELLS:
        out = harness.run_cell(harness.load_cell(cell, root), 2**31 + 3, 0.5, True, cuda)
        assert out["correct"], (cell, out["checks"])
        assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
        assert out["metrics"]["launches_per_fit"]["value"] > 0
