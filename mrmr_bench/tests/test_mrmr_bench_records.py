"""The metric files that read the program's own records of a fit
(``mrmr_bench/records.py``), over a traced window of real fits on the CPU
at small sizes."""

import dataclasses

import pytest
import torch

from mrmr_bench import data, harness
from mrmr_bench.tests.conftest import small_root

CELLS = ("tall.mid", "wide.mid", "tall.jmi", "wide.jmi")
READERS = ("host_syncs_per_fit", "validate_ms_per_fit", "pass_roofline", "host_ms_per_pick")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_programs_records(root, cell):
    """4 validation reads, one a pick (L = 10) and 3 result copies a fit;
    no CUDA events, so no pass roofline.  The CPU's trace holds no device
    work, so the line of a run off the card leaves all four out."""
    c = harness.load_cell(cell, root)
    X, Y, _ = data.corral(c.config, 2**31 + 7, "cpu")
    order = harness.target_order(2**31 + 7, Y.shape[0])
    fit_s, _, failed, _, window_s, summary = harness.window(
        X, Y, c, order, 0.3, torch.device("cpu"), traced=True)
    assert failed == 0 and summary.fits >= 1 and summary.busy_s == 0

    def read(trace):
        run = harness.Run(cell=c, setup_s=0.0, fits=len(fit_s), window_s=window_s,
                          fit_s=fit_s, peak_bytes=0, launches={}, trace=trace)
        return {name: harness.load_metric(c.bench, name).read(run) for name in READERS}

    assert read(summary) == dict.fromkeys(READERS)
    got = read(dataclasses.replace(summary, busy_s=summary.window_s / 2))
    assert got["host_syncs_per_fit"] == 17
    assert got["validate_ms_per_fit"] > 0
    assert got["host_ms_per_pick"] > 0
    assert got["pass_roofline"] is None
