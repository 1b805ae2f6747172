"""The benchmark's parts on the CPU: the Eq. 3 generator, the reference's
counts and information measures against brute force, the metric files'
byte counts against hand arithmetic, and discovery of new files."""

import itertools
import json
import math

import numpy as np
import pytest
import torch

from mrmr_bench import data, harness, reference
from mrmr_bench.tests.conftest import ROOT

SMALL = dict(rows=40000, cols=60, targets=3, num_values=2, num_classes=2, agree=0.75, flip=0.05)


def _eq3(x):
    return ((x[:, 0] & x[:, 1]) | (x[:, 2] & x[:, 3])) & ((x[:, 4] & x[:, 5]) | (x[:, 6] & x[:, 7]))


def test_generator_follows_eq3():
    X, Y, cols = data.corral(SMALL, 2**31 + 99, "cpu")
    assert X.dtype == torch.int8 and X.shape == (40000, 60)
    assert Y.dtype == torch.int32 and Y.shape == (3, 40000)
    assert set(torch.unique(X).tolist()) == {0, 1} and set(torch.unique(Y).tolist()) == {0, 1}
    assert cols.shape == (3, 9) and len(set(cols.flatten().tolist())) == 27  # disjoint
    for k in range(3):
        c = _eq3(X[:, cols[k, :8]].bool())
        flipped = (c != Y[k].bool()).float().mean().item()
        agree = (X[:, cols[k, 8]].bool() == c).float().mean().item()
        assert abs(flipped - 0.05) < 0.006, flipped
        assert abs(agree - 0.75) < 0.012, agree
        assert abs(c.float().mean().item() - (7 / 16) ** 2) < 0.01
    # Noise columns are fair bits, independent of the targets.
    noise = sorted(set(range(60)) - set(cols.flatten().tolist()))
    assert abs(X[:, noise].float().mean().item() - 0.5) < 0.005


def test_generator_repeats_from_its_seed():
    a = data.corral(SMALL, 7, "cpu")
    b = data.corral(SMALL, 7, "cpu")
    c = data.corral(SMALL, 8, "cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], c[0])


def _brute_counts(X, t, V, W):
    X, t = X.numpy(), t.numpy()
    out = np.zeros((X.shape[1], V, W))
    for m in range(X.shape[0]):
        for f in range(X.shape[1]):
            if 0 <= t[m] < W:
                out[f, X[m, f], t[m]] += 1
    return out


def _brute_mi(tab):
    n = tab.sum()
    total = 0.0
    for a, b in itertools.product(range(tab.shape[0]), range(tab.shape[1])):
        if tab[a, b]:
            p = tab[a, b] / n
            total += p * math.log(p / (tab[a].sum() / n * tab[:, b].sum() / n))
    return total


@pytest.mark.parametrize("V,W", [(2, 2), (3, 4), (2, 5)])
def test_reference_counts_equal_brute_force(V, W, monkeypatch):
    g = torch.Generator().manual_seed(V * 10 + W)
    X = torch.randint(0, V, (257, 7), generator=g, dtype=torch.int8)
    t = torch.randint(-1, W + 1, (257,), generator=g)  # out-of-range targets count nothing
    monkeypatch.setattr(reference, "_BLOCK_BYTES", 4 * 7 * 50)  # several row blocks
    tables = reference.Tables(X, V)
    assert tables.block == 50
    (got,) = tables([(t, W)])
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), _brute_counts(X, t, V, W))


def test_reference_counts_many_targets_in_one_read(monkeypatch):
    g = torch.Generator().manual_seed(5)
    X = torch.randint(0, 3, (300, 6), generator=g, dtype=torch.int8)
    targets = [(torch.randint(0, w, (300,), generator=g), w) for w in (2, 4, 3)]
    monkeypatch.setattr(reference, "_BLOCK_BYTES", 4 * 6 * 64)
    tables = reference.Tables(X, 3)
    together = tables(targets)
    assert [t.shape for t in together] == [(6, 3, 2), (6, 3, 4), (6, 3, 3)]
    for (t, w), got in zip(targets, together):
        np.testing.assert_array_equal(got.numpy(), _brute_counts(X, t, 3, w))
        assert torch.equal(got, tables([(t, w)])[0])


def test_reference_judges_a_pick_out_of_range_as_inf():
    X, Y, _ = data.corral(SMALL, 12, "cpu")
    tables = reference.Tables(X, 2)
    job = dict(criterion="mid", num_select=4, num_classes=2)
    sel, gains, rel = reference.control_fit(tables, Y[0], job, dtype=torch.float64)
    got = reference.judge(tables, Y[0], job, [sel[0], 60, sel[2], sel[3]], gains, rel)
    assert got["pick_gap"] == math.inf and got["relevance_err"] < 1e-8


def test_reference_information_equals_brute_force():
    g = torch.Generator().manual_seed(3)
    cnt = torch.randint(0, 50, (5, 3, 4, 2), generator=g)
    cnt[0, 1] = 0  # empty cells add nothing
    marg = cnt.sum(-1)
    for f in range(5):
        assert reference.mi(marg[f]).item() == pytest.approx(_brute_mi(marg[f].numpy()), rel=1e-12)
        n = cnt[f].sum().item()
        want = sum(cnt[f, :, :, c].sum().item() / n * _brute_mi(cnt[f, :, :, c].numpy())
                   for c in range(2))
        assert reference.cmi(cnt[f]).item() == pytest.approx(want, rel=1e-12)


def test_reference_refuses_values_out_of_range():
    with pytest.raises(ValueError):
        reference.Tables(torch.tensor([[0, 2]], dtype=torch.int8), 2)


def test_judge_reads_zero_for_its_own_picks_and_inf_for_a_repeat():
    X, Y, _ = data.corral(SMALL, 11, "cpu")
    tables = reference.Tables(X, 2)
    job = dict(criterion="jmi", num_select=5, num_classes=2)
    sel, gains, rel = reference.control_fit(tables, Y[0], job, dtype=torch.float64)
    got = reference.judge(tables, Y[0], job, sel, gains, rel)
    assert got["gain_err"] == 0.0 and got["pick_gap"] == 0.0
    assert got["relevance_err"] < 1e-8  # the relevance comes back in float32
    bad = reference.judge(tables, Y[0], job, sel[:1] * 5, gains, rel)
    assert bad["pick_gap"] == math.inf


def _load(name):
    return harness.load_metric(ROOT / "mrmr_bench", name)


def _configs():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in spec["configs"]}


def test_metric_byte_counts_by_hand():
    from mrmr_bench import work

    cfg = _configs()
    tall, fig7 = cfg["corral_tall_10m"], cfg["corral_fig7_1m_50k"]
    mid = dict(criterion="mid", num_select=10)
    jmi = dict(criterion="jmi", num_select=10)
    M, F = 10_000_000, 1000
    # A pass: X (M*F int8 bytes) and an int32 target read, int32 tables written.
    assert work.X_BYTES == 1
    assert work.fit_bytes(tall, mid) == 10 * (M * F + 4 * M) + F * 2 * 2 * 4 * 10
    assert work.fit_bytes(tall, jmi) == 10 * (M * F + 4 * M) + F * 2 * 2 * 4 + 9 * F * 2 * 4 * 4
    for name in ("fit_roofline", "contingency_roofline"):
        assert _load(name).fit_bytes is work.fit_bytes
    M, F = 1_000_000, 50_000
    assert work.fit_bytes(fig7, mid) == 10 * (M * F + 4 * M) + 40 * F * 4
    # MI: relevance tables F x 2 x 2, then each pass's F x 2 x 2 (jmi: also
    # the F x 2 class slices of 2 x 2), read once; a float32 out a table.
    mi = _load("mi_score_roofline")
    assert mi.fit_bytes(fig7, mid) == 10 * (F * 16 + F * 4)
    assert mi.fit_bytes(fig7, jmi) == 10 * (F * 16 + F * 4) + 9 * (F * 32 + F * 8)


def test_metric_readers_leave_out_what_they_cannot_read():
    cell = harness.load_cell("tall.mid", ROOT)
    run = harness.Run(cell=cell, setup_s=1.0, fits=0, window_s=1.0, fit_s=[],
                      peak_bytes=0, launches={}, trace=None)
    for m in cell.metrics["per_layer"] + cell.metrics["end_to_end"]:
        if m["name"] != "setup_s":
            assert _load(m["name"]).read(run) is None, m["name"]


def test_new_config_traffic_cell_and_metric_are_files_alone(small):
    """A deployment, a traffic mix, a cell and a metric, each added as new
    files and entries, run with no file of the harness edited."""
    bench = small / "mrmr_bench"
    config = json.loads((bench / "configs" / "corral_tall_10m.json").read_text())
    config.update(name="corral_narrow", rows=8192, cols=40, targets=2)
    (bench / "configs" / "corral_narrow.json").write_text(json.dumps(config))
    (bench / "traffic" / "cife6.json").write_text(json.dumps(dict(criterion="cife", num_select=6)))
    (bench / "workloads" / "narrow.cife6.json").write_text(json.dumps(
        dict(limits=dict(gain_err=1e-5, pick_gap=1e-5))))
    (bench / "metrics" / "fits_per_minute.py").write_text(
        'UNIT = "fits/min"\n\ndef read(run):\n    return 60 * run.fits / run.window_s\n')
    spec = json.loads((small / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="corral_narrow", source="https://arxiv.org/abs/1709.02327",
                                file="mrmr_bench/configs/corral_narrow.json", reduced=["rows"],
                                why="a test"))
    spec["workloads"].append(dict(name="narrow.cife6", config="corral_narrow", traffic="cife6",
                                  chips=1, why="a test"))
    spec["end_to_end"].append(dict(name="fits_per_minute", unit="fits/min", better="higher",
                                   bound=0.05, source="host_clock", workloads=["narrow.cife6"]))
    (small / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell("narrow.cife6", small)
    assert cell.config["cols"] == 40 and cell.traffic["criterion"] == "cife"
    assert "fits_per_minute" in [m["name"] for m in cell.metrics["end_to_end"]]
    assert "fits_per_minute" not in [m["name"] for m in harness.load_cell("tall.mid", small)
                                     .metrics["end_to_end"]]
    out = harness.run_cell(cell, 5, 0.5, False, "cpu")
    assert out["correct"], out["checks"]
    per_s = out["metrics"]["fits_per_s"]["value"]
    assert out["metrics"]["fits_per_minute"]["value"] == pytest.approx(60 * per_s)
    assert list(out["checks"]) == ["gain_err", "pick_gap"]


def test_trace_summary_of_a_known_timeline(tmp_path):
    """Two fit spans, two kernels and a host op: the window, the busy time,
    each gap put down to the innermost host operation (fits as one)."""
    from mrmr_bench import trace

    def x(cat, name, ts, dur):
        return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur)

    events = [x("user_annotation", "fit:c:target1", 0, 100), x("user_annotation", "fit:c:target2", 100, 100),
              x("kernel", "k", 10, 30), x("gpu_memcpy", "copy", 30, 20), x("kernel", "k", 120, 50),
              x("kernel", "before the window", -50, 40), x("cpu_op", "aten::x", 60, 50)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace.summarize(str(path))
    assert s.fits == 2 and s.window_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx(90e-6)  # [10, 50] and [120, 170]
    assert s.device_s == pytest.approx({"k": 80e-6, "copy": 20e-6})
    assert s.gaps_s == pytest.approx({"fit:c": 10e-6 + 30e-6, "aten::x": 70e-6})
    assert s.breakdown()["device_ops"][0] == ["k", pytest.approx(80e-6)]
