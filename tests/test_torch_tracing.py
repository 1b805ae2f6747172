"""The in-memory fit's spans and per-fit records
(``repro_torch.runtime.tracing``), on the CPU, and one case on the card.

Under ``torch.profiler`` a fit of L features traces ``mrmr.fit`` holding
``mrmr.validate``, one ``mrmr.pass.relevance``, L ``mrmr.pick``, L - 1
``mrmr.pass.redundancy`` and ``mrmr.fold`` (each pass of a conditional
criterion holding one ``mrmr.fuse_targets``) and ``mrmr.finish``; its
record counts 4 validation reads, one read a pick and 3 result copies.
With no profiler a span is the shared no-op and nothing is recorded.
"""

import collections
import json
import sys
import threading

import pytest
import torch

from repro_torch import MRMRSelector
from repro_torch.runtime import tracing

L = 6
CASES = [(enc, crit) for enc in ("conventional", "alternative") for crit in ("mid", "jmi")]


def _data(seed=0, m=3000, f=30):
    g = torch.Generator().manual_seed(seed)
    X = torch.randint(0, 3, (m, f), generator=g, dtype=torch.int8)
    y = torch.randint(0, 2, (m,), generator=g)
    return X, y


def _fit(encoding="conventional", criterion="mid", num_select=L, device="cpu", data=None):
    X, y = _data() if data is None else data
    return MRMRSelector(num_select=num_select, criterion=criterion, encoding=encoding,
                        device=device, devices=1).fit(X.to(device), y.to(device))


def _profiled(fit, tmp_path, device="cpu"):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        sel = fit()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return sel, spans


@pytest.mark.parametrize("encoding,criterion", CASES)
def test_spans_nest_under_the_fit(tmp_path, encoding, criterion):
    sel, spans = _profiled(lambda: _fit(encoding, criterion), tmp_path)
    assert sel.result_.engine == encoding
    names = collections.Counter(e["name"] for e in spans)
    assert not [n for n in names if n.startswith("fit:")]
    fused = L - 1 if criterion == "jmi" else 0
    assert names == collections.Counter({
        "mrmr.fit": 1, "mrmr.validate": 1, "mrmr.pass.relevance": 1, "mrmr.pick": L,
        "mrmr.pass.redundancy": L - 1, "mrmr.fold": L - 1, "mrmr.finish": 1,
        **({"mrmr.fuse_targets": fused} if fused else {})})
    (fit,) = [e for e in spans if e["name"] == "mrmr.fit"]
    end = fit["ts"] + fit["dur"]
    for e in spans:
        assert fit["ts"] <= e["ts"] and e["ts"] + e["dur"] <= end, e["name"]
    passes = [e for e in spans if e["name"] == "mrmr.pass.redundancy"]
    for e in spans:
        if e["name"] == "mrmr.fuse_targets":
            assert any(p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
                       for p in passes)


@pytest.mark.parametrize("encoding,criterion", CASES)
def test_record_counts_reads_by_site(tmp_path, encoding, criterion):
    _profiled(lambda: _fit(encoding, criterion), tmp_path)
    (rec,) = tracing.records(1)
    assert {site: n for site, (n, _) in rec.reads.items()} == dict(validate=4, pick=L, finish=3)
    assert all(s >= 0 for _, s in rec.reads.values())
    assert rec.spans["mrmr.pick"][0] == L and rec.spans["mrmr.fold"][0] == L - 1
    assert rec.spans["mrmr.fit"][1] >= rec.spans["mrmr.validate"][1] > 0
    assert rec.pass_s == []  # no CUDA events on the CPU


def test_no_profiler_records_nothing(monkeypatch):
    assert not tracing._enabled()
    assert tracing.span("mrmr.pick") is tracing.NOOP
    assert tracing.pass_frame("relevance", "cpu") is tracing.NOOP

    def refused(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    before = tracing.records(tracing.KEEP)
    sel = _fit(criterion="jmi")
    assert len(sel.selected_) == L
    after = tracing.records(tracing.KEEP)
    assert [r.fit for r in after] == [r.fit for r in before]


def test_host_read_reads_and_counts_only_in_a_record():
    t = torch.arange(4)
    assert torch.equal(tracing.host_read("pick", t), t)
    assert tracing.host_read("pick", t[2]) == 2 and isinstance(tracing.host_read("pick", t[2]), int)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span(tracing.FIT):
            tracing.host_read("pick", t)
            tracing.host_read("finish", t)
            tracing.host_read("finish", t)
    (rec,) = tracing.records(1)
    assert {site: n for site, (n, _) in rec.reads.items()} == dict(pick=1, finish=2)
    assert rec.spans == {tracing.FIT: [1, rec.spans[tracing.FIT][1]]}


def test_records_are_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "_store", collections.deque(maxlen=3))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(5):
            _fit(num_select=2)
    got = tracing.records(10)
    assert len(got) == 3 and [r.fit for r in got] == sorted(r.fit for r in got)
    assert [r.fit for r in tracing.records(2)] == [r.fit for r in got[1:]]
    assert tracing.records(0) == []
    assert tracing.KEEP == 1024


def test_threads_fitting_at_once_keep_their_records_apart(monkeypatch):
    """Two workers fit at once, one at L = 3 and one at L = 5, as if a
    profiler collected on both (the profiler traces the thread that started
    it); every record holds its own fit's picks and reads alone."""
    monkeypatch.setattr(tracing, "_enabled", lambda: True)
    data = _data(1, m=800, f=12)
    start = threading.Barrier(2)
    errors = []

    def worker(num_select):
        try:
            start.wait(timeout=30)
            for _ in range(4):
                _fit(num_select=num_select, data=data)
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(n,)) for n in (3, 5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    recs = tracing.records(8)
    assert len({r.fit for r in recs}) == 8
    assert sorted(r.spans["mrmr.pick"][0] for r in recs) == [3] * 4 + [5] * 4
    for r in recs:
        picks = r.spans["mrmr.pick"][0]
        assert r.reads["pick"][0] == picks and r.spans["mrmr.fit"][0] == 1
        assert r.spans["mrmr.pass.redundancy"][0] == picks - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("encoding,criterion", [("conventional", "jmi"), ("alternative", "mid")])
def test_passes_are_timed_on_the_card(cuda, tmp_path, encoding, criterion):
    data = _data(2, m=200_000, f=64)
    _fit(encoding, criterion, device=cuda, data=data)  # builds the kernels
    _profiled(lambda: _fit(encoding, criterion, device=cuda, data=data), tmp_path, cuda)
    (rec,) = tracing.records(1)
    assert len(rec.pass_s) == L and all(s > 0 for s in rec.pass_s)
    assert sum(rec.pass_s) <= rec.spans["mrmr.fit"][1]
    assert rec.reads["pick"][0] == L
