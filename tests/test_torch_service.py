"""The port's selection service against the JAX package's: the same cache
key for the same request, a stampede that runs the engine once,
backpressure, cancel, retries, result persistence, the fits themselves and
the ``serve_select`` command line (``--device cpu``).
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core.criteria import resolve_criterion as jresolve_criterion
from repro.core.scores import MIScore as JMIScore
from repro.core.scores import PearsonMIScore as JPearsonMIScore
from repro.data import sources as jsources
from repro.serve import selection as jselection

from repro_torch import MIScore, PearsonMIScore
from repro_torch.core.criteria import resolve_criterion
from repro_torch.core.mrmr import MRMRResult
from repro_torch.data import sources as tsources
from repro_torch.runtime.resilience import (
    StepWatchdog,
    TransientError,
    retry_with_backoff,
)
from repro_torch.serve.selection import (
    CANCELLED,
    DONE,
    FAILED,
    QUEUED,
    Backpressure,
    JobCancelled,
    JobFailed,
    ResultCache,
    SelectionRequest,
    SelectionService,
    UnknownJob,
    parse_source_ref,
)

RTOL, ATOL = 1e-5, 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_memos():
    tsources.clear_stats_memo()
    yield
    tsources.clear_stats_memo()


def _dummy_result(tag: int = 0) -> MRMRResult:
    return MRMRResult(
        selected=torch.tensor([tag, tag + 1], dtype=torch.int32),
        gains=torch.tensor([1.5, 0.5]),
        relevance=torch.tensor([0.1, float("nan"), 0.3]),
        criterion="mid",
        engine="streaming",
    )


def _assert_results_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.selected), np.asarray(b.selected))
    np.testing.assert_allclose(np.asarray(a.gains), np.asarray(b.gains), rtol=RTOL, atol=ATOL)
    if a.relevance is None:
        assert b.relevance is None
    else:
        np.testing.assert_allclose(np.asarray(a.relevance), np.asarray(b.relevance),
                                   rtol=RTOL, atol=ATOL, equal_nan=True)
    assert (a.criterion, a.engine) == (b.criterion, b.engine)


class TestCacheKey:
    @pytest.mark.parametrize("score,jscore", [
        (MIScore(2, 2), JMIScore(2, 2)),
        (MIScore(4, 3, block=32, use_kernel=False), JMIScore(4, 3, block=32, use_pallas=False)),
        (PearsonMIScore(), JPearsonMIScore()),
    ])
    @pytest.mark.parametrize("criterion", ["mid", "jmi"])
    def test_cache_key_equal_to_jax(self, score, jscore, criterion):
        t = SelectionRequest(source=tsources.CorralSource(512, 16, seed=3), num_select=4,
                             score=score, criterion=resolve_criterion(criterion),
                             block_obs=128, readahead=2, device="cpu")
        j = jselection.SelectionRequest(source=jsources.CorralSource(512, 16, seed=3),
                                        num_select=4, score=jscore,
                                        criterion=jresolve_criterion(criterion))
        assert t.cache_key() == j.cache_key()

    def test_file_sources_keyed_like_jax(self, tmp_path):
        xp, yp = str(tmp_path / "X.npy"), str(tmp_path / "y.npy")
        tsources.CorralSource(256, 16, seed=0).to_npy(xp, yp)
        for ref in (f"{xp}::{yp}", "corral:256x16:4"):
            t = SelectionRequest(source=parse_source_ref(ref), num_select=3,
                                 score=MIScore(2, 2), criterion=resolve_criterion("mid"))
            j = jselection.SelectionRequest(source=jselection.parse_source_ref(ref),
                                            num_select=3, score=JMIScore(2, 2),
                                            criterion=jresolve_criterion("mid"))
            assert t.cache_key() == j.cache_key()

    def test_parse_source_ref(self, tmp_path):
        csv = tmp_path / "d.csv"
        csv.write_text("1,0,1\n0,1,0\n")
        assert isinstance(parse_source_ref(str(csv)), tsources.CSVSource)
        assert parse_source_ref("corral:256x16:7") == tsources.CorralSource(256, 16, seed=7)
        with pytest.raises(ValueError):
            parse_source_ref("lonely.npy")
        with pytest.raises(ValueError):
            parse_source_ref("corral:banana")


class TestResultCache:
    def test_lru_eviction_bound(self):
        cache = ResultCache(capacity=2)
        for i in range(3):
            cache.put(f"k{i}", _dummy_result(i))
        assert len(cache) == 2 and cache.stats()["evictions"] == 1
        assert cache.get("k0") is None
        assert cache.get("k1") is not None and cache.get("k2") is not None

    def test_persistence_roundtrip(self, tmp_path):
        d = str(tmp_path / "cache")
        ResultCache(capacity=4, persist_dir=d).put("k", _dummy_result(7))
        fresh = ResultCache(capacity=4, persist_dir=d)  # a new process
        got = fresh.get("k")
        _assert_results_equal(got, _dummy_result(7))
        assert fresh.stats()["disk_hits"] == 1
        # strict JSON on disk, and the JAX package's cache reads it back
        with open(os.path.join(d, "k.json")) as f:
            json.loads(f.read(), parse_constant=lambda c: pytest.fail(f"bare {c}"))
        _assert_results_equal(jselection.ResultCache(4, persist_dir=d).get("k"),
                              _dummy_result(7))


def _probe_source(rows=64, cols=16):
    rng = np.random.default_rng(0)
    X = rng.integers(0, 2, size=(rows, cols)).astype(np.int32)
    y = rng.integers(0, 2, size=(rows,)).astype(np.int32)

    class Probe(tsources.ArraySource):
        passes = 0

        def iter_blocks(self, block_obs):
            Probe.passes += 1
            return super().iter_blocks(block_obs)

    return Probe(X, y), Probe, (X, y)


class TestService:
    def test_second_identical_submission_hits_cache_zero_io(self):
        source, Probe, (X, y) = _probe_source()
        with SelectionService(workers=1, queue_capacity=4, device="cpu") as svc:
            j1 = svc.submit(source, num_select=2, score=MIScore(2, 2), block_obs=32)
            r1 = svc.result(j1, timeout=120)
            after_first = Probe.passes
            j2 = svc.submit(source, num_select=2, score=MIScore(2, 2), block_obs=32)
            r2 = svc.result(j2, timeout=10)
            assert Probe.passes == after_first  # a pure cache read
            assert svc.poll(j2).state == DONE and svc.poll(j2).cache_hit
            assert svc.stats()["cache"]["hits"] == 1
            _assert_results_equal(r1, r2)
        with jselection.SelectionService(workers=1) as jsvc:
            jr = jsvc.result(jsvc.submit(jsources.ArraySource(X, y), num_select=2,
                                         score=JMIScore(2, 2), block_obs=32), timeout=120)
        _assert_results_equal(r1, jr)
        assert r1.io == jr.io

    def test_binned_fits_like_jax(self):
        rng = np.random.default_rng(31)
        X = rng.normal(size=(256, 8))
        y = rng.integers(0, 2, size=256)
        with SelectionService(workers=1, device="cpu") as svc:
            r16 = svc.result(svc.submit(tsources.ArraySource(X, y), num_select=3, bins=16,
                                        block_obs=64), timeout=120)
            j64 = svc.submit(tsources.ArraySource(X, y), num_select=3, bins=64, block_obs=64)
            svc.result(j64, timeout=120)
            assert not svc.poll(j64).cache_hit  # the bin config is part of the key
        with jselection.SelectionService(workers=1) as jsvc:
            jr16 = jsvc.result(jsvc.submit(jsources.ArraySource(X, y), num_select=3,
                                           bins=16, block_obs=64), timeout=120)
        _assert_results_equal(r16, jr16)

    def test_stampede_runs_engine_exactly_once(self):
        n_threads, calls = 6, []
        release = threading.Event()

        def slow_fit(request):
            calls.append(request.cache_key())
            release.wait(timeout=30)
            return _dummy_result()

        source = tsources.CorralSource(256, 16, seed=0)
        source.fingerprint()
        job_ids = [None] * n_threads
        barrier = threading.Barrier(n_threads)
        with SelectionService(workers=2, queue_capacity=8, fit_fn=slow_fit,
                              device="cpu") as svc:
            def submit(i):
                barrier.wait()
                job_ids[i] = svc.submit(source, num_select=2, score=MIScore(2, 2))

            threads = [threading.Thread(target=submit, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            release.set()
            results = [svc.result(j, timeout=30) for j in job_ids]
            assert len(calls) == 1
            for r in results:
                _assert_results_equal(r, results[0])
            assert svc.stats()["coalesced"] == n_threads - 1
            assert sum(svc.poll(j).coalesced_into is not None for j in job_ids) == n_threads - 1

    def test_stampede_of_real_fits_runs_once_and_matches_jax(self):
        """Two workers: two identical requests at once run the engine once,
        a distinct one runs beside them."""
        X, y = jsources.CorralSource(3000, 20, seed=2).materialize()
        from repro_torch.serve.selection import _default_fit

        runs = []

        def counting_fit(request):
            runs.append(request.num_select)
            return _default_fit(request)

        src = tsources.ArraySource(X, y)
        with SelectionService(workers=2, fit_fn=counting_fit, device="cpu") as svc:
            a = svc.submit(src, num_select=5, block_obs=700)
            b = svc.submit(src, num_select=5, block_obs=700)
            c = svc.submit(src, num_select=3, block_obs=700)
            ra, rb, rc = (svc.result(j, timeout=120) for j in (a, b, c))
            assert svc.poll(b).coalesced_into == a
        assert sorted(runs) == [3, 5]
        with jselection.SelectionService(workers=1) as jsvc:
            jr = jsvc.result(jsvc.submit(jsources.ArraySource(X, y), num_select=5,
                                         block_obs=700), timeout=120)
        _assert_results_equal(ra, jr)
        _assert_results_equal(rb, jr)
        np.testing.assert_array_equal(rc.selected.numpy(), ra.selected.numpy()[:3])

    def test_overflow_rejects_with_retry_after(self):
        started, release = threading.Event(), threading.Event()

        def blocking_fit(request):
            started.set()
            release.wait(timeout=30)
            return _dummy_result()

        X, y = np.zeros((8, 4), np.int32), np.zeros((8,), np.int32)
        with SelectionService(workers=1, queue_capacity=1, fit_fn=blocking_fit,
                              device="cpu") as svc:
            j1 = svc.submit(tsources.ArraySource(X, y), num_select=1, score=MIScore(2, 2))
            assert started.wait(timeout=10)
            j2 = svc.submit(tsources.ArraySource(X, y), num_select=2, score=MIScore(2, 2))
            with pytest.raises(Backpressure) as exc:
                svc.submit(tsources.ArraySource(X, y), num_select=3, score=MIScore(2, 2))
            assert exc.value.retry_after_s > 0
            assert svc.stats()["queue"]["rejected"] == 1
            release.set()
            assert svc.result(j1, timeout=30) is not None
            assert svc.result(j2, timeout=30) is not None

    def test_cancel_queued_job(self):
        started, release = threading.Event(), threading.Event()

        def blocking_fit(request):
            started.set()
            release.wait(timeout=30)
            return _dummy_result()

        svc = SelectionService(workers=1, fit_fn=blocking_fit, device="cpu")
        X, y = np.zeros((8, 4), np.int32), np.zeros((8,), np.int32)
        try:
            j1 = svc.submit(tsources.ArraySource(X, y), num_select=1, score=MIScore(2, 2))
            assert started.wait(timeout=10)
            j2 = svc.submit(tsources.ArraySource(X, y), num_select=2, score=MIScore(2, 2))
            assert svc.poll(j2).state == QUEUED
            assert svc.cancel(j2) and svc.poll(j2).state == CANCELLED
            with pytest.raises(JobCancelled):
                svc.result(j2, timeout=5)
            assert not svc.cancel(j1)  # a running primary cannot be cancelled
            release.set()
            assert svc.result(j1, timeout=30) is not None
        finally:
            release.set()
            svc.close()

    def test_unknown_job_and_failure(self):
        def bad_fit(request):
            raise ValueError("boom")

        with SelectionService(workers=1, fit_fn=bad_fit, device="cpu") as svc:
            with pytest.raises(UnknownJob):
                svc.poll("job-9999")
            j = svc.submit("corral:256x16:0", num_select=2, score=MIScore(2, 2))
            with pytest.raises(JobFailed, match="boom"):
                svc.result(j, timeout=30)
            assert svc.poll(j).state == FAILED and "boom" in svc.poll(j).error

    def test_transient_failure_retried_to_done(self):
        attempts = []

        def flaky_fit(request):
            attempts.append(1)
            if len(attempts) == 1:
                raise TransientError("worker preempted")
            return _dummy_result()

        with SelectionService(workers=1, fit_fn=flaky_fit, max_attempts=2,
                              retry_sleep=lambda s: None, device="cpu") as svc:
            j = svc.submit("corral:256x16:0", num_select=2, score=MIScore(2, 2))
            assert svc.result(j, timeout=30) is not None
            assert svc.poll(j).attempts == 2

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SelectionService(workers=1)


class TestRetryWithBackoff:
    def test_backs_off_then_succeeds(self):
        delays, calls = [], []

        def fn():
            calls.append(1)
            if len(calls) < 3:
                raise TransientError("flaky")
            return "ok"

        assert retry_with_backoff(fn, max_attempts=3, base_delay_s=0.5,
                                  sleep=delays.append) == "ok"
        assert delays == [0.5, 1.0]

    def test_exhaustion_and_non_retryable(self):
        with pytest.raises(TransientError):
            retry_with_backoff(lambda: (_ for _ in ()).throw(TransientError("x")),
                               max_attempts=2, sleep=lambda s: None)
        calls = []

        def fn():
            calls.append(1)
            raise KeyError("no")

        with pytest.raises(KeyError):
            retry_with_backoff(fn, max_attempts=5, sleep=lambda s: None)
        assert len(calls) == 1
        with pytest.raises(ValueError, match="max_attempts"):
            retry_with_backoff(lambda: 0, max_attempts=0)

    def test_watchdog_flags_a_stall(self):
        stalls = []
        with StepWatchdog(timeout_s=0.05, on_stall=lambda s, e: stalls.append(s),
                          poll_s=0.01) as wd:
            wd.beat(3)
            threading.Event().wait(0.2)
        assert stalls and stalls[0] == 3 and wd.stalled_steps[0] == 3


def test_serve_select_cli_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_select", "--source",
           "corral:4000x32", "--select", "4", "--repeat", "2", "--distinct-select", "3",
           "--cache-dir", str(tmp_path / "cache"), "--device", "cpu"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, check=True,
                         timeout=300)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rep = json.loads(lines[0])
    assert rep["device"] == "cpu"
    assert [j["cache_hit"] for j in rep["jobs"]] == [False, True, False]
    assert rep["stats"]["cache"]["hits"] == 1
    assert len(os.listdir(tmp_path / "cache")) == 2
    from repro.launch.serve_select import main as jmain

    jrep = jmain(["--source", "corral:4000x32", "--select", "4", "--repeat", "2",
                  "--distinct-select", "3"])
    assert [j["selected"] for j in rep["jobs"]] == [j["selected"] for j in jrep["jobs"]]
    assert set(rep) - set(jrep) == {"device"} and set(rep["stats"]) == set(jrep["stats"])


def test_launch_counts_stay_exact_under_threads():
    """The service's workers launch kernels from several threads: each
    wrapper's ``launches`` count is added to under a lock, so no count is
    lost between threads (the card test launches the kernels themselves)."""
    from repro_torch.kernels import _build

    def wrapper():
        pass

    wrapper.launches = 0
    barrier = threading.Barrier(4)

    def work():
        barrier.wait()
        for _ in range(50_000):
            _build.count_launch(wrapper)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == 200_000
