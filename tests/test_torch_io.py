"""The port's I/O knobs against the JAX package's: the encoded-block spill
cache (``spill_dir=``, ``spill_budget_bytes=``), cross-pass read-ahead
(``readahead=``) and their composition with batched redundancy, CSV input
and the selection service.

Both packages run the same seeded data on the CPU (the JAX side without a
mesh, on one device).  Selections, ``io`` ledgers (``cache`` included),
blocks and counters must be equal; gains and relevance within
``rtol=1e-5, atol=1e-6``.
"""

import os
import threading

import numpy as np
import pytest

from repro.core.criteria import resolve_criterion as jresolve_criterion
from repro.core.scores import MIScore as JMIScore
from repro.core.selector import MRMRSelector as JSelector
from repro.core.streaming import mrmr_streaming as jstreaming
from repro.data import sources as jsources
from repro.data.binning import BinnedSource as JBinnedSource
from repro.data.block_cache import BlockCacheSource as JBlockCacheSource
from repro.dist.streaming import CrossPassReader as JCrossPassReader
from repro.serve.selection import SelectionRequest as JSelectionRequest
from repro.serve.selection import SelectionService as JSelectionService

from repro_torch import BinnedSource, MIScore, MRMRSelector, mrmr_streaming
from repro_torch.core.criteria import resolve_criterion
from repro_torch.data import sources as tsources
from repro_torch.data.block_cache import BlockCacheSource, _narrow_int_dtype
from repro_torch.dist.streaming import CrossPassReader
from repro_torch.serve.selection import SelectionRequest, SelectionService

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def corral():
    return jsources.CorralSource(1500, 24, seed=3).materialize()


def _counting(base):
    """An ArraySource subclass of ``base``'s package that records the
    block size of every ``iter_blocks`` pass (the 'CSV parse' proxy).  The
    class name is the same in both packages, so are the fingerprints."""

    class CountingSource(base):
        def __init__(self, X, y):
            super().__init__(X, y)
            self.calls = []

        def iter_blocks(self, block_obs):
            self.calls.append(block_obs)
            return super().iter_blocks(block_obs)

    return CountingSource


TCounting = _counting(tsources.ArraySource)
JCounting = _counting(jsources.ArraySource)


def _same_fit(t, j, cache_keys=None):
    """Selections equal, gains and relevance within tolerance, the io
    ledgers equal (``cache_keys`` limits the cache comparison to those
    counters, for runs whose read-ahead thread may start a replay pass the
    fit never consumes)."""
    np.testing.assert_array_equal(t.selected.numpy(), np.asarray(j.selected))
    np.testing.assert_allclose(t.gains.numpy(), np.asarray(j.gains), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.relevance.numpy(), np.asarray(j.relevance),
                               rtol=RTOL, atol=ATOL)
    tio, jio = dict(t.io), dict(j.io)
    tcache, jcache = tio.pop("cache", None), jio.pop("cache", None)
    assert tio == jio
    if cache_keys is None:
        assert tcache == jcache
    else:
        assert {k: tcache[k] for k in cache_keys} == {k: jcache[k] for k in cache_keys}


def _stream(X, y, tmp_path, *, tsrc=None, jsrc=None, num_select=6, block_obs=300,
            spill=False, **kw):
    """The same streamed fit in both packages, each spilling (if asked) to
    its own directory."""
    tsrc = tsources.ArraySource(X, y) if tsrc is None else tsrc
    jsrc = jsources.ArraySource(X, y) if jsrc is None else jsrc
    tdir = jdir = None
    if spill:
        tdir, jdir = str(tmp_path / "t_spill"), str(tmp_path / "j_spill")
    t = mrmr_streaming(tsrc, num_select, MIScore(2, 2), block_obs=block_obs,
                       device="cpu", spill_dir=tdir, **kw)
    j = jstreaming(jsrc, num_select, JMIScore(2, 2), block_obs=block_obs,
                   spill_dir=jdir, **kw)
    return t, j


class TestSpillCache:
    def test_replay_matches_direct(self, corral, tmp_path):
        X, y = corral
        ts, js = TCounting(X, y), JCounting(X, y)
        tc = BlockCacheSource(ts, str(tmp_path / "t"))
        jc = JBlockCacheSource(js, str(tmp_path / "j"))
        t, j = _stream(X, y, tmp_path, tsrc=tc, jsrc=jc, prefetch=0)
        _same_fit(t, j)
        direct, _ = _stream(X, y, tmp_path, prefetch=0)
        np.testing.assert_array_equal(t.selected.numpy(), direct.selected.numpy())
        assert ts.calls.count(300) == js.calls.count(300) == 1
        assert tc.counters == jc.counters
        assert (tc.counters["parse_passes"], tc.counters["replay_passes"]) == (1, 5)

    def test_second_fit_never_touches_base(self, corral, tmp_path):
        X, y = corral
        for src, cache, d in ((TCounting, BlockCacheSource, "t"),
                              (JCounting, JBlockCacheSource, "j")):
            warm = cache(src(X, y), str(tmp_path / d))
            list(warm.iter_blocks(300))
        ts, js = TCounting(X, y), JCounting(X, y)
        tc = BlockCacheSource(ts, str(tmp_path / "t"))
        jc = JBlockCacheSource(js, str(tmp_path / "j"))
        t, j = _stream(X, y, tmp_path, tsrc=tc, jsrc=jc, prefetch=0)
        _same_fit(t, j)
        assert ts.calls.count(300) == js.calls.count(300) == 0
        assert t.io["cache"]["parsed_bytes"] == 0

    def test_engine_spill_dir_knob(self, corral, tmp_path):
        X, y = corral
        t, j = _stream(X, y, tmp_path, spill=True, prefetch=0)
        _same_fit(t, j)
        assert t.io["cache"]["parse_passes"] == 1
        # the same entry layout: one directory named by fingerprint x block
        assert os.listdir(tmp_path / "t_spill") == os.listdir(tmp_path / "j_spill")

    def test_block_size_keys_entries(self, corral, tmp_path):
        X, y = corral
        tc = BlockCacheSource(tsources.ArraySource(X, y), str(tmp_path / "t"))
        jc = JBlockCacheSource(jsources.ArraySource(X, y), str(tmp_path / "j"))
        for c in (tc, jc):
            list(c.iter_blocks(300))
            list(c.iter_blocks(500))
            list(c.iter_blocks(300))
        assert tc.counters == jc.counters
        assert (tc.counters["parse_passes"], tc.counters["replay_passes"]) == (2, 1)
        for b in (300, 500):
            assert tc.spilled_bytes(b) == jc.spilled_bytes(b) > 0

    def test_replayed_blocks_bitwise(self, corral, tmp_path):
        X, y = corral
        tc = BlockCacheSource(tsources.ArraySource(X, y), str(tmp_path / "t"))
        jc = JBlockCacheSource(jsources.ArraySource(X, y), str(tmp_path / "j"))
        for _ in range(2):  # the staging pass, then the memmapped replay
            for (tx, ty), (jx, jy) in zip(tc.iter_blocks(413), jc.iter_blocks(413),
                                          strict=True):
                assert (tx.dtype, ty.dtype) == (jx.dtype, jy.dtype)
                np.testing.assert_array_equal(tx, jx)
                np.testing.assert_array_equal(ty, jy)
        assert tc.counters == jc.counters

    def test_entry_written_by_jax_replays_in_the_port(self, corral, tmp_path):
        X, y = corral
        d = str(tmp_path / "shared")
        list(JBlockCacheSource(jsources.ArraySource(X, y), d).iter_blocks(300))
        tc = BlockCacheSource(tsources.ArraySource(X, y), d)
        got = list(tc.iter_blocks(300))
        assert tc.counters["parse_passes"] == 0 and tc.counters["replay_passes"] == 1
        np.testing.assert_array_equal(np.concatenate([b[0] for b in got]), X)

    def test_binned_composition(self, tmp_path):
        rng = np.random.default_rng(3)
        X = rng.normal(size=(800, 32)).astype(np.float32)
        y = (X[:, 0] + X[:, 5] > 0).astype(np.int32)
        tb = BinnedSource(tsources.ArraySource(X, y), 16, fit_block_obs=200)
        jb = JBinnedSource(jsources.ArraySource(X, y), 16, fit_block_obs=200)
        tc = BlockCacheSource(tb, str(tmp_path / "t"))
        jc = JBlockCacheSource(jb, str(tmp_path / "j"))
        assert tc.feature_dtype == jc.feature_dtype == np.int8  # 16 bins spill as int8
        for q in (4, 1):  # the staging fit, then a replaying one
            t = mrmr_streaming(tc, 5, MIScore(16, 2), block_obs=200, prefetch=0,
                               batch_candidates=q, device="cpu")
            j = jstreaming(jc, 5, JMIScore(16, 2), block_obs=200, prefetch=0,
                           batch_candidates=q)
            _same_fit(t, j)
        assert tc.spilled_bytes(200) == jc.spilled_bytes(200) < X.nbytes
        fused = mrmr_streaming(tb, 5, MIScore(16, 2), block_obs=200, prefetch=0,
                               device="cpu")
        np.testing.assert_array_equal(t.selected.numpy(), fused.selected.numpy())
        np.testing.assert_allclose(t.gains.numpy(), fused.gains.numpy(),
                                   rtol=RTOL, atol=ATOL)

    def test_truncated_chunk_detected_and_restaged(self, corral, tmp_path):
        X, y = corral
        out = {}
        for name, src_cls, cache in (("t", TCounting, BlockCacheSource),
                                     ("j", JCounting, JBlockCacheSource)):
            d = str(tmp_path / name)
            c1 = cache(src_cls(X, y), d)
            list(c1.iter_blocks(300))
            chunk = os.path.join(c1._entry_dir(300), "X00002.npy")
            with open(chunk, "r+b") as f:
                f.truncate(os.path.getsize(chunk) // 2)
            src = src_cls(X, y)
            out[name] = (cache(src, d), src)
        t, j = _stream(X, y, tmp_path, tsrc=out["t"][0], jsrc=out["j"][0], prefetch=0)
        _same_fit(t, j)
        assert out["t"][0].counters == out["j"][0].counters
        assert out["t"][0].counters["parse_passes"] == 1  # re-staged, not reused
        assert out["t"][1].calls.count(300) == out["j"][1].calls.count(300) == 1

    def test_crash_before_manifest_never_replays(self, corral, tmp_path):
        X, y = corral
        for cache, src_cls in ((BlockCacheSource, TCounting), (JBlockCacheSource, JCounting)):
            d = tmp_path / cache.__module__
            entry = d / "deadbeef-b300"
            entry.mkdir(parents=True)
            np.save(entry / "X00000.npy", X[:300])
            c = cache(src_cls(X, y), str(d))
            list(c.iter_blocks(300))
            assert c.counters["parse_passes"] == 1

    def test_lru_eviction_respects_budget(self, tmp_path):
        X1, y1 = jsources.CorralSource(600, 16, seed=1).materialize()
        X2, y2 = jsources.CorralSource(600, 16, seed=2).materialize()
        kept = {}
        for name, pkg, cache in (("t", tsources, BlockCacheSource),
                                 ("j", jsources, JBlockCacheSource)):
            d = str(tmp_path / name)
            c1 = cache(pkg.ArraySource(X1, y1), d)
            list(c1.iter_blocks(200))
            sz = c1.spilled_bytes(200)
            c2 = cache(pkg.ArraySource(X2, y2), d, budget_bytes=sz + sz // 2)
            list(c2.iter_blocks(200))
            kept[name] = (sz, c1.spilled_bytes(200), c2.spilled_bytes(200))
        assert kept["t"] == kept["j"]
        assert kept["t"][1] is None and kept["t"][2] is not None  # LRU victim, just written

    def test_guards(self, corral, tmp_path):
        X, y = corral
        src = tsources.ArraySource(X, y)
        with pytest.raises(TypeError, match="DataSource"):
            BlockCacheSource(X, str(tmp_path))
        with pytest.raises(ValueError, match="already"):
            BlockCacheSource(BlockCacheSource(src, str(tmp_path)), str(tmp_path))
        with pytest.raises(ValueError, match="budget"):
            BlockCacheSource(src, str(tmp_path), budget_bytes=0)
        with pytest.raises(ValueError, match="namespace"):
            BlockCacheSource(src, str(tmp_path), namespace="a/b")

    def test_fingerprint_delegates_like_jax(self, corral, tmp_path):
        X, y = corral
        tc = BlockCacheSource(tsources.ArraySource(X, y), str(tmp_path))
        jc = JBlockCacheSource(jsources.ArraySource(X, y), str(tmp_path))
        assert tc.fingerprint() == tsources.ArraySource(X, y).fingerprint() == jc.fingerprint()
        assert tc._entry_dir(300) == jc._entry_dir(300)
        ns = BlockCacheSource(tsources.ArraySource(X, y), str(tmp_path), namespace="h1")
        assert ns._entry_dir(300) == JBlockCacheSource(
            jsources.ArraySource(X, y), str(tmp_path), namespace="h1")._entry_dir(300)

    @pytest.mark.parametrize("bins", [2, 128, 129, 40000, 70000])
    def test_narrow_int_dtype(self, bins):
        from repro.data.block_cache import _narrow_int_dtype as jnarrow

        assert _narrow_int_dtype(bins) == jnarrow(bins)


class TestReadahead:
    def test_cross_pass_reader_replays_passes(self):
        X = np.arange(12, dtype=np.int32).reshape(6, 2)
        y = np.zeros(6, np.int32)
        got = {}
        for name, reader_cls, src in (("t", CrossPassReader, TCounting(X, y)),
                                      ("j", JCrossPassReader, JCounting(X, y))):
            reader = reader_cls(lambda s=src: s.iter_blocks(2), depth=2, max_passes=3)
            try:
                got[name] = [list(reader.next_pass()) for _ in range(3)]
                with pytest.raises(RuntimeError, match="exhausted"):
                    next(reader.next_pass())
            finally:
                reader.close()
        for tp, jp in zip(got["t"], got["j"], strict=True):
            assert len(tp) == len(jp) == 3
            np.testing.assert_array_equal(np.concatenate([b[0] for b in tp]), X)
            for (tx, ty), (jx, jy) in zip(tp, jp, strict=True):
                np.testing.assert_array_equal(tx, jx)
                np.testing.assert_array_equal(ty, jy)

    def test_reader_close_stops_thread(self):
        produced = []

        def make_pass():
            for i in range(1000):
                produced.append(i)
                yield np.zeros((2, 1), np.int8), np.zeros(2, np.int8)

        reader = CrossPassReader(make_pass, depth=1, max_passes=100)
        it = reader.next_pass()
        next(it)
        reader.close()
        assert len(produced) < 1000
        assert not any(t.name == "cross-pass-readahead" and t.is_alive()
                       for t in threading.enumerate())

    def test_reader_propagates_errors_at_their_block(self):
        def make_pass():
            yield np.zeros((2, 1), np.int8), np.zeros(2, np.int8)
            raise RuntimeError("disk died")

        reader = CrossPassReader(make_pass, depth=1, max_passes=2)
        try:
            it = reader.next_pass()
            next(it)  # the block read before the fault arrives intact
            with pytest.raises(RuntimeError, match="disk died"):
                next(it)
        finally:
            reader.close()

    def test_reader_guards(self):
        for bad in (dict(depth=0), dict(max_passes=0)):
            with pytest.raises(ValueError):
                CrossPassReader(lambda: iter(()), **bad)
            with pytest.raises(ValueError):
                JCrossPassReader(lambda: iter(()), **bad)

    @pytest.mark.parametrize("depth", [1, 3])
    def test_readahead_matches_jax(self, corral, tmp_path, depth):
        X, y = corral
        t, j = _stream(X, y, tmp_path, readahead=depth)
        _same_fit(t, j)
        assert t.io["passes"] == 6 and "cache" not in t.io

    def test_maxrel_single_pass_with_readahead(self, corral, tmp_path):
        X, y = corral
        ts, js = TCounting(X, y), JCounting(X, y)
        t, j = _stream(X, y, tmp_path, tsrc=ts, jsrc=js, num_select=4,
                       readahead=2, criterion="maxrel")
        _same_fit(t, j)
        assert t.io["passes"] == 1 and len(ts.calls) == len(js.calls) == 1

    def test_guard(self, corral):
        X, y = corral
        with pytest.raises(ValueError, match="readahead"):
            mrmr_streaming(tsources.ArraySource(X, y), 2, MIScore(2, 2),
                           readahead=-1, device="cpu")
        with pytest.raises(ValueError, match="readahead"):
            MRMRSelector(2, readahead=-1, device="cpu").fit(tsources.ArraySource(X, y))


class TestCombined:
    @pytest.mark.parametrize("block_obs", [300, 413])
    def test_all_knobs_match_jax(self, corral, tmp_path, block_obs):
        X, y = corral
        t, j = _stream(X, y, tmp_path, block_obs=block_obs, spill=True,
                       batch_candidates=4, readahead=2)
        # The read-ahead thread may start a replay pass that the batched
        # fit (fewer passes than picks) never consumes: compare the staging.
        _same_fit(t, j, cache_keys=("parse_passes", "parsed_bytes"))
        assert t.io["passes"] < 6 and t.io["cache"]["parse_passes"] == 1
        plain, _ = _stream(X, y, tmp_path, block_obs=block_obs)
        np.testing.assert_array_equal(t.selected.numpy(), plain.selected.numpy())

    @pytest.mark.parametrize("knobs", [
        dict(spill_dir=True),
        dict(spill_dir=True, spill_budget_bytes=1 << 20),
        dict(readahead=2),
        dict(spill_dir=True, spill_budget_bytes=1 << 20, readahead=3),
    ])
    def test_selector_knobs_fit_like_jax(self, corral, tmp_path, knobs):
        X, y = corral
        kw = dict(knobs)
        fits = {}
        for name, sel_cls, pkg, extra in (
            ("t", MRMRSelector, tsources, dict(device="cpu")),
            ("j", JSelector, jsources, dict(devices=1)),
        ):
            if kw.get("spill_dir"):
                kw["spill_dir"] = str(tmp_path / name)
            fits[name] = sel_cls(4, block_obs=300, **kw, **extra).fit(pkg.ArraySource(X, y))
        t, j = fits["t"], fits["j"]
        _same_fit(t.result_, j.result_)
        assert t.plan_.spill_dir == (str(tmp_path / "t") if kw.get("spill_dir") else None)
        for field in ("spill_budget_bytes", "readahead", "block_obs", "prefetch",
                      "batch_candidates"):
            assert getattr(t.plan_, field) == getattr(j.plan_, field), field

    def test_csv_pass2_bytes_zero(self, tmp_path):
        rng = np.random.default_rng(0)
        X = rng.integers(0, 2, size=(200, 8))
        y = rng.integers(0, 2, size=200)
        path = tmp_path / "data.csv"
        rows = "\n".join(",".join(map(str, list(xr) + [yi])) for xr, yi in zip(X, y))
        path.write_text(",".join(f"f{i}" for i in range(9)) + "\n" + rows + "\n")
        tsrc = tsources.CSVSource(str(path), dtype=np.int32)
        jsrc = jsources.CSVSource(str(path), dtype=np.int32)
        t, j = _stream(X, y, tmp_path, tsrc=tsrc, jsrc=jsrc, num_select=4,
                       block_obs=64, spill=True, prefetch=0)
        _same_fit(t, j)
        assert t.io["cache"]["parse_passes"] == 1
        assert t.io["cache"]["replay_passes"] == t.io["passes"] - 1
        direct, _ = _stream(X, y, tmp_path, tsrc=tsrc, jsrc=jsrc, num_select=4,
                            block_obs=64, prefetch=0)
        np.testing.assert_array_equal(t.selected.numpy(), direct.selected.numpy())


class TestServeKnobs:
    def test_cache_key_excludes_execution_knobs_like_jax(self, corral):
        X, y = corral
        keys = {}
        for name, req, pkg, score, crit in (
            ("t", SelectionRequest, tsources, MIScore(2, 2), resolve_criterion("mid")),
            ("j", JSelectionRequest, jsources, JMIScore(2, 2), jresolve_criterion("mid")),
        ):
            src = pkg.ArraySource(X, y)
            base = req(source=src, num_select=4, score=score, criterion=crit)
            variant = req(source=src, num_select=4, score=score, criterion=crit,
                          block_obs=128, prefetch=0, batch_candidates=8,
                          spill_dir="/tmp/spill", readahead=2)
            other = req(source=src, num_select=5, score=score, criterion=crit)
            keys[name] = (base.cache_key(), variant.cache_key(), other.cache_key())
        assert keys["t"] == keys["j"]
        assert keys["t"][0] == keys["t"][1] != keys["t"][2]

    def test_submit_with_knobs_coalesces(self, corral, tmp_path):
        X, y = corral
        with SelectionService(workers=1, device="cpu") as svc:
            j1 = svc.submit(tsources.ArraySource(X, y), num_select=3, score=MIScore(2, 2))
            r1 = svc.result(j1, timeout=60)
            j2 = svc.submit(tsources.ArraySource(X, y), num_select=3, score=MIScore(2, 2),
                            batch_candidates=4, spill_dir=str(tmp_path), readahead=1)
            assert svc.poll(j2).cache_hit  # same fit, other execution knobs
            r2 = svc.result(j2, timeout=60)
        with JSelectionService(workers=1) as jsvc:
            jr = jsvc.result(jsvc.submit(jsources.ArraySource(X, y), num_select=3,
                                         score=JMIScore(2, 2)), timeout=60)
        np.testing.assert_array_equal(r1.selected.numpy(), r2.selected.numpy())
        _same_fit(r1, jr)


def test_select_cli_io_knobs_like_jax(corral, tmp_path, capsys):
    from repro.launch.select import main as jmain
    from repro_torch.core.mrmr import MRMRResult
    from repro_torch.launch.select import main

    X, y = corral
    path = tmp_path / "d.csv"
    path.write_text("\n".join(",".join(map(str, list(r) + [c])) for r, c in zip(X, y)) + "\n")
    args = ["--input", str(path), "--select", "5", "--block-obs", "400",
            "--batch-candidates", "2", "--spill-budget-mb", "64", "--readahead", "0",
            "--prefetch", "0", "--incremental", "1", "--block", "32"]
    t = main(args + ["--spill-dir", str(tmp_path / "t"), "--output", str(tmp_path / "t.json"),
                     "--device", "cpu"])
    j = jmain(args + ["--spill-dir", str(tmp_path / "j"), "--output", str(tmp_path / "j.json")])
    capsys.readouterr()
    assert t["selected"] == j["selected"] and t["io"] == j["io"]
    assert t["io"]["cache"]["parse_passes"] == 1 and t["batch_candidates"] == 2
    np.testing.assert_allclose(t["gains"], j["gains"], rtol=RTOL, atol=1e-5)  # JAX rounds to 5 places
    back = MRMRResult.from_json((tmp_path / "t.json").read_text())
    assert back.selected.tolist() == t["selected"] and back.io == t["io"]
