"""The port's file sources against the JAX package's: ``CSVSource``,
``ParquetSource`` and ``ArrowSource`` must yield the same blocks bitwise
(values, dtypes, block boundaries) for every ``block_obs``, with the same
geometry and fingerprints, and fit the same selection.
"""

import sys

import numpy as np
import pytest

from repro.core.scores import MIScore as JMIScore
from repro.core.streaming import mrmr_streaming as jstreaming
from repro.data import sources as jsources

from repro_torch import MIScore, mrmr_streaming
from repro_torch.data import sources as tsources

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
BLOCKS = [1, 7, 64, 999, 5000]


@pytest.fixture(scope="module")
def corral():
    return jsources.CorralSource(1200, 12, seed=5).materialize()


def _same_blocks(t, j, block_obs):
    tb, jb = list(t.iter_blocks(block_obs)), list(j.iter_blocks(block_obs))
    assert len(tb) == len(jb) > 0
    for (tx, ty), (jx, jy) in zip(tb, jb):
        assert (tx.dtype, ty.dtype, tx.shape, ty.shape) == (jx.dtype, jy.dtype, jx.shape, jy.shape)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    assert (t.num_obs, t.num_features, t.feature_dtype) == (
        j.num_obs, j.num_features, j.feature_dtype)
    assert t.fingerprint() == j.fingerprint()


def _write_csv(path, X, y, *, header=True, blank_every=0, delimiter=",", target_first=False):
    lines = []
    if header:
        names = [f"f{i}" for i in range(X.shape[1])]
        lines.append(delimiter.join(["label"] + names if target_first else names + ["label"]))
    for i, (xr, yi) in enumerate(zip(X, y)):
        fields = [str(v) for v in xr]
        fields = [str(yi)] + fields if target_first else fields + [str(yi)]
        lines.append(delimiter.join(fields))
        if blank_every and i % blank_every == 0:
            lines.extend(["", "   "])  # blank runs never truncate the stream
    path.write_text("\n".join(lines) + "\n")
    return str(path)


class TestCSV:
    @pytest.mark.parametrize("block_obs", BLOCKS)
    def test_header_blocks_bitwise(self, corral, tmp_path, block_obs):
        X, y = corral
        p = _write_csv(tmp_path / "d.csv", X, y)
        kw = dict(dtype=np.int8, target_dtype=np.int8)
        _same_blocks(tsources.CSVSource(p, **kw), jsources.CSVSource(p, **kw), block_obs)

    @pytest.mark.parametrize("block_obs", [13, 500])
    def test_no_header_blank_lines_bitwise(self, corral, tmp_path, block_obs):
        X, y = corral
        p = _write_csv(tmp_path / "d.csv", X, y, header=False, blank_every=97)
        t, j = tsources.CSVSource(p, dtype=np.int32), jsources.CSVSource(p, dtype=np.int32)
        _same_blocks(t, j, block_obs)
        assert t.num_obs == X.shape[0]

    def test_target_col_and_delimiter_bitwise(self, corral, tmp_path):
        X, y = corral
        p = _write_csv(tmp_path / "d.tsv", X, y, delimiter="\t", target_first=True)
        kw = dict(target_col=0, delimiter="\t", dtype=np.int16, target_dtype=np.int32)
        t, j = tsources.CSVSource(p, **kw), jsources.CSVSource(p, **kw)
        _same_blocks(t, j, 256)
        Xm, ym = t.materialize()
        np.testing.assert_array_equal(Xm, X)
        np.testing.assert_array_equal(ym, y)

    def test_float_values_bitwise(self, tmp_path):
        rng = np.random.default_rng(4)
        X = rng.normal(size=(300, 5)).round(6)
        y = rng.integers(0, 3, 300)
        p = _write_csv(tmp_path / "f.csv", X, y)
        _same_blocks(tsources.CSVSource(p), jsources.CSVSource(p), 64)

    def test_parse_knobs_in_identity_like_jax(self, tmp_path):
        p = str(tmp_path / "d.csv")
        with open(p, "w") as f:
            f.write("1,0,1\n0,1,0\n")
        variants = [dict(dtype=np.int32), dict(dtype=np.int32, target_col=0),
                    dict(dtype=np.float32), dict(dtype=np.int32, delimiter=";")]
        tfps = [tsources.CSVSource(p, **kw).fingerprint() for kw in variants]
        jfps = [jsources.CSVSource(p, **kw).fingerprint() for kw in variants]
        assert tfps == jfps and len(set(tfps)) == len(tfps)

    def test_empty_csv_raises(self, tmp_path):
        p = tmp_path / "empty.csv"
        p.write_text("")
        with pytest.raises(ValueError, match="empty CSV"):
            tsources.CSVSource(str(p))

    def test_streamed_fit_like_jax(self, corral, tmp_path):
        X, y = corral
        p = _write_csv(tmp_path / "d.csv", X, y)
        kw = dict(dtype=np.int8, target_dtype=np.int8)
        t = mrmr_streaming(tsources.CSVSource(p, **kw), 5, MIScore(2, 2), block_obs=250,
                           device="cpu")
        j = jstreaming(jsources.CSVSource(p, **kw), 5, JMIScore(2, 2), block_obs=250)
        np.testing.assert_array_equal(t.selected.numpy(), np.asarray(j.selected))
        np.testing.assert_allclose(t.gains.numpy(), np.asarray(j.gains), rtol=RTOL, atol=ATOL)
        assert t.io == j.io


def _table(X, y, target_name="label"):
    cols = {f"f{j}": X[:, j] for j in range(X.shape[1])}
    cols[target_name] = y
    return pa.table(cols)


class TestParquet:
    @pytest.mark.parametrize("block_obs", BLOCKS)
    def test_blocks_bitwise_across_row_groups(self, corral, tmp_path, block_obs):
        X, y = corral
        p = str(tmp_path / "d.parquet")
        pq.write_table(_table(X.astype(np.int32), y), p, row_group_size=100)
        _same_blocks(tsources.ParquetSource(p), jsources.ParquetSource(p), block_obs)

    def test_float_schema_and_named_target_bitwise(self, tmp_path):
        rng = np.random.default_rng(5)
        X = rng.normal(size=(700, 10)).astype(np.float32)
        y = (X[:, 1] + X[:, 6] > 0).astype(np.int32)
        p = str(tmp_path / "f.parquet")
        tbl = _table(X, y)
        pq.write_table(tbl.select(["label"] + [f"f{j}" for j in range(10)]), p)
        t = tsources.ParquetSource(p, target_col="label")
        j = jsources.ParquetSource(p, target_col="label")
        assert t.feature_dtype == np.float32 and t.target_dtype == np.int32
        _same_blocks(t, j, 128)

    @pytest.mark.parametrize("kw", [dict(), dict(target_col="f0"), dict(dtype=np.float32),
                                    dict(target_dtype=np.int64)])
    def test_fingerprint_tracks_knobs_like_jax(self, corral, tmp_path, kw):
        X, y = corral
        p = str(tmp_path / "d.parquet")
        pq.write_table(_table(X, y), p)
        assert tsources.ParquetSource(p, **kw).fingerprint() == \
            jsources.ParquetSource(p, **kw).fingerprint()

    def test_missing_target_raises(self, corral, tmp_path):
        X, y = corral
        p = str(tmp_path / "d.parquet")
        pq.write_table(_table(X, y), p)
        with pytest.raises(ValueError, match="nope"):
            tsources.ParquetSource(p, target_col="nope")

    def test_without_pyarrow_the_error_names_it(self, corral, tmp_path, monkeypatch):
        X, y = corral
        p = str(tmp_path / "d.parquet")
        pq.write_table(_table(X, y), p)
        monkeypatch.setitem(sys.modules, "pyarrow", None)
        monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
        msgs = []
        for pkg in (tsources, jsources):
            with pytest.raises(ImportError, match="requires pyarrow") as exc:
                pkg.ParquetSource(p)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


class TestArrow:
    @pytest.mark.parametrize("block_obs", BLOCKS)
    def test_table_blocks_bitwise(self, corral, block_obs):
        X, y = corral
        tbl = _table(X, y)
        _same_blocks(tsources.ArrowSource(tbl), jsources.ArrowSource(tbl), block_obs)

    def test_record_batch_and_dtypes_bitwise(self, corral):
        X, y = corral
        batch = _table(X, y).to_batches()[0]
        kw = dict(target_col="label", dtype=np.int16, target_dtype=np.int8)
        t, j = tsources.ArrowSource(batch, **kw), jsources.ArrowSource(batch, **kw)
        _same_blocks(t, j, 333)
        Xm, ym = t.materialize()
        np.testing.assert_array_equal(Xm, X)
        np.testing.assert_array_equal(ym, y)

    def test_only_target_raises(self):
        with pytest.raises(ValueError, match="only the target"):
            tsources.ArrowSource(pa.table({"label": np.zeros(4, np.int32)}))

    def test_fit_like_jax(self, corral):
        X, y = corral
        tbl = _table(X, y)
        t = mrmr_streaming(tsources.ArrowSource(tbl), 5, MIScore(2, 2), block_obs=400,
                           device="cpu", criterion="cmim")
        j = jstreaming(jsources.ArrowSource(tbl), 5, JMIScore(2, 2), block_obs=400,
                       criterion="cmim")
        np.testing.assert_array_equal(t.selected.numpy(), np.asarray(j.selected))
        np.testing.assert_allclose(t.gains.numpy(), np.asarray(j.gains), rtol=RTOL, atol=ATOL)
        assert t.io == j.io
