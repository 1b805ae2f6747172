"""repro_torch's multi-host map-reduce vs the JAX package's, on the CPU.

Shard resolution (``split_range``, ``resolve_host_shards``,
``factor_host_grid``, ``factor_mesh``) equal to JAX's over an enumerated grid
of shapes, host counts and explicit grids, errors included; shard-windowed
block streams and ``ShardSource`` fingerprints bitwise JAX's; the
``HostCollectives`` reduces over a 4-process gloo group against numpy sums;
the guards; and the end-to-end launcher (``repro_torch.launch.select_multihost
--device cpu``) in the tall, wide (spill, q=2) and 4-process 2x2 ``jmi``
regimes: selections equal JAX's single-process fits, gains within
``rtol=1e-5, atol=1e-6`` of them and bitwise equal to the port's own
single-process streaming fit.

Run as a script with ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` /
``REPRO_PROCESS_ID`` set, this file is one worker of the collectives check.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.scores import MIScore as JMIScore
from repro.core.selector import MRMRSelector as JSelector
from repro.core.selector import _grid_factor as j_grid_factor
from repro.core.streaming import mrmr_streaming as jmrmr_streaming
from repro.data.binning import BinnedSource as JBinnedSource
from repro.data.sources import ArraySource as JArraySource
from repro.data.sources import CorralSource as JCorralSource
from repro.data.sources import CSVSource as JCSVSource
from repro.data.sources import NpySource as JNpySource
from repro.data.sources import ShardSource as JShardSource
from repro.dist import multihost as jmh
from repro.dist.meshes import factor_mesh as jfactor_mesh

from repro_torch import MIScore, MRMRSelector, PearsonMIScore, mrmr_streaming
from repro_torch.core import selector as tselector
from repro_torch.core.scores import ScoreFn
from repro_torch.data.binning import BinnedSource
from repro_torch.data.block_cache import BlockCacheSource
from repro_torch.data.sources import (
    ArraySource,
    CorralSource,
    CSVSource,
    DataSource,
    NpySource,
    ShardSource,
)
from repro_torch.data.synthetic import corral_dataset_np
from repro_torch.dist import multihost as tmh
from repro_torch.dist.meshes import factor_mesh

RTOL, ATOL = 1e-5, 1e-6
HERE = pathlib.Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
LAUNCH_TIMEOUT = 300  # seconds, each launcher subprocess


def _outcome(fn, *args, **kw):
    """What a call gives: its value, or its exception's type name and text."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - compared between the packages
        return (type(e).__name__, str(e))


def _spec_fields(s):
    return None if s is None else (s.num_obs, s.num_features, s.grid, s.host_id,
                                   s.obs_range, s.col_range, s.max_col_width,
                                   s.obs_coord, s.feat_coord)


# ---------------------------------------------------------------------------
# shard resolution
# ---------------------------------------------------------------------------

def test_split_range_matches_jax():
    for total in (0, 1, 7, 24, 1024, 10001):
        for parts in (1, 2, 3, 4, 7):
            for index in (-1, *range(parts), parts):
                assert (_outcome(tmh.split_range, total, parts, index)
                        == _outcome(jmh.split_range, total, parts, index))


SHAPES = [(6000, 24), (192, 1024), (5000, 5000), (1200, 1200), (10001, 24),
          (100, 10), (600, 600), (40_000, 40_000), (1_000_000, 1000),
          (10_000, 50_000), (4, 10), (30, 10), (2048, 600), (600, 2048),
          (511, 511), (3, 3), (1, 1)]
GRIDS = [None, (1, 2), (2, 1), (2, 2), (3, 1), (8, 1), (1, 3), (4, 2)]


@pytest.mark.parametrize("hosts", [1, 2, 3, 4, 6, 8])
def test_resolve_host_shards_matches_jax(hosts):
    for m, n in SHAPES:
        for grid in GRIDS:
            for host_id in (-1, 0, hosts - 1, hosts):
                t = _outcome(tmh.resolve_host_shards, m, n, hosts, host_id, grid=grid)
                j = _outcome(jmh.resolve_host_shards, m, n, hosts, host_id, grid=grid)
                assert t[0] == j[0], (m, n, hosts, host_id, grid, t, j)
                if t[0] == "ok":
                    assert _spec_fields(t[1]) == _spec_fields(j[1])
                    for c in (-1, 0, n // 2, n - 1, n):
                        assert t[1].owns_col(c) == j[1].owns_col(c)
                    flags = ("partitions_obs", "partitions_cols", "is_single_host",
                             "local_obs", "local_cols", "num_hosts")
                    assert ([getattr(t[1], f) for f in flags]
                            == [getattr(j[1], f) for f in flags])
                else:
                    assert t == j
        for m2, n2 in SHAPES:
            assert (_outcome(tmh.factor_host_grid, m2, n2, hosts)
                    == _outcome(jmh.factor_host_grid, m2, n2, hosts))


def test_factor_mesh_and_grid_rule_match_jax():
    for n_dev in range(-1, 65):
        for bias in (1e-6, 0.25, 1.0, 3.0, 100.0):
            assert (_outcome(factor_mesh, n_dev, bias=bias)
                    == _outcome(jfactor_mesh, n_dev, bias=bias))
    for m, n in SHAPES:
        for n_dev in (1, 2, 4, 6, 8, 16):
            assert tselector._grid_factor(m, n, n_dev) == j_grid_factor(m, n, n_dev)
    from repro.core import selector as jselector

    for name in ("TALL_RATIO", "WIDE_RATIO", "GRID_MIN_DIM", "GRID_MIN_DEVICES"):
        assert getattr(tselector, name) == getattr(jselector, name)


# ---------------------------------------------------------------------------
# shard-windowed block streams
# ---------------------------------------------------------------------------

WINDOWS = [(None, None), ((0, 50), (0, 12)), ((13, 88), (3, 9)),
           ((50, 101), (11, 12)), ((100, 101), None)]


def _blocks(it):
    return [(X.copy(), y.copy()) for X, y in it]


def _assert_same_blocks(t, j):
    assert len(t) == len(j)
    for (tx, ty), (jx, jy) in zip(t, j):
        assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def _int_data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 5, (101, 12)).astype(np.int32)
    y = rng.integers(0, 3, (101,)).astype(np.int32)
    return X, y


def test_array_and_npy_shard_blocks_match_jax(tmp_path):
    X, y = _int_data()
    np.save(tmp_path / "X.npy", X)
    np.save(tmp_path / "y.npy", y)
    pairs = [(ArraySource(X, y), JArraySource(X, y)),
             (NpySource(str(tmp_path / "X.npy"), str(tmp_path / "y.npy")),
              JNpySource(str(tmp_path / "X.npy"), str(tmp_path / "y.npy")))]
    for t, j in pairs:
        for bo in (7, 32, 200):
            for obs, cols in WINDOWS:
                _assert_same_blocks(_blocks(t.iter_shard_blocks(bo, obs, cols)),
                                    _blocks(j.iter_shard_blocks(bo, obs, cols)))
                Xw, yw = (np.concatenate(a) for a in zip(*t.iter_shard_blocks(bo, obs, cols)))
                np.testing.assert_array_equal(Xw, X[slice(*(obs or (0, 101))),
                                                    slice(*(cols or (0, 12)))])


def test_csv_and_corral_take_the_default_walk(tmp_path):
    X, y = _int_data(1)
    path = tmp_path / "d.csv"
    np.savetxt(path, np.column_stack([X, y]), fmt="%d", delimiter=",")
    pairs = [(CSVSource(str(path), dtype=np.int32), JCSVSource(str(path), dtype=np.int32)),
             (CorralSource(101, 12, seed=3), JCorralSource(101, 12, seed=3))]
    for t, j in pairs:
        assert type(t).iter_shard_blocks is DataSource.iter_shard_blocks
        for bo in (7, 32, 200):
            for obs, cols in WINDOWS:
                _assert_same_blocks(_blocks(t.iter_shard_blocks(bo, obs, cols)),
                                    _blocks(j.iter_shard_blocks(bo, obs, cols)))
    # The default stops past the window (it reads at most one block past
    # it): a source whose stream breaks after that still serves the window.
    class Truncated(CSVSource):
        def iter_blocks(self, block_obs):
            for i, blk in enumerate(super().iter_blocks(block_obs)):
                if i == 3:
                    raise AssertionError("read past the row window")
                yield blk

    got = _blocks(Truncated(str(path), dtype=np.int32).iter_shard_blocks(16, (3, 20), (2, 5)))
    np.testing.assert_array_equal(np.concatenate([b[0] for b in got]), X[3:20, 2:5])


def test_binned_shard_blocks_use_global_edges_like_jax():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(300, 8)).astype(np.float32)
    y = rng.integers(0, 2, (300,)).astype(np.int32)
    t = BinnedSource(ArraySource(X, y), bins=4, fit_block_obs=64)
    j = JBinnedSource(JArraySource(X, y), bins=4, fit_block_obs=64)
    full = np.concatenate([b for b, _ in t.iter_blocks(64)])
    for bo in (17, 64, 400):
        for obs, cols in [((50, 250), (2, 6)), ((0, 300), (7, 8)), (None, None)]:
            tb = _blocks(t.iter_shard_blocks(bo, obs, cols))
            _assert_same_blocks(tb, _blocks(j.iter_shard_blocks(bo, obs, cols)))
            np.testing.assert_array_equal(
                np.concatenate([b for b, _ in tb]),
                full[slice(*(obs or (0, 300))), slice(*(cols or (0, 8)))])


def test_shard_source_nests_and_fingerprints_like_jax():
    X, y = _int_data(2)
    base, jbase = ArraySource(X, y), JArraySource(X, y)
    shard = ShardSource(base, (10, 60), (2, 8))
    jshard = JShardSource(jbase, (10, 60), (2, 8))
    assert (shard.num_obs, shard.num_features) == (50, 6)
    assert shard.feature_dtype == np.int32
    _assert_same_blocks(_blocks(shard.iter_blocks(16)), _blocks(jshard.iter_blocks(16)))
    nested = _blocks(shard.iter_shard_blocks(16, (5, 25), (1, 4)))
    _assert_same_blocks(nested, _blocks(jshard.iter_shard_blocks(16, (5, 25), (1, 4))))
    np.testing.assert_array_equal(np.concatenate([b for b, _ in nested]), X[15:35, 3:6])
    deeper = ShardSource(shard, (5, 25), (1, 4))
    _assert_same_blocks(_blocks(deeper.iter_blocks(8)),
                        _blocks(JShardSource(jshard, (5, 25), (1, 4)).iter_blocks(8)))
    windows = [((10, 60), (2, 8)), ((10, 60), (0, 8)), ((0, 101), (0, 12)), ((10, 61), (2, 8))]
    prints = [ShardSource(base, o, c).fingerprint() for o, c in windows]
    assert len(set(prints) | {base.fingerprint()}) == len(windows) + 1
    assert prints == [JShardSource(jbase, o, c).fingerprint() for o, c in windows]
    for bad in [((0, 0), (0, 12)), ((0, 102), (0, 12)), ((0, 10), (5, 13))]:
        assert (_outcome(ShardSource, base, *bad)[0]
                == _outcome(JShardSource, jbase, *bad)[0] == "ValueError")


# ---------------------------------------------------------------------------
# capability flags and guards (tests/test_multihost.py's)
# ---------------------------------------------------------------------------

def test_state_merge_capability_flags():
    assert ScoreFn.supports_state_merge is False
    assert MIScore.supports_state_merge is True
    assert PearsonMIScore.supports_state_merge is False


def test_obs_partitioned_multihost_rejects_unmergeable_score():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(100, 8)).astype(np.float32)
    y = rng.integers(0, 2, (100,)).astype(np.int32)
    spec = tmh.resolve_host_shards(100, 8, 2, 0, grid=(2, 1))
    with pytest.raises(ValueError, match="supports_state_merge"):
        mrmr_streaming(ArraySource(X, y), 2, PearsonMIScore(), shards=spec, device="cpu")


def test_multihost_rejects_geometry_mismatch_and_prewrapped_cache(tmp_path):
    rng = np.random.default_rng(7)
    X = rng.integers(0, 3, (40, 12)).astype(np.int32)
    y = rng.integers(0, 2, (40,)).astype(np.int32)
    score = MIScore(num_values=3, num_classes=2)
    bad_spec = tmh.resolve_host_shards(41, 12, 2, 0, grid=(1, 2))
    with pytest.raises(ValueError, match="does not match the source"):
        mrmr_streaming(ArraySource(X, y), 2, score, shards=bad_spec, device="cpu")
    spec = tmh.resolve_host_shards(40, 12, 2, 0, grid=(1, 2))
    cached = BlockCacheSource(ArraySource(X, y), str(tmp_path))
    with pytest.raises(ValueError, match="spill_dir"):
        mrmr_streaming(cached, 2, score, shards=spec, device="cpu")
    # No process group: the collectives refuse a two-host spec.
    with pytest.raises(RuntimeError, match="init_multihost"):
        mrmr_streaming(ArraySource(X, y), 2, score, shards=spec, device="cpu")


def test_selector_hosts_validation():
    X = np.zeros((10, 4), np.int32)
    y = np.zeros((10,), np.int32)
    with pytest.raises(ValueError, match="hosts"):
        MRMRSelector(num_select=2, hosts=0, device="cpu").fit(ArraySource(X, y))
    with pytest.raises(ValueError, match="streaming"):
        MRMRSelector(num_select=2, hosts=2, device="cpu").fit(X, y)
    with pytest.raises(ValueError, match="streaming"):
        JSelector(num_select=2, hosts=2).fit(X, y)
    # A two-host fit plans and then needs its process group.
    with pytest.raises(RuntimeError, match="init_multihost"):
        MRMRSelector(num_select=2, hosts=2, device="cpu").fit(ArraySource(X, y))
    # Column-partitioned host grids refuse device feature sharding, with the
    # JAX package's message, before any collective.
    from repro.dist.meshes import make_mesh as jmake_mesh

    from repro_torch.dist.meshes import make_mesh

    spec = tmh.resolve_host_shards(10, 4, 2, 0, grid=(1, 2))
    jspec = jmh.resolve_host_shards(10, 4, 2, 0, grid=(1, 2))
    msg = r"column-partitioned multi-host fits require feat_axes=\(\) per host"
    with pytest.raises(ValueError, match=msg):
        mrmr_streaming(ArraySource(X, y), 2, MIScore(2, 2), shards=spec, device="cpu",
                       mesh=make_mesh((2,), ("model",), devices=["cpu"] * 2),
                       feat_axes=("model",))
    with pytest.raises(ValueError, match=msg):
        jmrmr_streaming(JArraySource(X, y), 2, JMIScore(2, 2), shards=jspec,
                        mesh=jmake_mesh((1,), ("model",)), feat_axes=("model",))
    # A local device mesh per host plans (then needs its process group; the
    # two-process fit is tests/test_torch_mesh.py); devices=2 on one device
    # raises JAX's error.
    with pytest.raises(RuntimeError, match="init_multihost"):
        MRMRSelector(num_select=2, hosts=2, devices=["cpu"] * 2,
                     device="cpu").fit(ArraySource(X, y))
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        MRMRSelector(num_select=2, hosts=2, devices=2, device="cpu").fit(ArraySource(X, y))
    with pytest.raises(ValueError, match="devices= instead of mesh="):
        MRMRSelector(num_select=2, hosts=2, device="cpu",
                     mesh=make_mesh((2,), ("data",), devices=["cpu"] * 2)).fit(
                         ArraySource(X, y))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MRMRSelector(num_select=2, hosts=2, device="cuda")


def test_stream_plan_carries_hosts(monkeypatch):
    X, y = corral_dataset_np(300, 16, seed=0)
    seen = {}

    def probe(source, y, *, num_select, plan):
        seen["plan"] = plan
        return tselector.get_engine("reference")(
            torch.from_numpy(source.X), torch.from_numpy(source.y).to(torch.int32),
            num_select=num_select, plan=plan)

    monkeypatch.setitem(tselector._ENGINES, "streaming", probe)
    MRMRSelector(2, score=MIScore(2, 2), hosts=3, block_obs=100, device="cpu").fit(
        ArraySource(X, y))
    plan = seen["plan"]
    assert (plan.encoding, plan.hosts, plan.block_obs) == ("streaming", 3, 100)
    MRMRSelector(2, score=MIScore(2, 2), hosts="auto", device="cpu").fit(ArraySource(X, y))
    assert seen["plan"].hosts == 1


def test_single_host_collectives_are_identity(monkeypatch):
    spec = tmh.resolve_host_shards(100, 10, 1, 0)
    monkeypatch.setattr(tmh.dist, "all_reduce", None)  # never reached
    monkeypatch.setattr(tmh, "_CONTEXT", None)
    coll = tmh.HostCollectives(spec)
    tree = dict(a=np.arange(6).reshape(2, 3))
    assert coll.psum(tree) is tree
    assert coll.psum_obs(tree) is tree
    assert coll.assemble(tree) is tree
    counts = coll.allgather_counts([5, 2**40])
    np.testing.assert_array_equal(counts, [[5, 2**40]])
    assert counts.dtype == np.int64
    assert tmh.init_multihost().num_processes == 1


# ---------------------------------------------------------------------------
# HostCollectives over a 4-process gloo group
# ---------------------------------------------------------------------------

def _state(seed, rank, width):
    rng = np.random.default_rng((seed, rank))
    return rng.integers(0, 1000, (width, 3, 2)).astype(np.int32)


def _collectives_worker() -> None:
    """One rank of the check: every reduce against numpy sums of inputs each
    rank rebuilds from seeds."""
    ctx = tmh.init_multihost(timeout=60)
    rank, H = ctx.process_id, ctx.num_processes
    assert H == 4 and tmh.init_multihost() is ctx  # idempotent

    # Tall (4, 1): psum of a mixed tree; leaves keep their form.
    coll = tmh.HostCollectives(tmh.resolve_host_shards(40, 13, 4, rank, grid=(4, 1)))
    tree = [torch.from_numpy(_state(1, rank, 13)),
            dict(m=np.full((2,), rank + 0.5), n=torch.tensor([2**40 + rank]),
                 f=np.float32(rank) * np.ones((3,), np.float32))]
    got = coll.psum(tree)
    assert isinstance(got, list) and isinstance(got[0], torch.Tensor)
    assert isinstance(got[1]["m"], np.ndarray) and got[1]["n"].dtype == torch.int64
    np.testing.assert_array_equal(got[0].numpy(), sum(_state(1, r, 13) for r in range(4)))
    np.testing.assert_array_equal(got[1]["m"], np.full((2,), 8.0))
    assert int(got[1]["n"][0]) == 4 * 2**40 + 6
    np.testing.assert_array_equal(got[1]["f"], np.full((3,), 6.0, np.float32))
    np.testing.assert_array_equal(tree[0].numpy(), _state(1, rank, 13))  # input kept
    assert coll.psum_obs(tree) is not tree  # grid[0] > 1: a real sum
    # (4, 1) assemble is the psum of the vectors.
    np.testing.assert_array_equal(coll.assemble(np.full((13,), rank, np.float32)),
                                  np.full((13,), 6, np.float32))

    # 2-D (2, 2) over 13 columns: groups 7 and 6 wide (ragged), q=2 states
    # with one appended target column, plus an unpadded scalar leaf.
    spec = tmh.resolve_host_shards(40, 13, 4, rank, grid=(2, 2))
    coll = tmh.HostCollectives(spec)
    lw = spec.local_cols + 1
    states = [torch.from_numpy(_state(2, rank, lw)), torch.from_numpy(_state(3, rank, lw)),
              torch.tensor(rank)]
    got = coll.psum_obs(states, feat_axis=0, local_width=lw, pad_to=spec.max_col_width + 1)
    peers = [r for r in range(4) if r % 2 == spec.feat_coord]
    for i, seed in enumerate((2, 3)):
        assert tuple(got[i].shape) == (lw, 3, 2)
        np.testing.assert_array_equal(got[i].numpy(), sum(_state(seed, r, lw) for r in peers))
    assert int(got[2]) == sum(peers)
    # Default widths: this host's columns padded to the widest group.
    got = coll.psum_obs([torch.from_numpy(_state(4, rank, spec.local_cols))])
    np.testing.assert_array_equal(got[0].numpy(),
                                  sum(_state(4, r, spec.local_cols) for r in peers))
    # assemble: only obs_coord 0 contributes, each column once.
    lo, hi = spec.col_range
    part = np.arange(lo, hi, dtype=np.float32) + 1000 * spec.obs_coord
    full = coll.assemble(dict(a=part, b=np.stack([part, -part])))
    np.testing.assert_array_equal(full["a"], np.arange(13, dtype=np.float32))
    np.testing.assert_array_equal(full["b"], np.stack([np.arange(13.0), -np.arange(13.0)])
                                  .astype(np.float32))

    # Wide (1, 4): assemble a (q, cols) slice; psum_obs is the identity.
    spec = tmh.resolve_host_shards(40, 13, 4, rank, grid=(1, 4))
    coll = tmh.HostCollectives(spec)
    lo, hi = spec.col_range
    tree = [np.arange(lo, hi, dtype=np.float32)]
    assert coll.psum_obs(tree) is tree
    np.testing.assert_array_equal(coll.assemble(tree)[0], np.arange(13, dtype=np.float32))

    rows = coll.allgather_counts([rank, 2**40 + rank, 3])
    assert rows.dtype == np.int64
    np.testing.assert_array_equal(rows, [[r, 2**40 + r, 3] for r in range(4)])
    print(json.dumps(dict(rank=rank, ok=True)), flush=True)
    # Leave the group together, as launch.select_multihost does: a process
    # that exits with its gloo group alive can abort in the group's teardown.
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def test_collectives_over_four_gloo_processes(tmp_path):
    # A file rendezvous: no port is picked here and bound later by another.
    procs = []
    for rank in range(4):
        env = dict(os.environ, PYTHONPATH=SRC,
                   REPRO_COORDINATOR=f"file://{tmp_path / 'rendezvous'}",
                   REPRO_NUM_PROCESSES="4", REPRO_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, __file__], env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-3000:]}\n{err[-3000:]}"
        assert json.loads(out.strip().splitlines()[-1]) == dict(rank=rank, ok=True)


# ---------------------------------------------------------------------------
# end to end: N gloo processes vs the single-process fits
# ---------------------------------------------------------------------------

def _launch(module, extra, processes=2):
    proc = subprocess.run(
        [sys.executable, "-m", module, "--num-processes", str(processes), *extra],
        capture_output=True, text=True, timeout=LAUNCH_TIMEOUT,
        env={**os.environ, "PYTHONPATH": SRC},
    )
    if proc.returncode != 0:
        pytest.fail(f"{module} failed\n--- stdout ---\n{proc.stdout[-4000:]}"
                    f"\n--- stderr ---\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port(extra, processes=2):
    return _launch("repro_torch.launch.select_multihost",
                   [*extra, "--device", "cpu", "--timeout", "120"], processes)


def _check(out, X, y, select, *, score, jscore, block_obs, grid, share, **kw):
    """The launcher's result against the port's and JAX's single-process
    streaming fits of the same data, and each host's share of the bytes."""
    port = MRMRSelector(select, score=score, block_obs=block_obs, device="cpu", **kw).fit(
        ArraySource(X, y))
    crit = kw.pop("criterion", "mid")
    jres = jmrmr_streaming(JArraySource(X, y), select, jscore, block_obs=block_obs,
                           criterion=crit, batch_candidates=kw.get("batch_candidates", 1))
    assert out["selected"] == port.selected_.tolist() == np.asarray(jres.selected).tolist()
    assert out["gains"] == [float(g) for g in port.gains_]  # bitwise
    np.testing.assert_allclose(out["gains"], np.asarray(jres.gains), rtol=RTOL, atol=ATOL)
    assert out["hosts"]["grid"] == list(grid)
    agg = out["hosts"]["aggregate"]
    for h in out["hosts"]["per_host"]:
        assert share[0] <= h["bytes_read"] / agg["bytes_read"] <= share[1]
    for w in out["workers"].values():
        assert w["device"] == "cpu" and w["host"]["grid"] == list(grid)


def test_e2e_tall_matches_single_process_and_jax_ledger():
    args = ["--rows", "6000", "--cols", "24", "--select", "4", "--block-obs", "1500"]
    out = _port(args)
    X, y = corral_dataset_np(6000, 24, seed=0)
    _check(out, X, y, 4, score=MIScore(2, 2), jscore=JMIScore(2, 2), block_obs=1500,
           grid=(2, 1), share=(0.45, 0.55))
    jout = _launch("repro.launch.select_multihost", args)
    assert jout["selected"] == out["selected"]
    assert out["hosts"] == jout["hosts"]  # per_host and aggregate, exactly
    assert out["per_host_io"] == jout["per_host_io"]


def test_e2e_wide_spill_batched_matches_single_process(tmp_path):
    spill = tmp_path / "spill"
    out = _port(["--rows", "192", "--cols", "1024", "--select", "4", "--block-obs", "64",
                 "--batch-candidates", "2", "--spill-dir", str(spill)])
    X, y = corral_dataset_np(192, 1024, seed=0)
    _check(out, X, y, 4, score=MIScore(2, 2), jscore=JMIScore(2, 2), block_obs=64,
           grid=(1, 2), share=(0.4, 0.6), batch_candidates=2)
    # One spill entry per process: shard fingerprints AND the h<i> namespace.
    entries = sorted(os.listdir(spill))
    assert len(entries) == 2
    assert {e.rsplit("-", 1)[1] for e in entries} == {"h0", "h1"}
    for w in out["workers"].values():
        assert w["cache"]["parse_passes"] == 1
        assert w["cache"]["replay_passes"] == out["hosts"]["aggregate"]["passes"] - 1


def test_e2e_2d_grid_jmi_four_processes(tmp_path):
    rng = np.random.default_rng(7)
    X = rng.integers(0, 4, (600, 600)).astype(np.int32)
    y = rng.integers(0, 3, (600,)).astype(np.int32)
    np.save(tmp_path / "X.npy", X)
    np.save(tmp_path / "y.npy", y)
    out = _port(["--input", str(tmp_path / "X.npy"), "--target", str(tmp_path / "y.npy"),
                 "--select", "3", "--block-obs", "128", "--num-values", "4",
                 "--num-classes", "3", "--criterion", "jmi"], processes=4)
    # 600 x 600 over 4 hosts: the §III rule itself resolves the 2 x 2 grid.
    assert tmh.factor_host_grid(600, 600, 4) == (2, 2)
    _check(out, X, y, 3, score=MIScore(4, 3), jscore=JMIScore(4, 3), block_obs=128,
           grid=(2, 2), share=(0.2, 0.3), criterion="jmi")
    assert out["criterion"] == "jmi"
    ranges = {(tuple(w["host"]["obs_range"]), tuple(w["host"]["col_range"]))
              for w in out["workers"].values()}
    assert ranges == {((0, 300), (0, 300)), ((0, 300), (300, 600)),
                      ((300, 600), (0, 300)), ((300, 600), (300, 600))}


def test_launcher_fails_when_a_worker_fails():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.select_multihost", "--num-processes",
         "2", "--rows", "100", "--cols", "12", "--select", "20", "--device", "cpu",
         "--timeout", "60"],
        capture_output=True, text=True, timeout=LAUNCH_TIMEOUT,
        env={**os.environ, "PYTHONPATH": SRC},
    )
    assert proc.returncode != 0
    assert "worker" in proc.stderr and "num_select" in proc.stderr
    if not torch.cuda.is_available():
        # No card: each worker raises; nothing falls back to the CPU.
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.select_multihost",
             "--num-processes", "2", "--rows", "100", "--cols", "12", "--timeout", "60"],
            capture_output=True, text=True, timeout=LAUNCH_TIMEOUT,
            env={**os.environ, "PYTHONPATH": SRC},
        )
        assert proc.returncode != 0
        assert proc.stderr.count("no CUDA device") >= 2


if __name__ == "__main__":
    _collectives_worker()
