"""Streaming mRMR — the paper's MapReduce fit over out-of-core data, on one
device.

Each scoring pass is one MapReduce job in the paper's conventional encoding:
``map`` + ``combine`` = the per-block contingency count (the contingency
kernel on the card), ``reduce`` = the int32 running sum across blocks, and
the score evaluation = the MI kernel on the summed tables.  The greedy loop
is host-driven:

    pass 0:        relevance statistics vs the class   -> rel (N,)
    pick l, then:  statistics of ALL features vs the just-selected column,
                   folded into the criterion's running state

Total I/O is ``L`` passes over the source (1 relevance + L-1 redundancy;
no pass follows the last pick) while peak device memory is
``O(block_obs × N)`` for the block plus the statistics state, independent
of ``num_obs``.  A criterion with ``needs_redundancy = False`` (``maxrel``)
runs one pass; one with ``needs_conditional_redundancy = True`` fuses the
class into each redundancy pass's target (``"feature_cond"`` state) so the
same sweep yields both ``I(x_k; x_j)`` and ``I(x_k; x_j | y)``.

``batch_candidates=q`` scores the pass's target column and the top ``q-1``
remaining candidates in the same sweep (one count per candidate per
block), committing picks from the speculated vectors — ``L-1`` redundancy
passes drop toward ``⌈(L-1)/q⌉``, with identical selections.

A :class:`~repro_torch.data.binning.BinnedSource` scored with ``MIScore``
streams FUSED: the base source's raw float blocks (cast to float32 on the
host) go to the device, where the bin-code kernel encodes each block once
ahead of the counts, so no int block is encoded on the host.  Pass targets
(the class labels, each selected column's codes) are encoded on the host,
with the same float32 ``searchsorted`` the kernel runs.  The binner's sketch
pass runs (or is reused, memoised) before the first scoring pass and is not
counted in the ledger.  Any other score on a binned source streams the
wrapper's host-encoded blocks.  Scores with a dict state
(``PearsonMIScore``'s running moments) stream the same way.

Two knobs cut the cost of the L passes over the source, with the JAX
engine's semantics:

* ``spill_dir=`` wraps the source in a
  :class:`~repro_torch.data.block_cache.BlockCacheSource` after parse and
  encode: pass 1 spills each block as ``.npy`` chunks, passes 2..L replay
  them memmapped.  A spilled ``BinnedSource`` spills its int codes (int8 for
  ``bins <= 128``), so it streams codes, not floats, and the bin-code kernel
  does not run: the staging pass encodes on the host, once.
* ``readahead=`` runs a :class:`~repro_torch.dist.streaming.CrossPassReader`
  that reads the next pass's blocks while the current pass drains (which
  blocks a pass reads never depends on the pick).

Several processes share a fit through ``shards=`` (a
:class:`~repro_torch.dist.multihost.HostShardSpec`; ``MRMRSelector(hosts=N)``
resolves it from the process rank): each reads only its row and/or column
window and one collective a pass merges the shards (see
:func:`_mrmr_streaming_multihost`).

Every fit reports its I/O on the result: ``MRMRResult.io`` carries
``passes`` / ``blocks_read`` / ``bytes_read`` / ``state_bytes``, counted
exactly as the JAX package's streaming engine counts them, and, for a
spilled fit, ``cache``: the spill's parse and replay passes and bytes; a
multi-host fit adds ``host`` (this process's grid place and windows) and
``hosts`` (every host's ledger and the aggregate).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.criteria import Criterion, resolve_criterion
from repro_torch.core.mrmr import MRMRResult, check_conditional_support
from repro_torch.core.scores import MIScore, ScoreFn
from repro_torch.core.selector import check_num_select, register_engine
from repro_torch.data.binning import BinnedSource, _as_class_labels
from repro_torch.data.block_cache import BlockCacheSource
from repro_torch.data.sources import DataSource, ShardSource, as_source
from repro_torch.device import resolve_device
from repro_torch.dist.multihost import (
    HostCollectives,
    HostShardSpec,
    process_index,
    resolve_host_shards,
)
from repro_torch.dist.streaming import (
    BlockPlacer,
    CrossPassReader,
    PrefetchPlacer,
    resolve_prefetch,
)
from repro_torch.kernels import ops

_NEG_INF = float("-inf")


def _extract_target(X_blk: np.ndarray, y_blk: np.ndarray, target_cols,
                    binner=None, cond_classes: int | None = None):
    """The pass target from one raw host block: the class (``None``), one
    feature column (int -> ``(B,)``) or a batch of candidate columns
    (sequence -> ``(q, B)``).  With a ``binner`` the block is raw float32:
    the class becomes validated int32 labels and each target column encodes
    through the same float32 ``searchsorted`` the device kernel runs, so host
    and device codes agree bitwise.  ``cond_classes`` marks a
    class-conditioned redundancy pass: each column fuses with the labels
    into one code ``col * cond_classes + label``."""
    if target_cols is None:
        return _as_class_labels(y_blk) if binner is not None else y_blk
    labels = None
    if cond_classes is not None:
        labels = (
            _as_class_labels(y_blk) if binner is not None else y_blk
        ).astype(np.int64)

    def column(c):
        c = int(c)
        col = binner.encode_column(c, X_blk[:, c]) if binner is not None else X_blk[:, c]
        if labels is None:
            return col
        return (col.astype(np.int64) * cond_classes + labels).astype(np.int32)

    if np.ndim(target_cols) == 0:
        return column(target_cols)
    return np.ascontiguousarray(np.stack([column(c) for c in target_cols]))


class _PassIO:
    """Per-fit I/O ledger: every pass/block/byte the engine consumes, plus
    the peak statistics-state footprint (``state_bytes``)."""

    def __init__(self):
        self.passes = 0
        self.blocks_read = 0
        self.bytes_read = 0
        self.state_bytes = 0

    def count(self, raw_blocks):
        for X_blk, y_blk in raw_blocks:
            self.blocks_read += 1
            self.bytes_read += X_blk.nbytes + y_blk.nbytes
            yield X_blk, y_blk

    def note_state(self, states):
        """``states``: the pass's list of per-candidate states."""
        leaves = [t for s in states for t in (s.values() if isinstance(s, dict) else [s])]
        size = sum(t.numel() * t.element_size() for t in leaves)
        self.state_bytes = max(self.state_bytes, size)

    def as_dict(self) -> dict:
        return dict(
            passes=self.passes,
            blocks_read=self.blocks_read,
            bytes_read=self.bytes_read,
            state_bytes=self.state_bytes,
        )


def _score_pass(raw_pass, score: ScoreFn, placer: BlockPlacer, target_cols,
                prefetch: int, io: _PassIO, batch: int | None = None,
                conditional: bool = False, binner=None, edges=None,
                merge_state=None, keep: int | None = None):
    """One full map-reduce pass over ``raw_pass`` (an ``(X, y)`` raw host
    block iterator): ``(N,)`` scores of every feature against the class
    (``target_cols=None``) / one column (int), or ``(q, N)`` scores against
    a batch of candidate columns (sequence of length ``q``).
    ``conditional=True`` returns ``dict(marginal=..., conditional=...)``
    instead — both terms from the one counting sweep.  ``edges`` (the
    binner's, on the device) makes the pass fused: each placed float block
    is encoded to bin codes on the device, once, before the counts.

    ``merge_state`` is the multi-host reduce hook: applied to the list of
    fully accumulated states *before* finalize (a cross-process sum of exact
    integer counts), so finalisation runs on the merged statistics as if one
    process had counted every block.  ``keep`` is how many leading feature
    rows survive (default: all; a column-partitioned host keeps its own
    columns and drops the appended target columns)."""
    io.passes += 1
    cond = conditional and target_cols is not None
    kind = (
        "class"
        if target_cols is None
        else ("feature_cond" if cond else "feature")
    )
    # One state per candidate column (one, for an unbatched pass).
    states = [placer.place_state(score.init_state(placer.num_features, kind))
              for _ in range(batch or 1)]
    io.note_state(states)
    cond_classes = score.num_classes if cond else None
    use_kernel = getattr(score, "use_kernel", "auto")

    def host_blocks():
        for X_blk, y_blk in io.count(raw_pass):
            if binner is not None or (
                X_blk.dtype.kind == "f" and X_blk.dtype != np.float32
            ):
                # Float32 on the host: the device computes in float32 anyway,
                # so the values are the same and half the bytes of float64
                # cross to the card.
                X_blk = np.asarray(X_blk, np.float32)
            yield X_blk, _extract_target(
                X_blk, y_blk, target_cols, binner, cond_classes
            )

    if prefetch > 0:
        placed = PrefetchPlacer(placer, depth=prefetch).stream(host_blocks())
    else:
        placed = (placer(X_blk, tgt) for X_blk, tgt in host_blocks())
    for X_dev, tgt, valid in placed:
        if edges is not None:
            # Padded rows encode to some code; their targets are masked.
            X_dev = ops.bin_codes(X_dev, edges, use_kernel)
        if batch is None:
            states[0] = score.accumulate(states[0], X_dev, tgt, valid)
        else:  # one count per candidate column, the block shared
            for i in range(batch):
                states[i] = score.accumulate(states[i], X_dev, tgt[i], valid)

    if merge_state is not None:
        states = merge_state(states)
    n = placer.num_features if keep is None else int(keep)
    if cond:
        terms = [score.finalize_conditional(s) for s in states]
        out = {
            k: np.stack([t[k].cpu().numpy() for t in terms]).astype(np.float32)[:, :n]
            for k in ("marginal", "conditional")
        }
        return {k: v[0] for k, v in out.items()} if batch is None else out
    scores = np.stack([score.finalize(s).cpu().numpy() for s in states])
    scores = scores.astype(np.float32)[:, :n]
    return scores[0] if batch is None else scores


def _greedy_select(run_pass, crit: Criterion, n: int, num_select: int, q: int):
    """The host-driven greedy loop shared by the single- and multi-host
    fits: one relevance pass, then exact per-pick criterion folds with
    ``q``-wide redundancy speculation.  ``run_pass(target_cols, batch=)``
    hides where blocks come from and how per-host statistics merge: every
    vector reaching this loop is the same full-width copy on every host, so
    every host commits the same pick.  The fold runs on float32 CPU tensors,
    the same elementwise math the in-memory engines run, so argmax ties
    resolve identically (toward the lowest id)."""
    rel = run_pass(None)
    rel_t = torch.from_numpy(rel)
    cstate = crit.init_state(n)
    mask = np.zeros((n,), bool)
    selected = np.full((num_select,), -1, np.int32)
    gains = np.zeros((num_select,), np.float32)
    # Speculated redundancy vectors by feature id: a pairwise property of
    # the data, valid for the whole fit once computed.
    pending: dict = {}
    for l in range(num_select):
        g = np.array(crit.objective(rel_t, cstate, l).numpy(), np.float32)
        g[mask] = _NEG_INF
        k = int(np.argmax(g))
        selected[l], gains[l] = k, g[k]
        mask[k] = True
        if l + 1 >= num_select or not crit.needs_redundancy:
            continue
        if k in pending:
            red = pending.pop(k)  # speculation hit: zero I/O
        elif q == 1:
            red = run_pass(k)
        else:
            # One sweep scores the needed column plus the top q-1 remaining
            # candidates by the current objective; a short batch repeats
            # its last column.
            cols = [k]
            for j in np.argsort(-g, kind="stable"):
                if len(cols) == q:
                    break
                j = int(j)
                if mask[j] or j in pending or g[j] == _NEG_INF:
                    continue
                cols.append(j)
            padded = cols + [cols[-1]] * (q - len(cols))
            reds = run_pass(padded, batch=q)
            for i, c in enumerate(cols):
                pending[c] = (
                    {k2: v[i] for k2, v in reds.items()}
                    if isinstance(reds, dict)
                    else reds[i]
                )
            red = pending.pop(k)
        terms = (
            {k2: torch.from_numpy(v) for k2, v in red.items()}
            if isinstance(red, dict)
            else torch.from_numpy(red)
        )
        cstate = crit.update(cstate, terms, l)
    return rel, selected, gains


def mrmr_streaming(
    source,
    num_select: int,
    score: ScoreFn,
    *,
    block_obs: int = 65536,
    device="cuda",
    prefetch="auto",
    criterion: Criterion | str = "mid",
    batch_candidates: int = 1,
    spill_dir: str | None = None,
    spill_budget_bytes: int | None = None,
    readahead: int = 0,
    shards: HostShardSpec | None = None,
    collectives: HostCollectives | None = None,
) -> MRMRResult:
    """Greedy mRMR over a :class:`~repro_torch.data.sources.DataSource`.

    Args:
      source: a ``DataSource`` (or an ``(X, y)`` pair to wrap).
      num_select: L, number of features to pick.
      score: a streaming-capable ``ScoreFn`` (``supports_streaming``).
      block_obs: observations per device block — the peak-memory knob.
      device: where blocks are counted; ``"cuda"`` raises without a card.
      prefetch: host blocks staged ahead of the device (0 = synchronous;
        ``"auto"`` = 2 on a CUDA device, 0 on the CPU).
      criterion: greedy objective, a registered name or a Criterion.
      batch_candidates: redundancy vectors speculated per pass (``q``).
      spill_dir: directory of the encoded-block spill cache
        (:class:`~repro_torch.data.block_cache.BlockCacheSource`): pass 1
        writes the parsed and encoded blocks, passes 2..L replay them
        memmapped.  ``spill_budget_bytes`` bounds the directory, least
        recently used entries first.
      readahead: raw blocks a reader thread holds ahead of the consumer,
        across pass boundaries (0 = off); when positive it takes the place
        of ``prefetch``.
      shards: a :class:`~repro_torch.dist.multihost.HostShardSpec` placing
        this process on the cross-host grid — the fit then reads ONLY this
        host's block/column ranges and merges per-pass statistics with
        explicit collectives (see :func:`_mrmr_streaming_multihost`).
        ``None`` or a single-host spec runs the one-process path.
      collectives: a pre-built :class:`~repro_torch.dist.multihost.
        HostCollectives` for ``shards`` (built on demand when omitted).
    """
    crit = resolve_criterion(criterion)
    device = resolve_device(device)
    source = as_source(*source) if isinstance(source, tuple) else as_source(source)
    if not score.supports_streaming:
        raise ValueError(
            f"{type(score).__name__} cannot stream: it has no "
            "sufficient-statistics decomposition (init_state/accumulate/"
            "finalize). Materialise the data and use an in-memory engine."
        )
    check_conditional_support(score, crit)
    needs_cond = crit.needs_redundancy and crit.needs_conditional_redundancy
    n = source.num_features
    check_num_select(num_select, n)
    prefetch = resolve_prefetch(prefetch, device)
    q = int(batch_candidates)
    if q < 1:
        raise ValueError(f"batch_candidates must be >= 1, got {q}")
    if readahead < 0:
        raise ValueError(f"readahead must be >= 0, got {readahead}")

    if shards is not None and not shards.is_single_host:
        return _mrmr_streaming_multihost(
            source, num_select, score, spec=shards, coll=collectives,
            block_obs=block_obs, device=device, prefetch=prefetch, crit=crit,
            q=q, spill_dir=spill_dir, spill_budget_bytes=spill_budget_bytes,
            readahead=readahead,
        )

    # A caller-wrapped BlockCacheSource reports its counters like one the
    # engine wraps.  The cache sits after parse and encode: a spilled
    # BinnedSource spills its codes, so the replay passes skip the encode
    # too, and the fused device encode below does not run (the codes are
    # encoded once, on the host, in the staging pass).
    spill = source if isinstance(source, BlockCacheSource) else None
    if spill_dir is not None:
        spill = source = BlockCacheSource(
            source, spill_dir, budget_bytes=spill_budget_bytes
        )

    placer = BlockPlacer(block_obs, device, num_features=n)
    # A BinnedSource scoring discrete MI streams FUSED: the base's raw float
    # blocks go to the device and are encoded there.  The sketch pass
    # (memoised by fingerprint) happens here, before the first scoring pass.
    binner = edges = None
    block_src = source
    if isinstance(source, BinnedSource) and isinstance(score, MIScore):
        binner = source.binner
        edges = placer.place_edges(binner.edges_)
        block_src = source.base
    io = _PassIO()
    reader = None
    if readahead > 0:
        # At most one pass per pick; close() stops the thread wherever the
        # fit ends (batched speculation needs fewer passes).
        reader = CrossPassReader(
            lambda: block_src.iter_blocks(placer.block_obs),
            depth=readahead,
            max_passes=num_select if crit.needs_redundancy else 1,
        )
        next_raw = reader.next_pass
        prefetch = 0  # the reader thread is the producer; stage at consume
    else:
        def next_raw():
            return block_src.iter_blocks(placer.block_obs)

    def run_pass(target_cols, batch=None):
        return _score_pass(
            next_raw(), score, placer, target_cols, prefetch, io, batch,
            conditional=needs_cond and target_cols is not None,
            binner=binner, edges=edges,
        )

    try:
        rel, selected, gains = _greedy_select(run_pass, crit, n, num_select, q)
    finally:
        if reader is not None:
            reader.close()
    io_report = io.as_dict()
    if spill is not None:
        io_report["cache"] = dict(spill.counters)
    return MRMRResult(
        selected=torch.from_numpy(selected),
        gains=torch.from_numpy(gains),
        relevance=torch.from_numpy(rel),
        criterion=crit.name,
        engine="streaming",
        io=io_report,
    )


def _mrmr_streaming_multihost(
    source: DataSource,
    num_select: int,
    score: ScoreFn,
    *,
    spec: HostShardSpec,
    coll: HostCollectives | None,
    block_obs: int,
    device: torch.device,
    prefetch: int,
    crit: Criterion,
    q: int,
    spill_dir: str | None,
    spill_budget_bytes: int | None,
    readahead: int,
) -> MRMRResult:
    """The cross-host fit: this process reads ONLY its shard, the per-pass
    reduce is an explicit collective, and every host runs the same greedy
    loop on the same merged vectors.

    The paper's two partitionings map onto the host grid:

    * **tall** (``grid=(H, 1)``): each host streams its row window at full
      width into a full-width state; one ``psum`` of the exact integer counts
      rebuilds the global state bitwise on every host before finalize, so
      scores (hence picks) equal one process having read everything.
    * **wide** (``grid=(1, H)``): each host streams every row of its own
      column group; states never merge.  Finalised per-column scores
      ``assemble`` into the full ``(N,)`` vector (one non-zero addend per
      column: float adds against zeros, exact).  Redundancy targets a host
      does not own ride as *appended columns*: a synchronous single-column
      shard stream aligned block for block with the main stream, so the
      augmented state is ``local_cols + t`` wide and the targets sit at
      local indices ``local_cols..local_cols+t-1``.
    * **2-D grid**: both — ``psum_obs`` collapses the row partitions (column
      groups padded to the widest; zeros change no sum), then the
      ``obs_coord == 0`` row of hosts assembles.

    Each process places its blocks on its one ``device``; the placer's width
    is the exact shard width, which makes cross-host state shapes align.
    """
    n = source.num_features
    if (spec.num_obs, spec.num_features) != (source.num_obs, n):
        raise ValueError(
            f"HostShardSpec geometry {(spec.num_obs, spec.num_features)} "
            f"does not match the source {(source.num_obs, n)}"
        )
    if spec.partitions_obs and not score.supports_state_merge:
        raise ValueError(
            f"{type(score).__name__} statistics cannot merge across row "
            "partitions (supports_state_merge=False): its state is not a "
            "plain sum over blocks.  Use an MI score, or a column-only "
            "host grid (grid=(1, H)) where no state merge is needed."
        )
    if isinstance(source, BlockCacheSource):
        raise ValueError(
            "pass spill_dir= instead of a pre-wrapped BlockCacheSource: "
            "multi-host fits spill per-host shard streams under a "
            "process-namespaced entry"
        )
    if coll is None:
        coll = HostCollectives(spec)
    needs_cond = crit.needs_redundancy and crit.needs_conditional_redundancy
    clo = spec.col_range[0]
    n_local = spec.local_cols

    # Each host's block stream covers ONLY its row/column windows.  A spill
    # caches the shard stream under a per-process namespace, so hosts
    # sharing one filesystem never race each other's chunks.
    shard_src = ShardSource(source, spec.obs_range, spec.col_range)
    stream_src: DataSource = shard_src
    spill: BlockCacheSource | None = None
    if spill_dir is not None:
        spill = stream_src = BlockCacheSource(
            shard_src, spill_dir, budget_bytes=spill_budget_bytes,
            namespace=f"h{spec.host_id}",
        )

    # Tall hosts hold every column; column-partitioned hosts size their
    # placer (and state) to the exact shard width, plus appended targets.
    placer_rel = BlockPlacer(
        block_obs, device, num_features=n_local if spec.partitions_cols else n
    )
    eff_bo = placer_rel.block_obs
    red_placers: dict = {}

    def red_placer(aug: int) -> BlockPlacer:
        if aug not in red_placers:
            red_placers[aug] = BlockPlacer(block_obs, device, num_features=n_local + aug)
        return red_placers[aug]

    def aug_blocks(raw, cols):
        """Append each target column's values for this host's row window to
        every raw block: owned columns slice out of the block itself,
        non-owned ones ride a synchronous single-column shard stream off the
        base source (same ``eff_bo``, same row window — aligned block for
        block by construction, and checked)."""
        plans, streams = [], []
        try:
            for c in cols:
                c = int(c)
                if spec.owns_col(c):
                    plans.append(("own", c - clo))
                else:
                    it = source.iter_shard_blocks(eff_bo, spec.obs_range, (c, c + 1))
                    plans.append(("stream", it))
                    streams.append(it)
            for X_blk, y_blk in raw:
                X_blk = np.asarray(X_blk)
                extra = []
                for kind, v in plans:
                    if kind == "own":
                        extra.append(X_blk[:, v : v + 1])
                        continue
                    Xc, _ = next(v)
                    if Xc.shape[0] != X_blk.shape[0]:
                        raise RuntimeError(
                            "target-column stream misaligned with the shard "
                            f"stream ({Xc.shape[0]} vs {X_blk.shape[0]} rows)"
                        )
                    extra.append(np.asarray(Xc))
                yield np.concatenate([X_blk] + extra, axis=1), y_blk
        finally:
            for it in streams:
                it.close()

    io = _PassIO()
    reader = None
    if readahead > 0:
        reader = CrossPassReader(
            lambda: stream_src.iter_blocks(eff_bo),
            depth=readahead,
            max_passes=num_select if crit.needs_redundancy else 1,
        )
        next_raw = reader.next_pass
        prefetch = 0
    else:
        def next_raw():
            return stream_src.iter_blocks(eff_bo)

    def run_pass(target_cols, batch=None):
        cond = needs_cond and target_cols is not None
        if target_cols is None or not spec.partitions_cols:
            # Relevance everywhere, and tall-regime redundancy: every column
            # is local, so global target ids index the block.
            placer, raw, local_targets, aug = placer_rel, next_raw(), target_cols, 0
        else:
            cols = [int(target_cols)] if batch is None else [int(c) for c in target_cols]
            aug = len(cols)
            placer = red_placer(aug)
            local_targets = (
                n_local if batch is None else list(range(n_local, n_local + aug))
            )
            raw = aug_blocks(next_raw(), cols)
        merge = None
        if spec.partitions_obs:
            if not spec.partitions_cols:
                merge = coll.psum
            else:
                # The pass keeps a list of q states, each (width, V, ·):
                # every state pads on its feature axis 0.
                lw, pt = n_local + aug, spec.max_col_width + aug

                def merge(states):
                    return coll.psum_obs(states, feat_axis=0, local_width=lw, pad_to=pt)
        res = _score_pass(
            raw, score, placer, local_targets, prefetch, io, batch,
            conditional=cond, merge_state=merge,
            keep=n_local if spec.partitions_cols else n,
        )
        return coll.assemble(res) if spec.partitions_cols else res

    try:
        rel, selected, gains = _greedy_select(run_pass, crit, n, num_select, q)
    finally:
        if reader is not None:
            reader.close()
    io_report = io.as_dict()
    if spill is not None:
        io_report["cache"] = dict(spill.counters)
    io_report["host"] = dict(
        id=spec.host_id,
        grid=list(spec.grid),
        obs_range=list(spec.obs_range),
        col_range=list(spec.col_range),
    )
    # The exact cross-host ledger: per-host rows plus the cluster aggregate.
    names = ("passes", "blocks_read", "bytes_read", "state_bytes")
    per = coll.allgather_counts([getattr(io, k) for k in names])
    io_report["hosts"] = dict(
        grid=list(spec.grid),
        per_host=[{k: int(v) for k, v in zip(names, row)} for row in per],
        aggregate=dict(
            # Passes run in lockstep (max == every host); the rest sum.
            passes=int(per[:, 0].max()),
            blocks_read=int(per[:, 1].sum()),
            bytes_read=int(per[:, 2].sum()),
            state_bytes=int(per[:, 3].sum()),
        ),
    )
    return MRMRResult(
        selected=torch.from_numpy(selected),
        gains=torch.from_numpy(gains),
        relevance=torch.from_numpy(rel),
        criterion=crit.name,
        engine="streaming",
        io=io_report,
    )


@register_engine("streaming")
def _fit_streaming(source, y, *, num_select, plan) -> MRMRResult:
    del y  # targets come from the source's blocks
    shards = None
    if plan.hosts > 1:
        shards = resolve_host_shards(
            source.num_obs, source.num_features, plan.hosts, process_index(),
        )
    return mrmr_streaming(
        source,
        num_select,
        plan.score,
        block_obs=plan.block_obs,
        device=plan.device,
        prefetch=plan.prefetch,
        criterion=plan.criterion,
        batch_candidates=plan.batch_candidates,
        spill_dir=plan.spill_dir,
        spill_budget_bytes=plan.spill_budget_bytes,
        readahead=plan.readahead,
        shards=shards,
    )


__all__ = ["mrmr_streaming"]
