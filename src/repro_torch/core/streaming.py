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

Every fit reports its I/O on the result: ``MRMRResult.io`` carries
``passes`` / ``blocks_read`` / ``bytes_read`` / ``state_bytes``, counted
exactly as the JAX package's streaming engine counts them, and, for a
spilled fit, ``cache``: the spill's parse and replay passes and bytes.
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
from repro_torch.data.sources import as_source
from repro_torch.device import resolve_device
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
                conditional: bool = False, binner=None, edges=None):
    """One full map-reduce pass over ``raw_pass`` (an ``(X, y)`` raw host
    block iterator): ``(N,)`` scores of every feature against the class
    (``target_cols=None``) / one column (int), or ``(q, N)`` scores against
    a batch of candidate columns (sequence of length ``q``).
    ``conditional=True`` returns ``dict(marginal=..., conditional=...)``
    instead — both terms from the one counting sweep.  ``edges`` (the
    binner's, on the device) makes the pass fused: each placed float block
    is encoded to bin codes on the device, once, before the counts."""
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

    if cond:
        terms = [score.finalize_conditional(s) for s in states]
        out = {
            k: np.stack([t[k].cpu().numpy() for t in terms]).astype(np.float32)
            for k in ("marginal", "conditional")
        }
        return {k: v[0] for k, v in out.items()} if batch is None else out
    scores = np.stack([score.finalize(s).cpu().numpy() for s in states])
    scores = scores.astype(np.float32)
    return scores[0] if batch is None else scores


def _greedy_select(run_pass, crit: Criterion, n: int, num_select: int, q: int):
    """The host-driven greedy loop: one relevance pass, then exact per-pick
    criterion folds with ``q``-wide redundancy speculation.  The fold runs
    on float32 CPU tensors, the same elementwise math the in-memory engines
    run, so argmax ties resolve identically (toward the lowest id)."""
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


@register_engine("streaming")
def _fit_streaming(source, y, *, num_select, plan) -> MRMRResult:
    del y  # targets come from the source's blocks
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
    )


__all__ = ["mrmr_streaming"]
