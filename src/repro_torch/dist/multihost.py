"""Multi-host map-reduce — each host reads only its shard.

The paper's headline is cluster scale: observations or features spread over
MapReduce workers, each reading only its partition, with one reduce per pass
merging the per-partition sufficient statistics.  This module is that layer
for the streaming engine, on ``torch.distributed``:

* :func:`init_multihost` — joins a process group (explicit arguments or the
  ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID``
  environment variables) over gloo, with a timeout, so a lost peer fails
  instead of hanging.
* :class:`HostShardSpec` / :func:`resolve_host_shards` — the paper's §III
  sharding rule applied across hosts: tall fits partition the observation
  range, wide fits the column range, both-large gets the 2-D (obs × feat)
  host grid.  Each host's block walk covers only its own ranges
  (:meth:`repro_torch.data.sources.DataSource.iter_shard_blocks`).
* :class:`HostCollectives` — the per-pass reduce as explicit collectives on
  CPU tensors: ``psum`` over every host (the tall regime's exact integer
  count sums), ``psum_obs`` over the hosts of one column group (the 2-D
  grid's merge, one subgroup per column group), ``assemble`` (each column
  group's finalised slice scattered into the full vector and summed) and
  ``allgather_counts`` (the exact per-host I/O ledger).

After the reduce every host holds identical full-width vectors, folds the
criterion identically and commits the identical pick: a map-reduce with no
designated master.  Device tensors go to the host for a collective and come
back to their device, so N processes may share one card (each with its own
CUDA context); gloo carries every reduce.

The §III thresholds are borrowed lazily from :mod:`repro_torch.core.selector`
inside :func:`resolve_host_shards` (the selector imports this package), so
the device and host planners apply one rule.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.meshes import factor_mesh

# ---------------------------------------------------------------------------
# bootstrap
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MultihostContext:
    """What :func:`init_multihost` resolved: this process's place in the
    cluster (``num_processes == 1`` means single-process, no collectives)."""

    process_id: int
    num_processes: int
    coordinator: str | None


_CONTEXT: MultihostContext | None = None


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the process group, 0 when there is none."""
    return dist.get_rank() if _group_up() else 0


def process_count() -> int:
    """The process group's size, 1 when there is none."""
    return dist.get_world_size() if _group_up() else 1


def init_multihost(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    timeout: float = 600.0,
) -> MultihostContext:
    """Join (or skip joining) a ``torch.distributed`` process group —
    idempotent.

    Arguments default from the environment — ``REPRO_COORDINATOR`` (e.g.
    ``"10.0.0.1:12355"``, process 0's rendezvous address), ``REPRO_NUM_PROCESSES``,
    ``REPRO_PROCESS_ID`` — so launchers configure workers without flags.  With
    no coordinator (or ``num_processes <= 1``) this joins nothing and returns
    a single-process context: the same selection code runs unsharded.

    The group's backend is gloo: the collectives reduce CPU tensors (and NCCL
    would refuse two ranks on one card).  ``timeout`` (seconds) bounds the
    rendezvous and every collective, so a peer that died fails its partners
    instead of hanging them.  A group a launcher already set up is verified
    and adopted.
    """
    global _CONTEXT
    if _CONTEXT is not None:
        return _CONTEXT
    coordinator = coordinator or os.environ.get("REPRO_COORDINATOR") or None
    if num_processes is None:
        num_processes = _env_int("REPRO_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("REPRO_PROCESS_ID")
    if coordinator is None or (num_processes or 1) <= 1:
        _CONTEXT = MultihostContext(process_index(), process_count(), None)
        return _CONTEXT
    if num_processes is None or process_id is None:
        raise ValueError(
            "multi-host init needs all three of coordinator, num_processes "
            f"and process_id (got coordinator={coordinator!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r})"
        )
    if not _group_up():
        address = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(
            "gloo",
            init_method=address,
            world_size=int(num_processes),
            rank=int(process_id),
            timeout=datetime.timedelta(seconds=float(timeout)),
        )
    if dist.get_world_size() != int(num_processes):
        raise RuntimeError(
            f"torch.distributed reports {dist.get_world_size()} processes, "
            f"expected {num_processes}"
        )
    _CONTEXT = MultihostContext(dist.get_rank(), dist.get_world_size(), coordinator)
    return _CONTEXT


# ---------------------------------------------------------------------------
# shard resolution — the §III rule across hosts
# ---------------------------------------------------------------------------

def split_range(total: int, parts: int, index: int) -> tuple[int, int]:
    """Balanced contiguous split of ``range(total)`` into ``parts``: the
    first ``total % parts`` shards get one extra element, so shard sizes
    never differ by more than one."""
    if not 0 <= index < parts:
        raise ValueError(f"index {index} out of range for {parts} parts")
    base, extra = divmod(int(total), int(parts))
    lo = index * base + min(index, extra)
    return lo, lo + base + (1 if index < extra else 0)


@dataclasses.dataclass(frozen=True)
class HostShardSpec:
    """One host's slice of the dataset under the §III host grid.

    ``grid = (obs_hosts, feat_hosts)`` with hosts laid out row-major: host
    ``i`` sits at ``(i // feat_hosts, i % feat_hosts)``, the order in which
    :class:`HostCollectives` builds its column-group subgroups, so shard
    ranges and reduce groups always agree.
    """

    num_obs: int
    num_features: int
    grid: tuple          # (obs_hosts, feat_hosts)
    host_id: int
    obs_range: tuple     # [lo, hi) rows this host reads
    col_range: tuple     # [lo, hi) columns this host reads

    @property
    def num_hosts(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def obs_coord(self) -> int:
        return self.host_id // self.grid[1]

    @property
    def feat_coord(self) -> int:
        return self.host_id % self.grid[1]

    @property
    def local_obs(self) -> int:
        return self.obs_range[1] - self.obs_range[0]

    @property
    def local_cols(self) -> int:
        return self.col_range[1] - self.col_range[0]

    @property
    def partitions_obs(self) -> bool:
        return self.grid[0] > 1

    @property
    def partitions_cols(self) -> bool:
        return self.grid[1] > 1

    @property
    def is_single_host(self) -> bool:
        return self.num_hosts == 1

    @property
    def max_col_width(self) -> int:
        """Widest column group (group 0 under the balanced split): the
        common padded width for cross-group state collectives."""
        lo, hi = split_range(self.num_features, self.grid[1], 0)
        return hi - lo

    def owns_col(self, c: int) -> bool:
        return self.col_range[0] <= int(c) < self.col_range[1]


def resolve_host_shards(
    num_obs: int,
    num_features: int,
    num_hosts: int,
    host_id: int,
    *,
    grid: tuple | None = None,
) -> HostShardSpec:
    """The §III sharding rule applied to hosts: tall partitions the
    observation range, wide partitions the column range, both-large gets the
    aspect-biased 2-D factorisation (the selector's own constants).
    ``grid=(oh, fh)`` overrides the rule.  ``num_hosts == 1`` degenerates to
    the full ranges (the single-process path)."""
    m, n = int(num_obs), int(num_features)
    H = int(num_hosts)
    if H < 1:
        raise ValueError(f"num_hosts must be >= 1, got {H}")
    if not 0 <= int(host_id) < H:
        raise ValueError(f"host_id {host_id} out of range for {H} hosts")
    if grid is not None:
        oh, fh = int(grid[0]), int(grid[1])
        if oh * fh != H:
            raise ValueError(f"grid {grid} does not factor {H} hosts")
    elif H == 1:
        oh, fh = 1, 1
    else:
        # Borrowed lazily: the selector imports this package.
        from repro_torch.core.selector import TALL_RATIO, WIDE_RATIO, _grid_factor

        aspect = m / max(n, 1)
        if aspect >= TALL_RATIO:
            oh, fh = H, 1
        elif aspect <= WIDE_RATIO:
            oh, fh = 1, H
        else:
            gf = _grid_factor(m, n, H)
            if gf is not None:
                oh, fh = gf
            elif aspect >= 1.0:
                oh, fh = H, 1
            else:
                oh, fh = 1, H
    if oh > max(m, 1) or fh > max(n, 1):
        raise ValueError(
            f"host grid ({oh}, {fh}) over-partitions a {m}x{n} dataset: "
            "some hosts would hold an empty shard; use fewer hosts or an "
            "explicit grid="
        )
    oc, fc = int(host_id) // fh, int(host_id) % fh
    return HostShardSpec(
        num_obs=m,
        num_features=n,
        grid=(oh, fh),
        host_id=int(host_id),
        obs_range=split_range(m, oh, oc),
        col_range=split_range(n, fh, fc),
    )


def factor_host_grid(num_obs: int, num_features: int, num_hosts: int) -> tuple:
    """The (obs_hosts, feat_hosts) factorisation ``resolve_host_shards``
    would pick — exposed for planners and tests."""
    return resolve_host_shards(num_obs, num_features, num_hosts, 0).grid


# ---------------------------------------------------------------------------
# explicit cross-host collectives
# ---------------------------------------------------------------------------

def _flatten(tree):
    """Leaves of a nest of dicts, lists and tuples (arrays or tensors at the
    leaves) and a function that rebuilds the nest from new leaves."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(t) for t in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(new):
        out, off = [], 0
        for (_, fn), k in zip(parts, sizes):
            out.append(fn(new[off:off + k]))
            off += k
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


def _host_tensor(leaf) -> torch.Tensor:
    """A leaf as a CPU tensor (a copy for CPU leaves is made by the merge)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(leaf))


def _like(merged: torch.Tensor, leaf):
    """The merged CPU tensor returned in the leaf's own form: a tensor on
    the leaf's device, or a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return merged.to(leaf.device)
    return merged.numpy()


class HostCollectives:
    """The per-pass reduce: explicit ``torch.distributed`` collectives.

    Built once per fit from a :class:`HostShardSpec`.  Every merge runs on
    CPU tensors over the default (gloo) group, or, for :meth:`psum_obs` on a
    2-D grid, over the subgroup of the hosts in this host's column group;
    the subgroups are created here, every rank creating every group in the
    same order.  Leaves of one dtype ride in one buffer, so a merge is one
    collective per dtype.  A single-host spec short-circuits every method to
    the identity and never touches ``torch.distributed``.
    """

    def __init__(self, spec: HostShardSpec):
        self.spec = spec
        self._obs_group = None  # the hosts of this column group (None: all)
        if spec.is_single_host:
            return
        if process_count() != spec.num_hosts:
            raise RuntimeError(
                f"HostShardSpec wants {spec.num_hosts} hosts but "
                f"torch.distributed reports {process_count()} processes; "
                "call init_multihost() first"
            )
        if dist.get_rank() != spec.host_id:
            raise RuntimeError(
                f"HostShardSpec is host {spec.host_id}'s but this process is "
                f"rank {dist.get_rank()}"
            )
        oh, fh = spec.grid
        if oh > 1 and fh > 1:
            for fc in range(fh):
                group = dist.new_group([oc * fh + fc for oc in range(oh)])
                if fc == spec.feat_coord:
                    self._obs_group = group

    # -- plumbing --------------------------------------------------------

    def _merged(self, leaves: list, group=None, op=None) -> list:
        """Reduce every leaf over the group's hosts (``op``: sum unless
        given); CPU tensors out."""
        host = [_host_tensor(leaf) for leaf in leaves]
        by_dtype: dict = {}
        for i, t in enumerate(host):
            by_dtype.setdefault(t.dtype, []).append(i)
        out: list = [None] * len(host)
        for idx in by_dtype.values():
            flat = torch.cat([host[i].reshape(-1) for i in idx])  # a copy
            dist.all_reduce(flat, op=dist.ReduceOp.SUM if op is None else op, group=group)
            off = 0
            for i in idx:
                k = host[i].numel()
                out[i] = flat[off:off + k].view(host[i].shape)
                off += k
        return out

    def _tree_merge(self, tree, group=None, op=None):
        leaves, rebuild = _flatten(tree)
        merged = self._merged(leaves, group, op)
        return rebuild([_like(m, leaf) for m, leaf in zip(merged, leaves)])

    # -- the three reduces ----------------------------------------------

    def psum(self, tree):
        """Sum a tree over EVERY host — the tall regime's state merge.
        Contingency counts are exact integers, so the merged statistics (and
        everything finalised from them) are bitwise those of one process
        that saw every block."""
        if self.spec.is_single_host:
            return tree
        return self._tree_merge(tree)

    def pmax(self, tree):
        """Elementwise maximum of a tree over EVERY host (the compressed
        gradient sum's shared scales)."""
        if self.spec.is_single_host:
            return tree
        return self._tree_merge(tree, op=dist.ReduceOp.MAX)

    def psum_obs(
        self,
        tree,
        feat_axis: int = 0,
        local_width: int | None = None,
        pad_to: int | None = None,
    ):
        """Sum over the observation hosts of this column group only — the
        2-D grid's state merge: per-pair statistics stay column-sharded while
        row partitions collapse.  Column groups may differ in width under a
        ragged split, so leaves whose ``feat_axis`` is exactly
        ``local_width`` wide (default: this host's column count) are
        zero-padded to ``pad_to`` (default: the widest group) before the sum
        and sliced back after; zeros never change a sum.  Other leaves ride
        unpadded; the match is decided per leaf before the merge."""
        if self.spec.grid[0] == 1:
            return tree
        mine = self.spec.local_cols if local_width is None else int(local_width)
        w = self.spec.max_col_width if pad_to is None else int(pad_to)
        leaves, rebuild = _flatten(tree)
        host = [_host_tensor(leaf) for leaf in leaves]
        flags = [
            t.dim() > feat_axis and t.shape[feat_axis] == mine and mine != w
            for t in host
        ]

        def pad(t):
            shape = list(t.shape)
            shape[feat_axis] = w
            out = t.new_zeros(shape)
            out.narrow(feat_axis, 0, t.shape[feat_axis]).copy_(t)
            return out

        padded = [pad(t) if f else t for t, f in zip(host, flags)]
        merged = self._merged(padded, self._obs_group)
        out = [m.narrow(feat_axis, 0, mine) if f else m for m, f in zip(merged, flags)]
        return rebuild([_like(m, leaf) for m, leaf in zip(out, leaves)])

    def assemble(self, tree):
        """Scatter each column group's ``(..., local_cols)`` score slice
        into zeros of full width ``(..., N)`` and sum across hosts — the
        wide / 2-D vector reduce.  Only ``obs_coord == 0`` contributes
        (after :meth:`psum_obs` every host of a column group holds the same
        slice), so each output column receives exactly one non-zero addend:
        float adds against zeros, exact, and every host ends with the same
        full vector."""
        if not self.spec.partitions_cols:
            return self.psum(tree) if self.spec.grid[0] > 1 else tree
        lo, hi = self.spec.col_range
        leaves, rebuild = _flatten(tree)

        def scatter(leaf):
            a = np.asarray(leaf.cpu() if isinstance(leaf, torch.Tensor) else leaf)
            full = np.zeros(a.shape[:-1] + (self.spec.num_features,), a.dtype)
            if self.spec.obs_coord == 0:
                full[..., lo:hi] = a
            return full

        full = [scatter(leaf) for leaf in leaves]
        merged = self._merged(full)
        return rebuild([_like(m, leaf) for m, leaf in zip(merged, leaves)])

    # -- ledger exchange -------------------------------------------------

    def allgather_counts(self, values) -> np.ndarray:
        """Every host's integer vector, exactly: ``(num_hosts, k)`` int64
        from each host's ``(k,)`` counters (gloo carries int64 as is)."""
        v = np.asarray(values, np.int64).reshape(-1)
        if self.spec.is_single_host:
            return v[None, :]
        mine = torch.from_numpy(v.copy())
        rows = [torch.empty_like(mine) for _ in range(self.spec.num_hosts)]
        dist.all_gather(rows, mine)
        return torch.stack(rows).numpy()


__all__ = [
    "HostCollectives",
    "HostShardSpec",
    "MultihostContext",
    "factor_host_grid",
    "factor_mesh",
    "init_multihost",
    "resolve_host_shards",
    "split_range",
]
