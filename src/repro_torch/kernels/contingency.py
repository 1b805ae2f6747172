"""Contingency tables on the card: the CUDA port of the TPU kernel
``src/repro/kernels/contingency.py::contingency_tables_pallas``.

The kernel (``csrc/contingency.cu``) counts ``out[f, v, c] = #{m : X[m, f]
== v, y[m] == c}`` straight into exact int32 tables: no one-hot tile, no
padded or widened copy of ``X``.  It reads int8, uint8, int16, int32 and
int64 ``X`` in place, with any strides: row-major ``(M, F)`` with lanes
along features (both engines pass that: the alternative engine's
feature-major ``X_rows`` comes back as ``X_rows.T``), and a feature-major
view with lanes along rows.  Out-of-range values and targets (negatives,
the ``2**31-1`` sentinel) count nothing.

:func:`contingency_plan` picks the kernel's path from X's geometry and the
table size, on the host:

* ``SWAR``: row-major int8 / uint8 with V <= 2 and C <= 4 (CorrAL's 4
  cells, the class-fused 8): four values tested per 32-bit word, counted
  in byte lanes in registers.
* ``SHARED``: a block's tables in shared memory (up to 227 KB), one shared
  atomic per element: the int32 bin codes' 32 and 256 cells.
* ``GLOBAL``: tables larger than shared memory, one global atomic per
  element.

Loads are 16 bytes per lane where the contiguous axis starts 16-byte
aligned in every row (every column, feature-major), 8 bytes where only
8-byte aligned (CorrAL's 1000-byte rows), and one element (the scalar
width, any strides) otherwise.  The grid is persistent: as many blocks as
fit on the card at once, walking (feature tile, row range) work items.

The plain version is :func:`repro_torch.kernels.ref.contingency_tables`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.contingency import fuse_targets
from repro_torch.kernels import _build

_X_DTYPES = {
    torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.int32: 3,
    torch.int64: 4,
}
# Path codes of ``contingency_tables_launch`` (csrc/contingency.cu).
SWAR, SHARED, GLOBAL = 0, 1, 2
SMEM_MAX = 232448  # bytes of shared memory a block may opt into (227 KB)
SM_SMEM = 233472  # shared memory of one SM (228 KB)
_SMEM_RESERVED = 1024  # per resident block
# Threads per SM that each kernel's __launch_bounds__ leaves registers for.
_REG_THREADS = {SWAR: 768, SHARED: 1024, GLOBAL: 2048}
_GLOBAL_BLOCKS_PER_SM = 8
_WARP = 32


class ContingencyPlan(NamedTuple):
    path: int
    lanes_on_rows: bool  # feature-major kernels: lanes along rows
    vec: int  # elements per lane load; 1 is the scalar width (any strides)
    threads: int
    smem: int  # dynamic shared memory, bytes
    rows_per_item: int
    feat_items: int  # feature tiles (row-major) or groups of one feature per warp
    items: int  # feat_items x row ranges
    grid: int
    replicas: int = 1  # feature-major shared tables: copies per warp


def swar_cells(num_values: int, num_classes: int) -> bool:
    """Whether the byte-lane counters cover this table (csrc/contingency.cu
    instantiates V <= 2 with C <= 2 and C <= 4)."""
    return num_values <= 2 and num_classes <= 4


def swar_tile(num_values: int, num_classes: int) -> int:
    """Features of a row-major SWAR tile: a warp reads 1024 bytes of a row
    with the 4-cell counters, 512 with the 8-cell ones."""
    return 1024 if num_classes <= 2 else 512


def _vec_bytes(ptr: int, other_stride_bytes: int, other_extent: int, itemsize: int) -> int:
    """Widest load (16 or 8 bytes, at least two elements) that every line of
    the contiguous axis starts aligned to; else one element."""
    for vb in (16, 8):
        if vb >= 2 * itemsize and ptr % vb == 0 and (
                other_extent == 1 or other_stride_bytes % vb == 0):
            return vb
    return itemsize


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def contingency_plan(
    X: torch.Tensor, num_values: int, num_classes: int, sms: int = 132,
) -> ContingencyPlan:
    """The kernel path and launch geometry for counting ``X`` (M, F) into
    ``num_values x num_classes`` tables on a card with ``sms`` SMs.  Plans
    are memoised by geometry, so a launch pays for one only once."""
    return _forced_plan(X, num_values, num_classes, sms)


def _forced_plan(
    X: torch.Tensor, num_values: int, num_classes: int, sms: int = 132, *,
    vec: int | None = None, path: int | None = None,
) -> ContingencyPlan:
    """:func:`contingency_plan` with the elements per lane load capped
    (``vec=1``: the scalar width) or the path forced (``SHARED``,
    ``GLOBAL``, ``SWAR`` only where it applies): the tests reach every path
    with it."""
    return _plan(*X.shape, *X.stride(), X.element_size(), X.data_ptr() % 16,
                 num_values, num_classes, sms, vec, path)


@functools.lru_cache(maxsize=256)
def _plan(M, F, sm, sf, size, align, num_values, num_classes, sms, vec, path):
    cells = num_values * num_classes
    lanes_on_rows = F == 1 or (sf != 1 and (sm == 1 or sm < sf))
    if lanes_on_rows:
        vb = _vec_bytes(align, sf * size, F, size) if sm == 1 else size
    else:
        vb = _vec_bytes(align, sm * size, M, size) if sf == 1 else size
    v = vb // size
    if vec is not None:
        v = max(1, min(v, vec))
        if v * size < 4 and v > 1:
            v = 1

    # The byte-lane kernel takes 8- or 16-byte words of 1-byte values along
    # a row.
    swar = size == 1 and v >= 8 and not lanes_on_rows and swar_cells(num_values, num_classes)
    if path is None:
        path = SWAR if swar else SHARED
    elif path == SWAR and not swar:
        raise ValueError("the SWAR path needs row-major 1-byte X, 8- or 16-byte loads and a swar_cells table")

    replicas, threads, smem = 1, 256, 0
    if path == SHARED and not lanes_on_rows:
        while v > 1 and cells * _WARP * v * 4 > SMEM_MAX:
            v //= 2
            if v * size < 4:
                v = 1
        smem = cells * _WARP * v * 4
        threads = 1024 if 2 * (smem + _SMEM_RESERVED) > SM_SMEM else 512
    elif path == SHARED:
        replicas = _WARP if cells * _WARP * 4 * 8 <= 64 * 1024 else 1
        smem = 8 * cells * replicas * 4
    elif path == SWAR:
        smem = cells * swar_tile(num_values, num_classes) * 4
    if path == GLOBAL or smem > SMEM_MAX:
        grid = max(1, min(sms * _GLOBAL_BLOCKS_PER_SM, _cdiv(M * F, 256)))
        return ContingencyPlan(GLOBAL, lanes_on_rows, 1, 256, 0, 0, 0, 0, grid)

    warps = threads // _WARP
    by_smem = SM_SMEM // (smem + _SMEM_RESERVED) if smem else 32
    capacity = sms * max(1, min(_REG_THREADS[path] // threads, by_smem, 32))
    if not lanes_on_rows:
        tile = swar_tile(num_values, num_classes) if path == SWAR else _WARP * v
        feat_items = _cdiv(F, tile)
        target = max(1, capacity // feat_items)
        row_items = max(1, min(target, _cdiv(M, _WARP * warps)))
        rows_per_item = _cdiv(_cdiv(M, row_items), _WARP) * _WARP
    else:
        feat_items = _cdiv(F, warps)
        chunk = _WARP * v
        target = max(1, capacity // feat_items)
        row_items = max(1, min(target, _cdiv(M, 4 * chunk)))
        rows_per_item = _cdiv(_cdiv(M, row_items), chunk) * chunk
    row_items = _cdiv(M, rows_per_item)
    items = feat_items * row_items
    return ContingencyPlan(path, lanes_on_rows, v, threads, smem, rows_per_item,
                           feat_items, items, min(items, capacity), replicas)


def contingency_tables_cuda(
    X: torch.Tensor, y: torch.Tensor, num_values: int, num_classes: int,
    plan: ContingencyPlan | None = None,
) -> torch.Tensor:
    """(M, F) int, (M,) int on the card -> (F, V, C) int32 counts.

    ``plan`` overrides :func:`contingency_plan` (the card tests force paths).
    """
    if not (X.is_cuda or X.is_meta):
        raise ValueError("contingency_tables_cuda needs a CUDA tensor")
    if X.dim() != 2 or X.dtype not in _X_DTYPES:
        raise ValueError(
            f"X must be 2-D of {sorted(map(str, _X_DTYPES))}; got "
            f"{X.dtype} {tuple(X.shape)}"
        )
    M, F = X.shape
    if y.shape != (M,) or y.device != X.device:
        raise ValueError(f"y must be ({M},) on {X.device}; got {tuple(y.shape)}")
    if y.dtype.is_floating_point or y.dtype == torch.bool:
        raise ValueError(f"y must hold integer codes; got {y.dtype}")
    charge = contingency_charge(X, y, num_values, num_classes)
    if X.is_meta:
        return _build.meta_result(contingency_tables_cuda, (F, num_values, num_classes),
                                  torch.int32, *charge)
    if y.dtype == torch.int64:
        # Narrowing would wrap codes past 2**31 back into range.
        y = torch.where((y >= 0) & (y < num_classes), y, torch.full_like(y, -1))
    y32 = y.to(torch.int32).contiguous()
    if M == 0 or F == 0 or num_values * num_classes == 0:
        return torch.zeros((F, num_values, num_classes), dtype=torch.int32, device=X.device)
    out = torch.empty((F, num_values, num_classes), dtype=torch.int32, device=X.device)
    if plan is None:
        plan = contingency_plan(X, num_values, num_classes, _build.sm_count(X.device))
    stride_m, stride_f = X.stride()
    lib = _build.load("contingency")
    err = lib.contingency_tables_launch(
        X.data_ptr(), _X_DTYPES[X.dtype], M, F, stride_m, stride_f,
        y32.data_ptr(), num_values, num_classes, plan.path, int(plan.lanes_on_rows),
        plan.vec, plan.threads, plan.smem, plan.rows_per_item, plan.feat_items,
        plan.items, plan.grid, plan.replicas, out.data_ptr(),
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check(err, "contingency_tables_launch")
    _build.count_launch(contingency_tables_cuda, *charge)
    return out


def contingency_charge(X, y, num_values: int, num_classes: int) -> tuple[int, int]:
    """(operations, bytes) of one count: a compare-and-count an element;
    X and y read once, the tables written once."""
    M, F = X.shape
    nbytes = X.numel() * X.element_size() + y.numel() * y.element_size()
    return M * F, nbytes + F * num_values * num_classes * 4


contingency_tables_cuda.launches = 0


def conditional_tables_cuda(
    X: torch.Tensor, xj: torch.Tensor, y: torch.Tensor, num_values: int,
    num_classes: int,
) -> torch.Tensor:
    """(M, F), (M,), (M,) -> (F, V, V, C) class-conditioned pair tables.

    The class is fused into the pair target (``xj * C + y``, range-guarded)
    so the same kernel counts the 3-way tables with ``V * C`` target values.
    """
    fused = fuse_targets(xj, y, num_values, num_classes)
    out = contingency_tables_cuda(X, fused, num_values, num_values * num_classes)
    return out.reshape(out.shape[0], num_values, num_values, num_classes)
