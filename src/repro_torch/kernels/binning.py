"""Quantile-bin codes on the card: the CUDA port of the TPU kernel
``src/repro/kernels/binning.py::bin_codes_pallas``.

The kernel (``csrc/bin_codes.cu``) maps a float32 block ``X (B, N)`` against
per-feature sorted edges ``(N, E)`` to int32 codes, ``code[b, n] = #{k :
edges[n, k] <= X[b, n]}`` — ``searchsorted(side="right")``, bitwise equal to
the host binner (``QuantileBinner.transform``) for every value: ties go
up, ``-0.0`` equals ``0.0``, and NaN takes the top code ``E`` as
``searchsorted`` sorts it.  X is read through its row stride, so a row
slice or a padded streaming block is encoded in place.

:func:`bin_codes_plan` picks the kernel's path on the host: 4 features per
lane with 16-byte loads and stores at E <= 16 (the main path's ``bins=16``)
on 16-byte aligned rows, one feature per lane for other views and up to
E = 64 (edges in registers), and the E > 64 kernel, which reads its edges
through the read-only cache.

The plain version is :func:`repro_torch.kernels.ref.bin_codes`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_WARP, _ROWS_IN_FLIGHT = 32, 8
# Resident blocks per SM: __launch_bounds__(256, 2) of the register kernels
# (up to 128 registers a thread for 64 edges); the E > 64 kernel is small.
_BLOCKS_PER_SM = {True: 2, False: 4}
_REG_EDGES_MAX = 64  # edges a lane keeps in registers, over its features


class BinCodesPlan(NamedTuple):
    fpl: int  # features per lane: 4 (16-byte loads), 1; 0: E > 64
    threads: int
    rows_per_item: int
    feat_items: int
    items: int
    grid: int


def bin_codes_plan(X: torch.Tensor, num_edges: int, sms: int = 132) -> BinCodesPlan:
    """The kernel path and persistent grid for float32 ``X`` (B, N), features
    contiguous, against ``num_edges`` edges per feature.

    A lane takes 4 features (16-byte loads and stores) at E <= 16 where
    every row starts 16-byte aligned and N is a multiple of 4; otherwise one
    feature (any row stride).  Plans are memoised by geometry.
    """
    return _plan(*X.shape, X.stride(0), X.data_ptr() % 16, num_edges, sms, False)


def _scalar_plan(X: torch.Tensor, num_edges: int, sms: int = 132) -> BinCodesPlan:
    """:func:`bin_codes_plan` held to one feature per lane: the tests reach
    the scalar width on aligned views with it."""
    return _plan(*X.shape, X.stride(0), X.data_ptr() % 16, num_edges, sms, True)


@functools.lru_cache(maxsize=256)
def _plan(B, N, ld_x, align, num_edges, sms, scalar):
    wide = align == 0 and (B == 1 or ld_x % 4 == 0) and N % 4 == 0
    if num_edges > _REG_EDGES_MAX:
        lanes = 0
    elif num_edges <= 16 and wide and not scalar:
        lanes = 4
    else:
        lanes = 1
    threads = 256
    capacity = sms * _BLOCKS_PER_SM[lanes > 0]
    feat_items = -(-N // (_WARP * max(lanes, 1)))
    rows_min = (threads // _WARP) * _ROWS_IN_FLIGHT
    row_items = max(1, min(capacity // feat_items, -(-B // rows_min)))
    rows_per_item = -(-B // row_items)
    items = feat_items * -(-B // rows_per_item)
    return BinCodesPlan(lanes, threads, rows_per_item, feat_items, items, min(items, capacity))


def bin_codes_cuda(X: torch.Tensor, edges: torch.Tensor,
                   plan: BinCodesPlan | None = None) -> torch.Tensor:
    """(B, N) float on the card x (N, E) sorted edges -> (B, N) int32 codes.

    A non-float32 X, or one whose feature axis is not contiguous, is first
    copied to a float32 row-major tensor (as the Pallas wrapper casts).
    ``plan`` overrides :func:`bin_codes_plan` (the card tests force paths).
    """
    if not (X.is_cuda or X.is_meta):
        raise ValueError("bin_codes_cuda needs a CUDA tensor")
    if X.dim() != 2 or X.dtype.is_complex:
        raise ValueError(f"X must be a 2-D real tensor; got {X.dtype} {tuple(X.shape)}")
    B, N = X.shape
    if edges.dim() != 2 or edges.shape[0] != N or edges.device != X.device:
        raise ValueError(
            f"edges must be ({N}, E) on {X.device}; got {tuple(edges.shape)} "
            f"on {edges.device}"
        )
    charge = bin_codes_charge(B, N, edges.shape[1])
    if X.is_meta:
        return _build.meta_result(bin_codes_cuda, (B, N), torch.int32, *charge)
    X = X.to(torch.float32)
    if N > 1 and X.stride(1) != 1:
        X = X.contiguous()
    edges = edges.to(torch.float32).contiguous()
    out = torch.empty((B, N), dtype=torch.int32, device=X.device)
    if B == 0 or N == 0:
        return out
    if plan is None:
        plan = bin_codes_plan(X, edges.shape[1], _build.sm_count(X.device))
    lib = _build.load("bin_codes")
    err = lib.bin_codes_launch(
        X.data_ptr(), B, N, X.stride(0), edges.data_ptr(), edges.shape[1], *plan,
        out.data_ptr(), torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check(err, "bin_codes_launch")
    _build.count_launch(bin_codes_cuda, *charge)
    return out


def bin_codes_charge(B: int, N: int, E: int) -> tuple[int, int]:
    """(operations, bytes) of one call: a compare and an add an edge and
    element; float32 X and the edges read once, the int32 codes written."""
    return 2 * B * N * E, 2 * B * N * 4 + N * E * 4


bin_codes_cuda.launches = 0
