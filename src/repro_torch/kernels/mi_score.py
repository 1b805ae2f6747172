"""Mutual information from contingency tables on the card: the CUDA port of
the TPU kernel ``src/repro/kernels/mi_score.py::mi_scores_pallas``.

The kernel (``csrc/mi_score.cu``) reduces stacked ``(F, V, C)`` tables, or
an ``(A, B, V, C)`` stack read through its strides, to MI in nats: a group
of lanes (or a warp, past 32 cells) owns each table and builds its marginals
once.  It reads the int32 counts the contingency kernel wrote (or float32
tables) in place, with no float copy and no ``.contiguous()`` copy of a
strided view.  :func:`mi_plan` picks the launch on the host.  The plain
version is :func:`repro_torch.kernels.ref.mi_scores`.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.int32: 0, torch.float32: 1}
_THREADS = 256
_WARPS = _THREADS // 32
_SMEM_BYTES = 48 * 1024  # dynamic shared memory a block takes without opting in


class MIPlan(NamedTuple):
    group: int  # lanes a table, 1-32 (V*C <= 32); 0: a warp a table
    threads: int
    grid: int
    smem_bytes: int  # the warp path's marginals, V + C floats a warp
    scratch: int  # floats of global scratch for them (0: in shared memory)


@functools.lru_cache(maxsize=256)
def mi_plan(tables: int, V: int, C: int, sms: int = 132) -> MIPlan:
    """The launch for ``tables`` tables of ``V x C`` cells.

    Up to 32 cells, G = next power of two >= V*C lanes a table, 256 threads
    a block, the grid covering every table.  Beyond that a warp a table,
    with as many warps a block (at most 8) as hold their marginals in 48 KB
    of shared memory; where not one does (V + C > 12,288), the marginals go
    to global scratch and a grid of ``sms`` blocks walks the tables.
    """
    cells = V * C
    if cells <= 32:
        group = 1 << max(cells - 1, 0).bit_length()
        return MIPlan(group, _THREADS, -(-tables * group // _THREADS), 0, 0)
    per_warp = 4 * (V + C)
    warps = min(_WARPS, _SMEM_BYTES // per_warp)
    if warps >= 1:
        return MIPlan(0, 32 * warps, -(-tables // warps), warps * per_warp, 0)
    grid = min(-(-tables // _WARPS), sms)
    return MIPlan(0, _THREADS, grid, 0, grid * _WARPS * (V + C))


def mi_scores_cuda(counts: torch.Tensor) -> torch.Tensor:
    """(F, V, C) or (A, B, V, C) int32 or float32 counts on the card -> (F,)
    or (A, B) float32 MI.  Any strides; other dtypes are cast to float32."""
    if not (counts.is_cuda or counts.is_meta):
        raise ValueError("mi_scores_cuda needs a CUDA tensor")
    if counts.dim() not in (3, 4):
        raise ValueError(f"counts must be (F, V, C) or (A, B, V, C); got {tuple(counts.shape)}")
    if counts.dtype not in _DTYPES:
        counts = counts.to(torch.float32)
    *lead, V, C = counts.shape
    st = counts.stride()
    inner, s_inner = (lead[1], st[1]) if len(lead) == 2 else (1, 0)
    tables = math.prod(lead)
    charge = mi_charge(counts)
    if counts.is_meta:
        return _build.meta_result(mi_scores_cuda, lead, torch.float32, *charge)
    plan = mi_plan(tables, V, C, _build.sm_count(counts.device))
    if plan.scratch:  # one allocation: the output, then the scratch
        buf = torch.empty((tables + plan.scratch,), dtype=torch.float32, device=counts.device)
        out, scratch = buf[:tables].view(lead), buf.data_ptr() + 4 * tables
    else:
        out, scratch = torch.empty(lead, dtype=torch.float32, device=counts.device), None
    if tables == 0:
        return out
    lib = _build.load("mi_score")
    err = lib.mi_scores_launch(
        counts.data_ptr(), _DTYPES[counts.dtype], tables, inner, st[0], s_inner, st[-2], st[-1],
        V, C, plan.group, plan.threads, plan.grid, plan.smem_bytes, scratch, out.data_ptr(),
        torch.cuda.current_stream(counts.device).cuda_stream,
    )
    _build.check(err, "mi_scores_launch")
    _build.count_launch(mi_scores_cuda, *charge)
    return out


def mi_charge(counts) -> tuple[int, int]:
    """(operations, bytes) of one call: ~10 instructions a cell; the counts
    read once, one float32 a table written."""
    tables = math.prod(counts.shape[:-2])
    return 10 * counts.numel(), counts.numel() * counts.element_size() + tables * 4


mi_scores_cuda.launches = 0
