"""Contingency tables on the card: the CUDA port of the TPU kernel
``src/repro/kernels/contingency.py::contingency_tables_pallas``.

The kernel (``csrc/contingency.cu``) counts ``out[f, v, c] = #{m : X[m, f]
== v, y[m] == c}`` straight into exact int32 tables: no one-hot tile, no
padded or widened copy of ``X``.  It reads int8, uint8, int16, int32 and
int64 ``X`` in place, with any strides: lanes of a warp run over features
for the row-major ``(M, F)`` layout and over rows for a feature-major view
(``X_rows.T``), so both engines' layouts read coalesced without a transpose.
Out-of-range values and targets (negatives, the ``2**31-1`` sentinel) count
nothing.

The plain version is :func:`repro_torch.kernels.ref.contingency_tables`.
"""

from __future__ import annotations

import torch

from repro_torch.core.contingency import fuse_targets
from repro_torch.kernels import _build

_X_DTYPES = {
    torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.int32: 3,
    torch.int64: 4,
}
# Shared memory a block may take without an opt-in attribute.
_SMEM_BYTES = 48 * 1024
_THREADS = 256
# Blocks to aim for: a few waves over the card's SMs.
_BLOCKS_PER_SM = 8
# Fewest rows a lane walks in one row chunk.
_MIN_ROWS_PER_LANE = 64


def _launch_geometry(M: int, F: int, cells: int, lanes_on_rows: bool, sms: int):
    """-> (tf, tr, rows_per_chunk, row_chunks, use_smem)."""
    threads = _THREADS
    while threads > 32 and cells * threads * 4 > _SMEM_BYTES:
        threads //= 2
    use_smem = cells * threads * 4 <= _SMEM_BYTES
    tr = 32 if lanes_on_rows else 1
    tf = threads // tr
    feat_blocks = -(-F // tf)
    want = -(-sms * _BLOCKS_PER_SM // feat_blocks)
    most = max(1, -(-M // (tr * _MIN_ROWS_PER_LANE)))
    row_chunks = max(1, min(want, most, 65535))
    rows_per_chunk = -(-M // row_chunks)
    row_chunks = -(-M // rows_per_chunk)
    return tf, tr, rows_per_chunk, row_chunks, use_smem


def contingency_tables_cuda(
    X: torch.Tensor, y: torch.Tensor, num_values: int, num_classes: int
) -> torch.Tensor:
    """(M, F) int, (M,) int on the card -> (F, V, C) int32 counts."""
    if not X.is_cuda:
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
    if y.dtype == torch.int64:
        # Narrowing would wrap codes past 2**31 back into range.
        y = torch.where((y >= 0) & (y < num_classes), y, torch.full_like(y, -1))
    y32 = y.to(torch.int32).contiguous()
    out = torch.zeros((F, num_values, num_classes), dtype=torch.int32, device=X.device)
    if M == 0 or F == 0:
        return out
    stride_m, stride_f = X.stride()
    lanes_on_rows = stride_m == 1 and (stride_f != 1 or F == 1)
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    tf, tr, rows_per_chunk, row_chunks, use_smem = _launch_geometry(
        M, F, num_values * num_classes, lanes_on_rows, sms
    )
    lib = _build.load("contingency")
    err = lib.contingency_tables_launch(
        X.data_ptr(), _X_DTYPES[X.dtype], M, F, stride_m, stride_f,
        y32.data_ptr(), num_values, num_classes, tf, tr, int(lanes_on_rows),
        rows_per_chunk, row_chunks, int(use_smem), out.data_ptr(),
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check(err, "contingency_tables_launch")
    contingency_tables_cuda.launches += 1
    return out


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
