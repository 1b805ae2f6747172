"""Quantile-bin codes on the card: the CUDA port of the TPU kernel
``src/repro/kernels/binning.py::bin_codes_pallas``.

The kernel (``csrc/bin_codes.cu``) maps a float32 block ``X (B, N)`` against
per-feature sorted edges ``(N, E)`` to int32 codes, ``code[b, n] = #{k :
edges[n, k] <= X[b, n]}`` — ``searchsorted(side="right")``, bitwise equal to
the host binner (``QuantileBinner.transform``) for every finite value.  NaN
encodes to 0 (``searchsorted`` would give ``E``); the binner rejects
non-finite values when it fits.  X is read through its row stride, so a row
slice or a padded streaming block is encoded in place.

The plain version is :func:`repro_torch.kernels.ref.bin_codes`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_FEAT_LANES, _ROW_LANES = 32, 8
# Blocks to aim for: a few waves over the card's SMs.
_BLOCKS_PER_SM = 8
# Fewest rows a row lane walks in one chunk.
_MIN_ROWS_PER_LANE = 16


def _row_chunks(rows: int, feats: int, sms: int) -> tuple[int, int]:
    """-> (rows_per_chunk, row_chunks) for a (feature tiles, chunks) grid."""
    feat_tiles = -(-feats // _FEAT_LANES)
    want = -(-sms * _BLOCKS_PER_SM // feat_tiles)
    most = max(1, -(-rows // (_ROW_LANES * _MIN_ROWS_PER_LANE)))
    chunks = max(1, min(want, most, 65535))
    per_chunk = -(-rows // chunks)
    return per_chunk, -(-rows // per_chunk)


def bin_codes_cuda(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(B, N) float on the card x (N, E) sorted edges -> (B, N) int32 codes.

    A non-float32 X, or one whose feature axis is not contiguous, is first
    copied to a float32 row-major tensor (as the Pallas wrapper casts).
    """
    if not X.is_cuda:
        raise ValueError("bin_codes_cuda needs a CUDA tensor")
    if X.dim() != 2 or X.dtype.is_complex:
        raise ValueError(f"X must be a 2-D real tensor; got {X.dtype} {tuple(X.shape)}")
    B, N = X.shape
    if edges.dim() != 2 or edges.shape[0] != N or edges.device != X.device:
        raise ValueError(
            f"edges must be ({N}, E) on {X.device}; got {tuple(edges.shape)} "
            f"on {edges.device}"
        )
    X = X.to(torch.float32)
    if N > 1 and X.stride(1) != 1:
        X = X.contiguous()
    edges = edges.to(torch.float32).contiguous()
    out = torch.empty((B, N), dtype=torch.int32, device=X.device)
    if B == 0 or N == 0:
        return out
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    per_chunk, chunks = _row_chunks(B, N, sms)
    lib = _build.load("bin_codes")
    err = lib.bin_codes_launch(
        X.data_ptr(), B, N, X.stride(0), edges.data_ptr(), edges.shape[1],
        per_chunk, chunks, out.data_ptr(),
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check(err, "bin_codes_launch")
    bin_codes_cuda.launches += 1
    return out


bin_codes_cuda.launches = 0
