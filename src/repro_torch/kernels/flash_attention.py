"""GQA flash attention on the card: the CUDA port of the TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention_pallas``.

The kernel (``csrc/flash_attention.cu``) computes softmax attention of
``q (B, S, H, D)`` against ``k, v (B, T, KV, D)``, query head ``h`` reading
KV head ``h // (H / KV)``, with an online softmax over KV tiles:
float32 scores, softmax and accumulator, the output in q's dtype.  bfloat16
inputs run both products on the tensor cores with ``wgmma``, fed by TMA
loads into a ring of K/V tiles in shared memory (P rounded to bf16 as the
operand of P.V); float32 inputs run on the CUDA cores in float32.  With
``causal`` query ``i`` sees keys ``<= i + T - S`` and the tiles above the
diagonal are skipped.  Any ``S, T >= 1``; D of 32, 64 or 128.

Strides: q, k and v are read in place through the strides of their first
three axes (the ``(B, S, H, D)`` view of a ``(B, S, H*D)`` projection
costs no copy).  A tensor is copied once, contiguous, only where the kernel
cannot read it in place: a last axis that is not contiguous, or, for bf16,
what TMA cannot describe (:func:`tma_readable`).  The output is a new
contiguous ``(B, S, H, D)`` tensor.  A tensor map the driver refuses to
encode, like a refused launch, raises.

The kernel has no backward, and its output carries no ``grad_fn``: a
training forward through it would give every projection a zero gradient
without a word.  So the wrapper (and ``ops.flash_attention``, on any
device) raises when grad mode is on and q, k or v requires a gradient;
training attends through ``repro_torch.models.attention.train_attention``.

The plain version is :func:`repro_torch.kernels.ref.flash_attention`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# A failed tensor-map encode returns this plus the driver's CUresult.
_ENCODE_FAILED = 10000


def tma_readable(t: torch.Tensor) -> bool:
    """Whether TMA can load bf16 ``t`` (B, L, N, D) in place: a 16-byte-aligned
    start and every stride of the first three axes a positive multiple of 16
    bytes (8 elements), the rule of ``cuTensorMapEncodeTiled``."""
    return t.data_ptr() % 16 == 0 and all(st > 0 and st % 8 == 0 for st in t.stride()[:3])


def _readable(t: torch.Tensor) -> torch.Tensor:
    ok = t.stride(-1) == 1
    if ok and t.dtype == torch.bfloat16:
        ok = tma_readable(t)
    return t if ok else t.clone(memory_format=torch.contiguous_format)  # a fresh, aligned copy


def check_no_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise if a gradient is asked of the forward-only kernel."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash attention has no backward: q, k or v requires a gradient with grad "
            "mode on; train through repro_torch.models.attention.train_attention, or "
            "run inference under torch.inference_mode() / torch.no_grad()"
        )


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool
) -> torch.Tensor:
    """(B, S, H, D) x (B, T, KV, D) on the card -> (B, S, H, D) in q's dtype."""
    check_no_grad(q, k, v)
    if not (q.is_cuda or q.is_meta):
        raise ValueError("flash_attention_cuda needs a CUDA tensor")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q (B, S, H, D) and k, v (B, T, KV, D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, d = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kvh == 0 or h % kvh != 0:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
            "(same B and D, H a multiple of KV)"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k, v must all be float32 or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if t == 0:
        raise ValueError("attention over zero keys is undefined")
    charge = flash_charge(b, s, t, h, kvh, d, q.element_size(), causal)
    if q.is_meta:
        return _build.meta_result(flash_attention_cuda, (b, s, h, d), q.dtype, *charge)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0 or h == 0:
        return out
    q, k, v = _readable(q), _readable(k), _readable(v)
    strides = (ctypes.c_int64 * 9)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3]
    )
    lib = _build.load("flash_attention")
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        b, s, t, h, kvh, d, ctypes.addressof(strides), float(d ** -0.5),
        int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err >= _ENCODE_FAILED:
        raise RuntimeError("flash_attention_launch: cuTensorMapEncodeTiled failed "
                           f"(CUresult {err - _ENCODE_FAILED})")
    _build.check(err, "flash_attention_launch")
    _build.count_launch(flash_attention_cuda, *charge)
    return out


def visible_pairs(s: int, t: int, causal: bool) -> int:
    """(query, key) pairs the attention needs: query i sees keys <= i + t - s."""
    if not causal:
        return s * t
    lo = max(0, s - t - 1)  # the first query that sees a key
    n = s - lo
    return n * (t - s + 1) + (lo + s - 1) * n // 2


def flash_charge(b: int, s: int, t: int, h: int, kvh: int, d: int, itemsize: int,
                 causal: bool) -> tuple[int, int]:
    """(flops, bytes) of one launch: QK^T and PV over the visible pairs, 2 D
    flops a pair each; q, k, v read once, the output written once."""
    return 4 * b * h * d * visible_pairs(s, t, causal), (2 * b * s * h * d
                                                        + 2 * b * t * kvh * d) * itemsize


flash_attention_cuda.launches = 0
