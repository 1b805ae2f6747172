"""Rotary position embeddings (port of ``repro.models.rope``, standard RoPE).

Half-split convention: the head dimension is rotated as two halves
``[x1, x2]``.  Angles and the rotation run in float32 and the result is cast
back to x's dtype.  The model computes the angles once per forward
(:func:`rope_cos_sin`) and every layer rotates q and k with them, as XLA
shares them across the scanned layers.  M-RoPE (Qwen2-VL) comes with the
VLM family.
"""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) float32 inverse frequencies."""
    half = head_dim // 2
    exponents = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponents)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, *, theta: float = 1e4):
    """positions (B, S) int -> float32 (cos, sin) of (B, S, 1, D/2)."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, D/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) rotated by the angles of ``rope_cos_sin``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 1e4) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S) int -> rotated x."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta=theta))
