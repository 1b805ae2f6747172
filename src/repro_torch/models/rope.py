"""Rotary position embeddings: standard RoPE, Qwen2-VL's M-RoPE and the
Whisper sinusoidal table (port of ``repro.models.rope``).

Half-split convention: the head dimension is rotated as two halves
``[x1, x2]``.  Angles and the rotation run in float32 and the result is cast
back to x's dtype.  The model computes the angles once per forward
(:func:`rope_cos_sin`) and every layer rotates q and k with them, as XLA
shares them across the scanned layers.

M-RoPE splits the D/2 frequency slots into (t, h, w) sections, each rotated
by its own position stream; when the three streams coincide (text) it is
RoPE exactly.
"""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) float32 inverse frequencies."""
    half = head_dim // 2
    exponents = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponents)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """(B, S) -> (B, S, 3): a text token has the same t, h and w ids."""
    return positions[..., None].expand(*positions.shape, 3)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, *, theta: float = 1e4,
                 sections: tuple = ()):
    """positions (B, S) int, or (B, S, 3) (t, h, w) ids with ``sections``
    (M-RoPE, ``sum(sections) == head_dim // 2``) -> float32 (cos, sin) of
    (B, S, 1, D/2).  Under M-RoPE, (B, S) positions are text positions."""
    half = head_dim // 2
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    if sections:
        if sum(sections) != half:
            raise ValueError(f"M-RoPE sections {sections} do not sum to D/2 = {half}")
        if positions.dim() == 2:
            positions = text_mrope_positions(positions)
        # Slot i of D/2 takes its angle from stream idx[i] in {0=t, 1=h, 2=w}.
        # (output_size: the length is known, so a meta tensor needs no host read)
        idx = torch.repeat_interleave(torch.arange(3, device=positions.device),
                                      torch.tensor(sections, device=positions.device),
                                      output_size=half)
        positions = positions[..., idx]  # (B, S, D/2)
        ang = positions.to(torch.float32) * freqs
    else:
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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections: tuple, *,
                theta: float = 1e4) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: x (B, S, H, D), positions (B, S, 3) (t, h, w)
    ids, ``sections`` splitting the D/2 frequency slots."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta=theta, sections=sections))


def sinusoidal_rows(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """positions (...,) -> float32 (..., d_model) rows of the Whisper table:
    ``sin`` at even columns, ``cos`` at odd, angle ``pos / 10000^(2i/d)``."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=positions.device)
    ang = positions.to(torch.float32)[..., None] / (10000.0 ** (dim / d_model))
    out = torch.zeros((*positions.shape, d_model), dtype=torch.float32, device=positions.device)
    out[..., 0::2] = torch.sin(ang)
    out[..., 1::2] = torch.cos(ang)
    return out


def sinusoidal_positions(seq_len: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal table, float32 (S, D)."""
    return sinusoidal_rows(torch.arange(seq_len, device=device), d_model)
