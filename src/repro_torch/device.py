"""Where the port runs: the device an entry point was given, and its name.

Every entry point (the selector, the streaming fit, ``build_model`` and the
two command lines) resolves its ``device`` argument here, so a CUDA device
without a card raises in one place and never falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch sees no CUDA device; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, else ``"cpu"``."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
