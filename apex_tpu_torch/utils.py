"""Small shared helpers: integer arithmetic and the device rule.

Every entry point of the port runs on CUDA unless the caller asks for
the CPU: ``resolve_device(None)`` is the current CUDA device and raises
when CUDA is missing, so a machine without a card never falls back to
the plain PyTorch versions silently.
"""
from __future__ import annotations

import torch

__all__ = ["cdiv", "round_up", "resolve_device"]


def cdiv(a: int, b: int) -> int:
    """Ceiling division of non-negative ints."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """``x`` rounded up to a multiple of ``m``."""
    return cdiv(x, m) * m


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA (and
    raises when CUDA is not available); ``"cpu"`` must be asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "apex_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"apex_tpu_torch runs on 'cuda' or 'cpu', got "
                         f"{dev}")
    return dev
