"""``MemoryBuffer`` (port of ``apex_tpu/transformer/tensor_parallel/
memory.py``; reference: ``apex/transformer/tensor_parallel/memory.py``):
one flat tensor on an explicit device that hands out views of it.
"""
from __future__ import annotations

import math

import torch

from apex_tpu_torch.utils import resolve_device

__all__ = ["MemoryBuffer"]


class MemoryBuffer:
    """``numel`` elements of ``dtype`` on ``device`` (CUDA unless
    ``"cpu"`` is asked for), zeroed."""

    def __init__(self, numel: int, dtype=torch.float32, device=None):
        self.numel = numel
        self.dtype = dtype
        self.data = torch.zeros(numel, dtype=dtype,
                                device=resolve_device(device))

    def zero(self):
        self.data.zero_()

    def get(self, shape, start_index: int):
        """A view of ``shape`` into the buffer from ``start_index``."""
        end = start_index + math.prod(shape)
        if end > self.numel:
            raise RuntimeError("requested tensor is out of the buffer range")
        return self.data[start_index:end].view(shape)
