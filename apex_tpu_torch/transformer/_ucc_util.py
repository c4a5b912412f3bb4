"""Transport availability and multi-process start-up (reference:
``apex/transformer/_ucc_util.py``).

Port of ``apex_tpu/transformer/_ucc_util.py``: ``HAS_UCC`` is what
``torch.distributed`` answers (``is_ucc_available``), and
:func:`initialize_distributed_backend` is ``init_process_group`` over
the caller's choice of backend (NCCL with one card a rank; gloo where
ranks share a card or run on the CPU; UCC where it is built in).
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist

__all__ = ["HAS_UCC", "initialize_distributed_backend"]

HAS_UCC = bool(dist.is_available() and dist.is_ucc_available())


def initialize_distributed_backend(
        coordinator_address: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None,
        backend: Optional[str] = None) -> None:
    """Join ``num_processes`` processes as rank ``process_id`` at
    ``coordinator_address`` (``host:port`` or any ``init_method`` URL,
    e.g. ``tcp://localhost:29500`` or ``file:///tmp/store``).
    ``backend`` is ``torch.distributed``'s (``None``: its default per
    device type).  A no-op when ``torch.distributed`` is already
    initialised, or for one process with no address."""
    if dist.is_initialized():
        return
    if num_processes in (None, 0, 1) and coordinator_address is None:
        return
    init_method = coordinator_address
    if init_method is not None and "://" not in init_method:
        init_method = f"tcp://{init_method}"
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
