"""apex_tpu_torch — the PyTorch / CUDA port of ``apex_tpu`` for NVIDIA
Hopper (H100).

The JAX package ``apex_tpu`` stays the reference; this package keeps
its module names, public signatures and layouts so each piece has a
findable counterpart, and is tested against it on the same inputs.
Every TPU (Pallas) kernel on a ported path is a CUDA C++ kernel for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use into
``build/apex_tpu_torch/`` and loaded with ``ctypes``
(:mod:`apex_tpu_torch.ops._build`).  A kernel wrapper takes its plain
PyTorch version only for tensors on the CPU; on a CUDA tensor it
launches the kernel or raises.

Ported so far (the serving slice): LLaMA at tp = 1 through the paged
``InferenceEngine`` and the ``SlotScheduler``, on three kernels —
RMSNorm/LayerNorm forward, causal flash-attention forward and paged
decode attention.  Importing this package imports neither ``jax`` nor
``apex_tpu``.
"""
from apex_tpu_torch.utils import cdiv, resolve_device, round_up

__all__ = ["cdiv", "round_up", "resolve_device"]
