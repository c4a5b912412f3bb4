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

Ported so far: the serving slice — LLaMA at tp = 1 through the paged
``InferenceEngine`` and the ``SlotScheduler``, on the RMSNorm/LayerNorm
forward, causal flash-attention forward and paged decode-attention
kernels — and the training slice — the LLaMA model trained at tp = 1
by the flat-native ``train_step.make_train_step`` with dynamic loss
scaling and fused Adam, adding the norm backward, flash backward,
unscale and Adam kernels — fused-block decode (one kernel a decoder
layer), and the optimizer family: the LAMB, SGD, Adagrad and NovoGrad
rules and ``contrib.clip_grad_norm_``, on the L2 norm, LAMB phase-1,
SGD and Adagrad kernels — and the last slice of kernels: Apex's
``multi_tensor_applier`` entry point (:mod:`.multi_tensor_apply`) on
the axpby and fused scale-and-norm kernels, and the split flash
backward that trains at 8192 tokens — and Apex's optimizer classes
(:mod:`.optimizers`: ``FusedAdam(model.parameters())`` and its
siblings, as ``torch.optim.Optimizer`` twins on the flat rules, or over
a tree of tensors) with the train-to-serve handoff
(``InferenceEngine.from_train_state`` / ``from_state_dict``) — and
GPT and BERT serving and training (:mod:`.models`, the flagship model
zoo, with dropout and the padding mask in training mode on the flash
kernels' mask and dropout instances) — and data parallelism and ZeRO
(:mod:`.parallel`: ``DistributedDataParallel``, ``SyncBatchNorm``,
``LARC``; ``make_train_step(zero=True)`` and ``contrib.optimizers``'
``DistributedFused{Adam,LAMB}`` over ``torch.distributed`` process
groups that :mod:`.transformer.parallel_state` builds).
Importing this package imports neither ``jax`` nor ``apex_tpu``.
"""
from apex_tpu_torch.utils import cdiv, resolve_device, round_up
from apex_tpu_torch import models, multi_tensor_apply, optimizers

__all__ = ["cdiv", "round_up", "resolve_device", "models",
           "multi_tensor_apply", "optimizers"]
