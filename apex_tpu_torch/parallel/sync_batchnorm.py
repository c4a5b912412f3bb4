"""SyncBatchNorm — batch norm whose statistics span a process group.

Reference: ``apex/parallel/sync_batchnorm.py`` over the ``syncbn`` CUDA
extension (``csrc/welford.cu``): per-GPU Welford stats, an all-reduce of
(mean, var, count), then the BN apply; the backward all-reduces the two
reduction terms (Σdy, Σdy·x̂).

Port of ``apex_tpu/parallel/sync_batchnorm.py``, which is XLA (no
Pallas kernel): plain PyTorch with the JAX module's numerics.  Each
rank computes its local count, mean and centred variance, then two
all-reduces over the group merge them (Welford's parallel merge: the
count-weighted means, then the centred second moments about the merged
mean), so no E[x²] − mean² cancellation.  The all-reduce is
differentiable (its backward all-reduces the incoming grads, the
transpose of JAX's ``psum``), so the backward's collectives are the
merge's: two all-reduces, carrying Σdy and Σdy·x̂.  The parameters are
``weight`` and ``bias``, the statistics ``running_mean`` and
``running_var`` (JAX's ``params`` and ``batch_stats`` names).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import _comm
from apex_tpu_torch.utils import resolve_device

__all__ = ["SyncBatchNorm", "convert_syncbn_model"]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the grads over it too."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _comm.all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _comm.all_reduce(grad.contiguous().clone(), ctx.group), None


class SyncBatchNorm(torch.nn.Module):
    """BatchNorm with statistics over the ``axis_name`` group.

    ``momentum`` is the running-stat update rate; the running variance
    takes the unbiased estimate (torch semantics).  ``axis_name``: a
    mesh-axis name (default ``"data"``), a ``ProcessGroup``, or ``None``
    (local statistics).  ``axis_index_groups`` splits the axis into
    subsets of its ranks that each share statistics (the reference's
    ``create_syncbn_process_group``); building them is collective, so
    every rank constructs the module.  ``channel_last``: the features
    are the last dimension (NHWC), else dimension 1 (NCHW)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True, axis_name="data",
                 axis_index_groups=None, channel_last: bool = True,
                 device=None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.axis_name = axis_name
        self.axis_index_groups = axis_index_groups
        self.channel_last = channel_last
        dev = resolve_device(device)
        self.register_buffer("running_mean", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("running_var", torch.ones(
            num_features, dtype=torch.float32, device=dev))
        if affine:
            self.weight = torch.nn.Parameter(torch.ones(
                num_features, dtype=torch.float32, device=dev))
            self.bias = torch.nn.Parameter(torch.zeros(
                num_features, dtype=torch.float32, device=dev))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self._subgroup = None
        if axis_name is not None and axis_index_groups is not None:
            self._subgroup = self._build_subgroups()

    def _build_subgroups(self):
        from apex_tpu_torch.transformer.parallel_state import resolve_group
        axis = resolve_group(self.axis_name)
        mine = None
        for subset in self.axis_index_groups:
            ranks = [dist.get_global_rank(axis, int(i)) for i in subset]
            g = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                mine = g
        if mine is None:
            raise ValueError(f"axis_index_groups {self.axis_index_groups} "
                             f"leave out this rank")
        return mine

    def _group(self):
        if self.axis_name is None:
            return None
        if self._subgroup is not None:
            return self._subgroup
        from apex_tpu_torch.transformer.parallel_state import resolve_group
        group = resolve_group(self.axis_name)
        return group if dist.get_world_size(group) > 1 else None

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        """Normalize ``x``; ``use_running_average`` (default: not
        ``self.training``) takes the running statistics instead of the
        batch's and updates nothing."""
        if use_running_average is None:
            use_running_average = not self.training
        feat = x.dim() - 1 if self.channel_last else 1
        reduce_dims = [d for d in range(x.dim()) if d != feat]
        shape = [1] * x.dim()
        shape[feat] = self.num_features
        x32 = x.float()
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            n_local = x32.numel() // self.num_features
            mean_local = x32.mean(dim=reduce_dims)
            var_local = torch.square(
                x32 - mean_local.reshape(shape)).mean(dim=reduce_dims)
            group = self._group()
            if group is not None:
                nl = torch.full((1,), float(n_local), dtype=torch.float32,
                                device=x.device)
                s = _AllReduceSum.apply(
                    torch.cat([nl, n_local * mean_local]), group)
                n, mean = s[0], s[1:] / s[0]
                var = _AllReduceSum.apply(
                    n_local * (var_local + torch.square(mean_local - mean)),
                    group) / n
            else:
                n, mean, var = float(n_local), mean_local, var_local
            if self.track_running_stats:
                with torch.no_grad():
                    m = self.momentum
                    n_t = torch.as_tensor(n, dtype=torch.float32,
                                          device=x.device)
                    unbiased = var * n_t / torch.clamp_min(n_t - 1.0, 1.0)
                    self.running_mean.mul_(1 - m).add_(m * mean)
                    self.running_var.mul_(1 - m).add_(m * unbiased)
        y = (x32 - mean.reshape(shape)) * torch.rsqrt(
            var + self.eps).reshape(shape)
        if self.affine:
            y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


def convert_syncbn_model(module, process_group=None, channel_last=False):
    """Recursively replace every ``torch.nn`` batch norm of ``module`` by
    :class:`SyncBatchNorm` over ``process_group`` (a ``ProcessGroup`` or
    a mesh-axis name; ``None``: the ``"data"`` axis), keeping its
    parameters and running statistics (the same tensors), its eps,
    momentum and mode.  ``channel_last=False`` reads the features at
    dimension 1, as torch's batch norms do.  Any other module passes
    through; its children are converted in place.  Parity:
    ``apex.parallel.convert_syncbn_model``."""
    if not isinstance(module, torch.nn.Module):
        raise TypeError("convert_syncbn_model converts torch modules, got "
                        f"{type(module).__name__}")
    mod = module
    if isinstance(module, torch.nn.modules.batchnorm._BatchNorm):
        dev = (module.running_mean.device if module.running_mean is not None
               else module.weight.device if module.affine else None)
        mod = SyncBatchNorm(
            module.num_features, eps=module.eps,
            momentum=0.1 if module.momentum is None else module.momentum,
            affine=module.affine,
            track_running_stats=module.track_running_stats,
            axis_name="data" if process_group is None else process_group,
            channel_last=channel_last,
            device="cpu" if dev is None else dev)
        if module.affine:
            mod.weight = module.weight
            mod.bias = module.bias
        if module.track_running_stats:
            mod.running_mean = module.running_mean
            mod.running_var = module.running_var
        mod.train(module.training)
    for name, child in module.named_children():
        new = convert_syncbn_model(child, process_group, channel_last)
        if new is not child:
            setattr(mod, name, new)
    return mod
