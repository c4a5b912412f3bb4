"""ZeRO-sharded fused optimizers over the data-parallel group.

Reference: ``apex/contrib/optimizers/distributed_fused_adam.py ::
DistributedFusedAdam`` and ``distributed_fused_lamb.py ::
DistributedFusedLAMB``: grads reduce-scattered across the DP group, the
fused update on the owned shard, the updated params all-gathered; fp32
master shards under bf16/fp16 params.

Port of ``apex_tpu/contrib/optimizers.py``: thin shells over the
dp-sharded functional core (:mod:`apex_tpu_torch.optimizers.functional`),
one process a rank.  ``init_state`` builds this rank's shard of the
contiguous flat master, ``step`` reduce-scatters the raveled grads over
the group ``axis_name`` names (a mesh-axis name or a ``ProcessGroup``),
runs the same ``_AdamTx`` / ``_LambTx`` update the dense ``FusedAdam`` /
``FusedLAMB`` run on the shard (LAMB's per-tensor trust ratios from
shard partials summed over the group), and all-gathers the params in
their construction dtypes.  Memory per rank: params + (master, m, v)/dp.

Checkpoints are shard-aware: ``state_dict(state)`` reassembles the full
unpadded flat master and slots (all-gathered when given this rank's
shard: every rank calls it), and ``load_state_dict`` + ``shard_state``
re-pad and re-slice them for any dp, so a checkpoint taken at dp = 4
restores at dp = 2.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.optimizers import functional as _functional
from apex_tpu_torch.parallel import _comm
from apex_tpu_torch.utils import cdiv, tree_leaves_with_path, tree_ravel

__all__ = ["DistributedFusedAdam", "DistributedFusedLAMB"]

DATA_AXIS = "data"


class _DistributedOptimizerBase:
    """Static layout holder; all state is explicit (a dict of tensors).

    Subclasses set ``self._tx`` (a functional rule) and ``_state_keys``
    (the slot names, matching ``FlatState.slots``)."""

    _state_keys: tuple = ()

    def __init__(self, shard_size_divisor: int, axis_name=DATA_AXIS,
                 grad_average: bool = True):
        self.axis_name = axis_name
        self.dp = int(shard_size_divisor)
        self.grad_average = grad_average
        self._numel: Optional[int] = None
        self._sizes: Optional[tuple] = None

    # -- layout helpers ------------------------------------------------------
    def _padded(self, n: int) -> int:
        return cdiv(n, self.dp) * self.dp

    def _record_layout(self, tree) -> tuple:
        sizes = tuple(int(t.numel()) for _, t in tree_leaves_with_path(tree))
        self._sizes = sizes
        self._numel = sum(sizes)
        return sizes

    def _shard(self) -> tuple:
        return (self.axis_name, self.dp)

    def _group(self):
        from apex_tpu_torch.transformer.parallel_state import resolve_group
        return resolve_group(self.axis_name)

    def _flat_state(self, state: dict, sizes: tuple):
        """State dict -> sharded FlatState over the same tensors."""
        return _functional.FlatState(
            master=state["master"],
            count=state["step"].to(torch.float32),
            slots={k: state[k] for k in self._state_keys},
            sizes=sizes,
            shard=self._shard() if self.dp > 1 else ())

    def init_state(self, params) -> dict:
        """This rank's sharded state (``params``: a tree of tensors, every
        rank the same)."""
        self._record_layout(params)
        fs = self._tx.init(params, shard=self._shard())
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=fs.master.device),
                "master": fs.master,
                **{k: fs.slots[k] for k in self._state_keys}}

    def _shard_grads(self, grads):
        """ravel + reduce-scatter: ``(grad shard [n_pad/dp], n,
        unravel)``, the shard in the ravel dtype divided by dp (with
        ``grad_average``)."""
        gflat, unravel = tree_ravel(grads)
        self._flat_dtype = gflat.dtype
        n = gflat.shape[0]
        if self.dp == 1:
            return gflat, n, unravel
        pad = self._padded(n) - n
        if pad:
            gflat = torch.cat([gflat, gflat.new_zeros(pad)])
        gshard = gflat.new_empty(gflat.shape[0] // self.dp)
        _comm.reduce_scatter(gshard, gflat, self._group())
        if self.grad_average:
            gshard = gshard / self.dp
        return gshard, n, unravel

    def _gather_params(self, pshard, n, unravel):
        if self.dp == 1:
            return unravel(pshard[:n].to(self._flat_dtype))
        full = pshard.new_empty(pshard.shape[0] * self.dp)
        _comm.all_gather(full, pshard, self._group())
        return unravel(full[:n].to(self._flat_dtype))

    def step(self, state: dict, grads, *, lr: Optional[float] = None,
             noop_flag=0.0, grad_scale=1.0):
        """One ZeRO step on every rank: ``(params, new_state)``, the
        params a new tree in the grads' leaf dtypes.  The shard's master
        and slots are updated in place."""
        sizes = self._record_layout(grads)
        gshard, n, unravel = self._shard_grads(grads)
        fs = self._flat_state(state, sizes)
        fs = self._tx.update(fs, gshard, noop_flag=noop_flag,
                             grad_scale=grad_scale, lr=lr)
        new_state = {"step": state["step"] + 1, "master": fs.master,
                     **{k: fs.slots[k] for k in self._state_keys}}
        return self._gather_params(fs.master, n, unravel), new_state

    # -- checkpointing (shard-aware: reassembles the full flat master) ------
    def _full_buffer(self, buf) -> np.ndarray:
        """The UNPADDED full vector of a state buffer: a full (padded)
        buffer is sliced, a ``[dp, shard_len]`` stack flattened, and this
        rank's shard all-gathered over the group (collective)."""
        n = self._numel
        if isinstance(buf, torch.Tensor) and buf.dim() == 1 \
                and self.dp > 1 and buf.shape[0] * self.dp == \
                self._padded(n):
            full = buf.new_empty(buf.shape[0] * self.dp)
            _comm.all_gather(full, buf.contiguous(), self._group())
            buf = full
        arr = buf.detach().cpu().numpy() if isinstance(buf, torch.Tensor) \
            else np.asarray(buf)
        arr = arr.reshape(-1)
        if arr.shape[0] < n:
            raise ValueError(
                f"state buffer has {arr.shape[0]} elements < numel {n}: pass "
                f"this rank's shard, the [dp, shard_len] stack or the full "
                f"buffer")
        return arr[:n].copy()

    def state_dict(self, state: dict) -> dict:
        """Shard-aware checkpoint: the step, the numel and the full
        (reassembled, unpadded) flat master and slots as numpy arrays."""
        if self._numel is None:
            raise ValueError(
                "state_dict before init_state/step: the optimizer has "
                "not seen the parameter layout yet")
        return {"step": int(state["step"]),
                "numel": int(self._numel),
                "master": self._full_buffer(state["master"]),
                **{k: self._full_buffer(state[k])
                   for k in self._state_keys}}

    def load_state_dict(self, sd: dict, device=None) -> dict:
        """Full-buffer checkpoint -> padded GLOBAL state for THIS
        optimizer's dp (re-padded, so the saving and restoring dp may
        differ), on ``device`` (default: the CPU).  :meth:`shard_state`
        takes this rank's slice."""
        n = int(sd["numel"])
        self._numel = n

        def pad_full(v):
            v = torch.as_tensor(np.asarray(v), dtype=torch.float32)
            pad = self._padded(n) - n
            if pad:
                v = torch.cat([v, v.new_zeros(pad)])
            return v.to(device) if device is not None else v

        return {"step": torch.tensor(int(sd["step"]), dtype=torch.int32,
                                     device=device),
                "master": pad_full(sd["master"]),
                **{k: pad_full(sd[k]) for k in self._state_keys}}

    def shard_state(self, full_state: dict, rank: Optional[int] = None
                    ) -> dict:
        """This rank's shard (``rank``: default, the process's rank in
        the group) of a padded GLOBAL state, as new tensors."""
        if self.dp == 1:
            return {k: v.clone() for k, v in full_state.items()}
        if rank is None:
            rank = dist.get_rank(self._group())
        shard_len = full_state["master"].shape[0] // self.dp

        def slc(v):
            return v[rank * shard_len:(rank + 1) * shard_len].clone()

        return {"step": full_state["step"].clone(),
                "master": slc(full_state["master"]),
                **{k: slc(full_state[k]) for k in self._state_keys}}


class DistributedFusedAdam(_DistributedOptimizerBase):
    """Parity surface for ``DistributedFusedAdam(params, lr,
    bias_correction, betas, eps, adam_w_mode, weight_decay, ...)``; the
    distribution knobs (process groups, bucket sizes, overlap flags)
    collapse into ``axis_name``.  The update math is the functional
    ``_AdamTx`` the dense ``FusedAdam`` runs, on the rank's shard (the
    Adam kernel, one launch a step at the shard's length)."""

    _state_keys = ("exp_avg", "exp_avg_sq")

    def __init__(self, shard_size_divisor: int, lr: float = 1e-3,
                 bias_correction: bool = True, betas=(0.9, 0.999),
                 eps: float = 1e-8, adam_w_mode: bool = True,
                 weight_decay: float = 0.0, axis_name=DATA_AXIS,
                 grad_average: bool = True, **_parity_kwargs):
        super().__init__(shard_size_divisor, axis_name, grad_average)
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self._tx = _functional.fused_adam(
            lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
            adam_w_mode=adam_w_mode, bias_correction=bias_correction)


class DistributedFusedLAMB(_DistributedOptimizerBase):
    """ZeRO LAMB (reference: ``DistributedFusedLAMB``): phase 1 on the
    shard (one LAMB phase-1 launch a step at the shard's length), the
    global grad norm and the per-tensor weight and direction norms from
    shard partials (the L2-norm kernel over each of the rank's leaf
    windows) summed over the group — EXACT per-tensor trust ratios —
    then the scaled apply on the shard and the all-gather."""

    _state_keys = ("exp_avg", "exp_avg_sq")

    def __init__(self, shard_size_divisor: int, lr: float = 1e-3,
                 bias_correction: bool = True, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 max_grad_norm: float = 1.0, axis_name=DATA_AXIS,
                 grad_average: bool = True, use_nvlamb: bool = False,
                 **_parity_kwargs):
        super().__init__(shard_size_divisor, axis_name, grad_average)
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self._tx = _functional.fused_lamb(
            lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
            max_grad_norm=max_grad_norm, bias_correction=bias_correction,
            use_nvlamb=use_nvlamb)
