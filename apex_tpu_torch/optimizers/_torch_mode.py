"""Torch-mode fused optimizers — the reference's canonical entry points.

Reference scripts construct ``apex.optimizers.FusedAdam(model.parameters())``
(imagenet), ``FusedLAMB(...)`` (BERT phase 1) or ``FusedSGD(...)`` and
drive them through the standard ``loss.backward(); optimizer.step()``
loop.  The public classes detect ``nn.Parameter``s in ``__new__`` and
return these twins: ``torch.optim.Optimizer`` subclasses with the JAX
package's twins' contract (``apex_tpu/optimizers/_torch_mode.py``) —
per-parameter ``self.state[p]`` entries under the same keys
(``"step"``, ``"exp_avg"``, ``"exp_avg_sq"``, ``"momentum_buffer"``,
``"sum"``, ``"master"`` for a non-fp32 parameter), ``grad_scale`` a
multiplier, a parameter whose grad is None left untouched (its step does
not advance), fp32 masters for half-precision parameters, FusedLAMB's
grad-norm clip GLOBAL across all groups — so a checkpoint of one loads
into the other.

Each twin runs its class's flat functional rule
(:mod:`apex_tpu_torch.optimizers.functional`), the same code on every
device, not per-parameter arithmetic:

* each param group is bound to flat buffers by
  :class:`~apex_tpu_torch.train_step.FlatParams` (the train step's
  binding): its parameters become views of one flat parameter buffer
  (an fp32 parameter a view of its slice of the flat fp32 master: the
  parameter is its own master) and their grads views of one flat grad
  buffer; the rule's slots are flat buffers beside the master, and
  ``state[p]``'s tensors are views of them shaped like ``p``;
* a step copies each fresh grad (autograd allocates one for a parameter
  whose grad is None, after ``zero_grad(set_to_none=True)``) into its
  slot of the grad buffer and puts the view back, casts the grad buffer
  to fp32 once, runs the rule over each maximal run of consecutive
  parameters that have a grad and share a step count (one run, and on
  CUDA one launch of the rule's kernel, per group when every parameter
  has a grad), and casts the master back into the parameters — with no
  read to the host between the end of the backward and the new
  parameters;
* FusedLAMB's global norm is the L2-norm kernel over each run's grads,
  combined on the device; the clip factor times ``grad_scale`` is the
  rule's ``grad_scale`` and its own clip is off (``max_grad_norm=0``),
  so nothing is clipped twice;
* NovoGrad's rule is plain PyTorch (its JAX rule reaches no kernel); its
  per-tensor ``exp_avg_sq`` is a 0-d view of the rule's per-leaf slot.

A half-precision parameter's master (and every slot of a parameter) is
taken at that parameter's first step, as the JAX twins take it; an fp32
parameter is its own master throughout.
"""
from __future__ import annotations

from itertools import chain

import torch

from apex_tpu_torch.ops.fused_update import _scalar, fused_l2norm
from apex_tpu_torch.optimizers.functional import FlatState
from apex_tpu_torch.optimizers.fused_adagrad import FusedAdagrad
from apex_tpu_torch.optimizers.fused_adam import FusedAdam
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB
from apex_tpu_torch.optimizers.fused_novograd import FusedNovoGrad
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD
from apex_tpu_torch.train_step import FlatParams

__all__ = ["FusedAdamTorch", "FusedLAMBTorch", "FusedSGDTorch",
           "FusedAdagradTorch", "FusedNovoGradTorch",
           "FusedMixedPrecisionLambTorch"]


class _FlatGroup:
    """One param group's flat buffers: the fp32 master, the rule's slots
    and the :class:`FlatParams` binding, in the group's parameter
    order."""

    def __init__(self, params, tx):
        self.params = list(params)
        self.sizes = [p.numel() for p in self.params]
        self.offsets = [0]
        for n in self.sizes:
            self.offsets.append(self.offsets[-1] + n)
        grads = [p.grad for p in self.params]
        self.master = torch.empty(self.offsets[-1], dtype=torch.float32,
                                  device=self.params[0].device)
        self.flat = FlatParams(self.params, master=self.master)
        for p, g in zip(self.params, grads):
            if g is None:           # no grad yet: the step must skip p
                p.grad = None
        self.slots = tx.init_slots(self.master, sizes=tuple(self.sizes))

    def view(self, buf: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf ``i``'s part of a flat buffer, shaped like the leaf."""
        return buf[self.offsets[i]:self.offsets[i + 1]].view(
            self.params[i].shape)


class _TorchFusedBase(torch.optim.Optimizer):
    #: the rule's flat slots that ``state[p]`` shows, and those of them
    #: holding one value per parameter (shown as 0-d views)
    _SLOTS: tuple = ()
    _LEAF_SLOTS: tuple = ()
    #: whether ``state[p]`` counts the parameter's steps
    _HAS_STEP = True

    def __init__(self, params, defaults, set_grad_none=True):
        self._groups = []
        super().__init__(params, defaults)
        self.set_grad_none = bool(set_grad_none)

    def add_param_group(self, param_group):
        super().add_param_group(param_group)
        group = self.param_groups[-1]
        self._groups.append(_FlatGroup(group["params"], self._make_tx(group))
                            if group["params"] else None)

    def zero_grad(self, set_to_none: bool = None):  # noqa: A002
        if set_to_none is None:
            set_to_none = self.set_grad_none      # apex's flag wins
        super().zero_grad(set_to_none=set_to_none)

    # -- per-rule hooks ------------------------------------------------------
    def _slots(self, group) -> tuple:
        return self._SLOTS

    def _run_key(self, st: dict, group):
        """What parameters of one run must share: the step count."""
        return st.get("step", 0)

    def _run_slots(self, fg: _FlatGroup, lo_i: int, hi_i: int, key) -> dict:
        lo, hi = fg.offsets[lo_i], fg.offsets[hi_i]
        return {k: (buf[lo_i:hi_i] if k in self._LEAF_SLOTS else buf[lo:hi])
                for k, buf in fg.slots.items()}

    def _grad_scales(self, work, grad_scale) -> list:
        """Each group's ``grad_scale`` for its rule."""
        return [grad_scale] * len(work)

    # -- the step ------------------------------------------------------------
    def _fill_state(self, fg: _FlatGroup, i: int, p, st: dict, slots):
        """Make ``state[p]``'s missing entries views of the flat buffers:
        a half-precision master from ``p``'s value, zero slots."""
        if p.dtype != torch.float32 and "master" not in st:
            st["master"] = fg.view(fg.master, i)
            st["master"].copy_(p)
        if self._HAS_STEP and "step" not in st:
            st["step"] = 0
        for k in slots:
            if k not in st:
                st[k] = (fg.slots[k][i] if k in self._LEAF_SLOTS
                         else fg.view(fg.slots[k], i))
                st[k].zero_()

    def _gather(self, group, fg: _FlatGroup) -> list:
        """Put each fresh grad into the grad buffer and fill the state of
        each parameter with a grad; returns the runs ``[lo, hi, key]`` of
        consecutive parameters with a grad and one run key."""
        runs = []
        slots = self._slots(group)
        for i, p in enumerate(fg.params):
            g = p.grad
            if g is None:
                continue
            gv = fg.flat.grad_views[i]
            if g.data_ptr() != gv.data_ptr():
                gv.copy_(g)
                p.grad = gv
            st = self.state[p]
            key = self._run_key(st, group)
            self._fill_state(fg, i, p, st, slots)
            if runs and runs[-1][1] == i and runs[-1][2] == key:
                runs[-1][1] = i + 1
            else:
                runs.append([i, i + 1, key])
        return runs

    @torch.no_grad()
    def step(self, closure=None, grad_scale=1.0):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        work = []
        for group, fg in zip(self.param_groups, self._groups):
            runs = self._gather(group, fg) if fg is not None else []
            if runs:
                work.append((group, fg, runs, fg.flat.cast_grads()))
        scales = self._grad_scales(work, grad_scale)
        for (group, fg, runs, grads), scale in zip(work, scales):
            tx = self._make_tx(group)
            dev = fg.master.device
            hyper = self._traced_hyper(group, dev)
            for lo_i, hi_i, key in runs:
                lo, hi = fg.offsets[lo_i], fg.offsets[hi_i]
                count = float(key) if self._HAS_STEP else 0.0
                state = FlatState(
                    master=fg.master[lo:hi], count=_scalar(count, dev),
                    slots=self._run_slots(fg, lo_i, hi_i, key),
                    sizes=tuple(fg.sizes[lo_i:hi_i]))
                tx.update(state, grads[lo:hi], grad_scale=scale, **hyper)
                fg.flat.load(fg.master, lo, hi)
                if self._HAS_STEP:
                    for p in fg.params[lo_i:hi_i]:
                        self.state[p]["step"] += 1
        return loss

    # -- checkpoints ---------------------------------------------------------
    def load_state_dict(self, state_dict):
        """torch's load would replace ``state[p]``'s views with new
        tensors cast to each parameter's dtype (demoting a half
        parameter's fp32 master and moments).  Here torch loads the
        param groups, and each saved value is copied, in fp32, into the
        flat buffers, with ``state[p]`` made of views again.  A half
        parameter whose entry has no ``"master"`` takes it from its
        value at its next step; keys the rule does not know are kept as
        given."""
        groups = state_dict["param_groups"]
        super().load_state_dict({"state": {}, "param_groups": groups})
        saved_ids = chain.from_iterable(g["params"] for g in groups)
        live = chain.from_iterable(g["params"] for g in self.param_groups)
        id_map = dict(zip(saved_ids, live))
        where = {id(p): (fg, i) for fg in self._groups if fg is not None
                 for i, p in enumerate(fg.params)}
        for idx, saved in state_dict["state"].items():
            p = id_map.get(idx)
            if p is None:
                continue
            fg, i = where[id(p)]
            st = self.state[p]
            for k, v in saved.items():
                if k == "step" and self._HAS_STEP:
                    st[k] = int(v)
                elif k in self._SLOTS or (k == "master"
                                          and p.dtype != torch.float32):
                    buf = fg.master if k == "master" else fg.slots[k]
                    dst = buf[i] if k in self._LEAF_SLOTS else fg.view(buf, i)
                    dst.copy_(torch.as_tensor(v).reshape(dst.shape))
                    st[k] = dst
                else:
                    st[k] = v


class FusedAdamTorch(_TorchFusedBase):
    """Reference: ``apex/optimizers/fused_adam.py :: FusedAdam`` — AdamW
    (``adam_w_mode=True``, decay decoupled) or L2-mode Adam, on the
    Adam kernel."""
    _SLOTS = ("exp_avg", "exp_avg_sq")
    _make_tx = FusedAdam._make_tx
    _traced_hyper = FusedAdam._traced_hyper

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, set_grad_none=True,
                 capturable=False, master_weights=False):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay)
        self.adam_w_mode = bool(adam_w_mode)
        super().__init__(params, defaults, set_grad_none)


class FusedSGDTorch(_TorchFusedBase):
    """Reference: ``apex/optimizers/fused_sgd.py :: FusedSGD`` (momentum
    and weight decay, the ``wd_after_momentum`` ordering flag), on the
    SGD kernel.  A parameter's momentum buffer is seeded from its grad
    at its first step; ``state[p]`` has no step count."""
    _HAS_STEP = False
    _make_tx = FusedSGD._make_tx
    _traced_hyper = FusedSGD._traced_hyper

    def __init__(self, params, lr, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, wd_after_momentum=False,
                 materialize_master_grads=True, set_grad_none=False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and "
                             "zero dampening")
        # wd_after_momentum is a GROUP option (the tree class treats it as
        # one), so per-group overrides behave identically on both paths
        defaults = dict(lr=lr, momentum=momentum, dampening=dampening,
                        weight_decay=weight_decay, nesterov=nesterov,
                        wd_after_momentum=bool(wd_after_momentum))
        super().__init__(params, defaults, set_grad_none)

    _SLOTS = ("momentum_buffer",)

    def _slots(self, group):
        # torch keeps no momentum buffer without momentum
        return self._SLOTS if group["momentum"] != 0.0 else ()

    def _run_key(self, st, group):
        return "momentum_buffer" in st            # seeded

    def _run_slots(self, fg, lo_i, hi_i, key):
        lo, hi = fg.offsets[lo_i], fg.offsets[hi_i]
        return {"momentum_buffer": fg.slots["momentum_buffer"][lo:hi],
                "seeded": _scalar(float(key), fg.master.device)}


class FusedAdagradTorch(_TorchFusedBase):
    """Reference: ``apex/optimizers/fused_adagrad.py`` on the Adagrad
    kernel: L2 mode folds decay into the grad before the accumulator
    update; ``adagrad_w_mode`` decouples it.  ``state[p]`` has no step
    count."""
    _SLOTS = ("sum",)
    _HAS_STEP = False
    _make_tx = FusedAdagrad._make_tx
    _traced_hyper = FusedAdagrad._traced_hyper

    def __init__(self, params, lr=1e-2, eps=1e-10, weight_decay=0.0,
                 set_grad_none=True, adagrad_w_mode=False):
        defaults = dict(lr=lr, eps=eps, weight_decay=weight_decay)
        self.adagrad_w_mode = bool(adagrad_w_mode)
        super().__init__(params, defaults, set_grad_none)

    def _run_key(self, st, group):
        return 0


class FusedNovoGradTorch(_TorchFusedBase):
    """Reference: ``apex/optimizers/fused_novograd.py`` — per-TENSOR
    second moment (an EMA of ||g||^2, initialized from the first grad
    unless ``init_zero``), decay folded into the normalized grad, bias
    correction on the first moment; the plain functional rule."""
    _SLOTS = ("exp_avg", "exp_avg_sq")
    _LEAF_SLOTS = ("exp_avg_sq",)
    _make_tx = FusedNovoGrad._make_tx
    _traced_hyper = FusedNovoGrad._traced_hyper

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 amsgrad=False, reg_inside_moment=False,
                 grad_averaging=True, norm_type=2, init_zero=False,
                 set_grad_none=True):
        if amsgrad:
            raise RuntimeError("FusedNovoGrad does not support the "
                               "AMSGrad variant.")
        if norm_type != 2:
            raise ValueError("FusedNovoGrad only supports norm_type=2")
        if reg_inside_moment:
            raise NotImplementedError(
                "FusedNovoGrad: reg_inside_moment=True is not "
                "implemented (only the default decay placement, decay "
                "added to the normalized gradient, is)")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay)
        self.grad_averaging = bool(grad_averaging)
        self.init_zero = bool(init_zero)
        super().__init__(params, defaults, set_grad_none)


class FusedLAMBTorch(_TorchFusedBase):
    """Reference: ``apex/optimizers/fused_lamb.py :: FusedLAMB`` — the
    functional LAMB rule (phase 1 and the per-tensor trust ratios), with
    the grad-norm clip GLOBAL across all param groups (the reference's
    scope, which the BERT decay/no-decay two-group flow depends on)."""
    _SLOTS = ("exp_avg", "exp_avg_sq")
    _make_tx = FusedLAMB._make_tx

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 set_grad_none=True, max_grad_norm=1.0, use_nvlamb=False):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        grad_averaging=grad_averaging,
                        max_grad_norm=max_grad_norm)
        self.adam_w_mode = bool(adam_w_mode)
        self.use_nvlamb = bool(use_nvlamb)
        super().__init__(params, defaults, set_grad_none)

    def _traced_hyper(self, options, device):
        # the clip is applied through grad_scale (_grad_scales): the
        # rule's own clip is off
        return dict(FusedLAMB._traced_hyper(self, options, device),
                    max_grad_norm=_scalar(0.0, device))

    def _grad_scales(self, work, grad_scale):
        if not work:
            return []
        sq = 0.0
        for _, fg, runs, grads in work:
            for lo_i, hi_i, _ in runs:
                norm = fused_l2norm(grads[fg.offsets[lo_i]:fg.offsets[hi_i]])
                sq = sq + norm * norm
        dev = work[0][1].master.device
        gs = _scalar(grad_scale, dev)
        gnorm = torch.sqrt(sq) * torch.abs(gs)
        scales = []
        for group, *_ in work:
            mgn = _scalar(group["max_grad_norm"] or 0.0, dev)
            clip = torch.where((mgn > 0) & (gnorm > mgn),
                               mgn / (gnorm + 1e-6), torch.ones_like(gnorm))
            scales.append(clip * gs)
        return scales


class FusedMixedPrecisionLambTorch(FusedLAMBTorch):
    """Reference: ``apex/optimizers/fused_mixed_precision_lamb.py`` —
    LAMB with an explicit starting ``step`` and a
    ``reduced_precision_dtype`` knob (the fp32 masters already provide
    the mixed-precision behavior; the dtype knob is accepted for
    signature parity)."""

    def __init__(self, params, lr=1e-3, step=0, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, grad_averaging=True, max_grad_norm=1.0,
                 use_nvlamb=False, reduced_precision_dtype=None):
        super().__init__(params, lr=lr, bias_correction=bias_correction,
                         betas=betas, eps=eps, weight_decay=weight_decay,
                         amsgrad=amsgrad, grad_averaging=grad_averaging,
                         max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb)
        self.reduced_precision_dtype = reduced_precision_dtype
        self._initial_step = int(step)

    @torch.no_grad()
    def step(self, closure=None, grad_scale=1.0):
        # every parameter's step starts at the configured count the first
        # time through (the reference resumes mid-schedule)
        if self._initial_step and not any(
                "step" in s for s in self.state.values()):
            for group, fg in zip(self.param_groups, self._groups):
                for i, p in enumerate(fg.params if fg is not None else ()):
                    st = self.state[p]
                    self._fill_state(fg, i, p, st, self._slots(group))
                    st["step"] = self._initial_step
        return super().step(closure=closure, grad_scale=grad_scale)
