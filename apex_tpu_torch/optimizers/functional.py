"""Flat-native functional optimizer core: Adam(W), LAMB, SGD, NovoGrad
and Adagrad over one flat buffer.

Port of the dense half of ``apex_tpu/optimizers/functional.py``:
:class:`FlatState` (an fp32 flat master, a step count, the rule's slot
buffers, the leaf layout and an ``unravel``) and the five rules, each
``init(params) -> FlatState`` and ``update(state, flat_grads,
noop_flag=, grad_scale=) -> FlatState`` with the JAX slot names, over
the kernels of :mod:`apex_tpu_torch.ops.fused_update`:

* :func:`fused_adam` — :func:`fused_adam_flat`;
* :func:`fused_lamb` — the global grad norm and the per-leaf weight and
  direction norms by :func:`fused_l2norm` (one launch each: 1 + 2 per
  leaf), the moments and direction by :func:`fused_lamb_phase1_flat`,
  and the trust ratios applied leaf by leaf in place;
* :func:`fused_sgd` — :func:`fused_sgd_flat`, with the ``seeded`` slot
  (a noop-skipped first step does not seed the momentum buffer);
* :func:`fused_adagrad` — :func:`fused_adagrad_flat`;
* :func:`fused_novograd` — plain PyTorch, as its JAX rule reaches no
  Pallas kernel.

:func:`export_params` turns a full flat master back into a parameter
tree for serving (the train-to-serve boundary).

The JAX ``update`` is pure and XLA donates the old buffers; here the
kernels update master and slots IN PLACE and ``update`` returns a new
:class:`FlatState` over the same buffers with the advanced count (a
0-d device tensor: the bias corrections are computed from it on the
device).  As in JAX the count advances on a skipped (noop) step too,
and every quantity between the grads and the new state (clip factor,
norms, ratios, flags) stays a device tensor: nothing is read back.

Not ported yet: the ZeRO layouts (``shard=``, ``prefetch=``; ROADMAP
queue 1, item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from apex_tpu_torch.ops.fused_update import (_scalar, fused_adagrad_flat,
                                             fused_adam_flat, fused_l2norm,
                                             fused_lamb_phase1_flat,
                                             fused_sgd_flat)
from apex_tpu_torch.optimizers.base import broadcast_leaf_scalars
from apex_tpu_torch.utils import (ravel_layout, tree_leaves_with_path,
                                  tree_ravel)

__all__ = ["FlatState", "fused_adam", "fused_lamb", "fused_sgd",
           "fused_novograd", "fused_adagrad", "export_params"]


@dataclasses.dataclass(frozen=True)
class FlatState:
    """Flat optimizer state: fp32 master + per-rule slot buffers.

    ``sizes`` (per-leaf element counts, in the flax tree's leaf order),
    ``flat_dtype`` (the leaves' promoted dtype, the buffer dtype of
    ``tree_ravel``) and ``unravel`` are static layout."""
    master: torch.Tensor            # fp32 flat master buffer
    count: torch.Tensor             # 0-d f32: completed update count
    slots: dict                     # rule buffers, keyed like state_dict
    sizes: tuple = ()
    flat_dtype: torch.dtype = torch.float32
    unravel: Optional[Callable] = None

    def replace(self, **kw) -> "FlatState":
        return dataclasses.replace(self, **kw)

    @property
    def global_numel(self) -> int:
        return sum(self.sizes)

    @property
    def offsets(self) -> tuple:
        """Each leaf's first element in the flat buffers."""
        out, off = [], 0
        for s in self.sizes:
            out.append(off)
            off += s
        return tuple(out)

    def params(self, dtype=None) -> dict:
        """Materialize the params tree (the checkpoint/eval boundary):
        new tensors in the construction dtypes, or floating leaves cast
        to ``dtype``."""
        if self.unravel is None:
            raise ValueError(
                "FlatState was initialized from a flat buffer (no "
                "unravel); read .master directly or init from a tree")
        tree = self.unravel(self.master.to(self.flat_dtype))
        return tree if dtype is None else _cast_floating(tree, dtype)


def _cast_floating(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floating(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


def export_params(flat, params_template, *, dtype=None):
    """Inference weight export from a FULL flat master buffer.

    ``flat`` is the fp32 master (``FlatState.master``); trailing padding
    past the template's element count is sliced off.
    ``params_template`` supplies the leaf layout and dtypes (an
    ``nn.Module`` or a nested dict of tensors, as ``init`` takes; only
    shapes and dtypes are read); ``dtype`` optionally casts the floating
    leaves for serving (bf16)."""
    n, flat_dtype, unravel = ravel_layout(params_template)
    flat = torch.as_tensor(flat)
    if flat.shape[0] < n:
        raise ValueError(
            f"flat master has {flat.shape[0]} elements < the template's "
            f"{n} — wrong template, or a single SHARD was passed instead "
            "of the reassembled full master")
    tree = unravel(flat[:n].to(flat_dtype))
    return tree if dtype is None else _cast_floating(tree, dtype)


def _init_state(tx, params, shard=None, prefetch=None) -> FlatState:
    """Shared init: ravel a tree (an ``nn.Module`` or a nested dict of
    tensors), or take an already-flat buffer, into a fresh fp32 master
    plus the rule's zero slots, on the parameters' device."""
    if shard is not None or prefetch is not None:
        raise NotImplementedError(
            "ZeRO-sharded optimizer state (shard=, prefetch=) is not ported "
            "yet (ROADMAP queue 1, item 6)")
    if isinstance(params, torch.Tensor) and params.dim() == 1:
        flat, unravel = params.detach(), None
        sizes = (int(flat.numel()),)
    else:
        flat, unravel = tree_ravel(params)
        sizes = tuple(int(t.numel()) for _, t in
                      tree_leaves_with_path(params))
    master = flat.to(torch.float32, copy=True)
    return FlatState(
        master=master,
        count=torch.zeros((), dtype=torch.float32, device=master.device),
        slots=tx.init_slots(master, sizes=sizes),
        sizes=sizes, flat_dtype=flat.dtype, unravel=unravel)


@dataclasses.dataclass(frozen=True)
class _AdamTx:
    """Functional FusedAdam(W) (kernel: :func:`fused_adam_flat`)."""
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: bool = True
    bias_correction: bool = True

    def init(self, params, shard=None, prefetch=None) -> FlatState:
        return _init_state(self, params, shard=shard, prefetch=prefetch)

    def init_slots(self, master, *, sizes) -> dict:
        return {"exp_avg": torch.zeros_like(master),
                "exp_avg_sq": torch.zeros_like(master)}

    def update(self, state: FlatState, flat_grads, *, noop_flag=0.0,
               grad_scale=1.0, lr=None, beta1=None, beta2=None, eps=None,
               weight_decay=None) -> FlatState:
        t = state.count + 1.0
        fused_adam_flat(
            state.master, flat_grads,
            state.slots["exp_avg"], state.slots["exp_avg_sq"],
            lr=self.lr if lr is None else lr,
            beta1=self.beta1 if beta1 is None else beta1,
            beta2=self.beta2 if beta2 is None else beta2,
            eps=self.eps if eps is None else eps,
            weight_decay=(self.weight_decay if weight_decay is None
                          else weight_decay),
            step=t, adam_w_mode=self.adam_w_mode,
            bias_correction=self.bias_correction,
            noop_flag=noop_flag, grad_scale=grad_scale)
        return state.replace(count=t)


def _leaves(state: FlatState):
    """``(index, offset, size)`` of every leaf of the flat layout."""
    return [(i, off, size) for i, (off, size) in
            enumerate(zip(state.offsets, state.sizes))]


@dataclasses.dataclass(frozen=True)
class _LambTx:
    """Functional FusedLAMB (kernels: :func:`fused_l2norm`,
    :func:`fused_lamb_phase1_flat`).

    Per-leaf norms need the tensor boundaries, ``state.sizes``.  Memory:
    beyond master, slots and grads the update holds ONE flat-sized
    temporary, the direction u; the norms run over slices of p and u,
    and the trust ratios are applied to p in place, leaf by leaf, with a
    0-d device coefficient.  A skipped (noop) step leaves m and v
    bit-identical through the kernel and makes u zero, so every leaf's
    update is exactly zero."""
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    bias_correction: bool = True
    grad_averaging: bool = True
    use_nvlamb: bool = False

    def init(self, params, shard=None, prefetch=None) -> FlatState:
        return _init_state(self, params, shard=shard, prefetch=prefetch)

    def init_slots(self, master, *, sizes) -> dict:
        return {"exp_avg": torch.zeros_like(master),
                "exp_avg_sq": torch.zeros_like(master)}

    def update(self, state: FlatState, flat_grads, *, noop_flag=0.0,
               grad_scale=1.0, lr=None, beta1=None, beta2=None, eps=None,
               weight_decay=None, max_grad_norm=None) -> FlatState:
        t = state.count + 1.0
        p = state.master
        m, v = state.slots["exp_avg"], state.slots["exp_avg_sq"]
        dev = p.device
        mgn = _scalar(self.max_grad_norm if max_grad_norm is None
                      else max_grad_norm, dev)
        g = flat_grads
        if not (isinstance(grad_scale, (int, float)) and grad_scale == 1.0):
            g = flat_grads.float() * _scalar(grad_scale, dev)
        # global grad norm clip (reference: the first multi_tensor_l2norm)
        gnorm = fused_l2norm(g)
        clip = torch.where((mgn > 0) & (gnorm > mgn), mgn / (gnorm + 1e-6),
                           torch.ones_like(gnorm))
        _, _, u = fused_lamb_phase1_flat(
            p, g, m, v,
            beta1=self.beta1 if beta1 is None else beta1,
            beta2=self.beta2 if beta2 is None else beta2,
            eps=self.eps if eps is None else eps,
            weight_decay=(self.weight_decay if weight_decay is None
                          else weight_decay),
            step=t, bias_correction=self.bias_correction, grad_scale=clip,
            grad_averaging=self.grad_averaging, noop_flag=noop_flag)
        leaves = _leaves(state)
        norms = torch.empty((2, len(leaves)), dtype=torch.float32,
                            device=dev)
        for i, off, size in leaves:
            fused_l2norm(p[off:off + size], out=norms[0, i])
            fused_l2norm(u[off:off + size], out=norms[1, i])
        w_norm, u_norm = norms
        # NVLAMB applies the trust ratio to every param; default LAMB
        # skips params with zero norm (reference kernel's `use_nvlamb`)
        if self.use_nvlamb:
            ratio = w_norm / torch.clamp_min(u_norm, 1e-12)
        else:
            ratio = torch.where((w_norm > 0) & (u_norm > 0),
                                w_norm / u_norm, torch.ones_like(w_norm))
        coef = -(_scalar(self.lr if lr is None else lr, dev) * ratio)
        for i, off, size in leaves:
            p[off:off + size].addcmul_(u[off:off + size], coef[i])
        return state.replace(count=t)


@dataclasses.dataclass(frozen=True)
class _SgdTx:
    """Functional FusedSGD (kernel: :func:`fused_sgd_flat`).

    ``slots["seeded"]`` replicates the class API's first-effective-step
    tracking: torch clones the grad into a FRESH buffer on the first
    step that actually applies (a noop-skipped step must not seed)."""
    lr: float = 1e-3
    momentum: float = 0.0
    dampening: float = 0.0
    weight_decay: float = 0.0
    nesterov: bool = False
    wd_after_momentum: bool = False

    def init(self, params, shard=None, prefetch=None) -> FlatState:
        return _init_state(self, params, shard=shard, prefetch=prefetch)

    def init_slots(self, master, *, sizes) -> dict:
        return {"momentum_buffer": torch.zeros_like(master),
                "seeded": torch.zeros((), dtype=torch.float32,
                                      device=master.device)}

    def update(self, state: FlatState, flat_grads, *, noop_flag=0.0,
               grad_scale=1.0, lr=None, momentum=None, dampening=None,
               weight_decay=None) -> FlatState:
        t = state.count + 1.0
        seeded = state.slots["seeded"]
        noop = _scalar(noop_flag, state.master.device)
        _, buf = fused_sgd_flat(
            state.master, flat_grads, state.slots["momentum_buffer"],
            lr=self.lr if lr is None else lr,
            momentum=self.momentum if momentum is None else momentum,
            dampening=self.dampening if dampening is None else dampening,
            weight_decay=(self.weight_decay if weight_decay is None
                          else weight_decay),
            nesterov=self.nesterov,
            wd_after_momentum=self.wd_after_momentum,
            first_run=1.0 - seeded, noop_flag=noop, grad_scale=grad_scale)
        applied = 1.0 - (noop > 0.0).to(torch.float32)
        return state.replace(
            count=t, slots={"momentum_buffer": buf,
                            "seeded": torch.maximum(seeded, applied)})


@dataclasses.dataclass(frozen=True)
class _NovoGradTx:
    """Functional FusedNovoGrad: per-tensor ||g||^2-EMA second moments
    (``exp_avg_sq`` has one scalar per leaf — needs ``state.sizes``).

    Plain PyTorch (the JAX rule reaches no Pallas kernel), written as the
    JAX rule is: its flat-sized temporaries are XLA's to fuse there and
    are real here."""
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    bias_correction: bool = True
    grad_averaging: bool = True
    init_zero: bool = False

    def init(self, params, shard=None, prefetch=None) -> FlatState:
        return _init_state(self, params, shard=shard, prefetch=prefetch)

    def init_slots(self, master, *, sizes) -> dict:
        return {"exp_avg": torch.zeros_like(master),
                "exp_avg_sq": torch.zeros((len(sizes),), dtype=torch.float32,
                                          device=master.device)}

    def update(self, state: FlatState, flat_grads, *, noop_flag=0.0,
               grad_scale=1.0, lr=None, beta1=None, beta2=None, eps=None,
               weight_decay=None) -> FlatState:
        t = state.count + 1.0
        p = state.master
        m, v = state.slots["exp_avg"], state.slots["exp_avg_sq"]
        dev = p.device
        b1 = _scalar(self.beta1 if beta1 is None else beta1, dev)
        b2 = _scalar(self.beta2 if beta2 is None else beta2, dev)
        g32 = flat_grads.float() * _scalar(grad_scale, dev)
        gsq = torch.stack([torch.sum(torch.square(g32[off:off + size]))
                           for _, off, size in _leaves(state)])
        first = t <= 1.0
        v_init = torch.zeros_like(gsq) if self.init_zero else gsq
        v_new = torch.where(first, v_init, b2 * v + (1.0 - b2) * gsq)
        denom = broadcast_leaf_scalars(
            torch.sqrt(v_new) + _scalar(self.eps if eps is None else eps,
                                        dev), state.sizes)
        ghat = g32 / denom + _scalar(
            self.weight_decay if weight_decay is None else weight_decay,
            dev) * p
        coef = (1.0 - b1) if self.grad_averaging else 1.0
        m_new = b1 * m + coef * ghat
        lr_ = _scalar(self.lr if lr is None else lr, dev)
        step_size = (lr_ / (1.0 - torch.pow(b1, t)) if self.bias_correction
                     else lr_)
        p_new = p - step_size * m_new
        skip = _scalar(noop_flag, dev) > 0
        for buf, new in ((p, p_new), (m, m_new), (v, v_new)):
            buf.copy_(torch.where(skip, buf, new))
        return state.replace(count=t)


@dataclasses.dataclass(frozen=True)
class _AdagradTx:
    """Functional FusedAdagrad (kernel: :func:`fused_adagrad_flat`)."""
    lr: float = 1e-2
    eps: float = 1e-10
    weight_decay: float = 0.0
    w_mode: bool = False

    def init(self, params, shard=None, prefetch=None) -> FlatState:
        return _init_state(self, params, shard=shard, prefetch=prefetch)

    def init_slots(self, master, *, sizes) -> dict:
        return {"sum": torch.zeros_like(master)}

    def update(self, state: FlatState, flat_grads, *, noop_flag=0.0,
               grad_scale=1.0, lr=None, eps=None,
               weight_decay=None) -> FlatState:
        t = state.count + 1.0
        fused_adagrad_flat(
            state.master, flat_grads, state.slots["sum"],
            lr=self.lr if lr is None else lr,
            eps=self.eps if eps is None else eps,
            weight_decay=(self.weight_decay if weight_decay is None
                          else weight_decay),
            w_mode=self.w_mode, noop_flag=noop_flag, grad_scale=grad_scale)
        return state.replace(count=t)


# -- factories (constructor-parity argument names) ---------------------------

def fused_adam(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
               adam_w_mode=True, bias_correction=True) -> _AdamTx:
    return _AdamTx(lr=float(lr), beta1=float(betas[0]),
                   beta2=float(betas[1]), eps=float(eps),
                   weight_decay=float(weight_decay),
                   adam_w_mode=bool(adam_w_mode),
                   bias_correction=bool(bias_correction))


def fused_lamb(lr=1e-3, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
               max_grad_norm=1.0, bias_correction=True,
               grad_averaging=True, use_nvlamb=False) -> _LambTx:
    return _LambTx(lr=float(lr), beta1=float(betas[0]),
                   beta2=float(betas[1]), eps=float(eps),
                   weight_decay=float(weight_decay),
                   max_grad_norm=float(max_grad_norm or 0.0),
                   bias_correction=bool(bias_correction),
                   grad_averaging=bool(grad_averaging),
                   use_nvlamb=bool(use_nvlamb))


def fused_sgd(lr, momentum=0.0, dampening=0.0, weight_decay=0.0,
              nesterov=False, wd_after_momentum=False) -> _SgdTx:
    return _SgdTx(lr=float(lr), momentum=float(momentum),
                  dampening=float(dampening),
                  weight_decay=float(weight_decay),
                  nesterov=bool(nesterov),
                  wd_after_momentum=bool(wd_after_momentum))


def fused_novograd(lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                   weight_decay=0.0, bias_correction=True,
                   grad_averaging=True, init_zero=False) -> _NovoGradTx:
    return _NovoGradTx(lr=float(lr), beta1=float(betas[0]),
                       beta2=float(betas[1]), eps=float(eps),
                       weight_decay=float(weight_decay),
                       bias_correction=bool(bias_correction),
                       grad_averaging=bool(grad_averaging),
                       init_zero=bool(init_zero))


def fused_adagrad(lr=1e-2, eps=1e-10, weight_decay=0.0,
                  adagrad_w_mode=False) -> _AdagradTx:
    return _AdagradTx(lr=float(lr), eps=float(eps),
                      weight_decay=float(weight_decay),
                      w_mode=bool(adagrad_w_mode))
