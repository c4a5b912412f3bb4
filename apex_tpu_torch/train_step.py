"""Flat-native train step: forward, backward, loss scaler and fused
update over one flat fp32 master.

Port of the dense path of ``apex_tpu/train_step.py``.  The JAX step
keeps the flat fp32 master as the differentiation variable — the
forward reads ``unravel(flat.astype(flat_dtype))`` and autodiff
produces flat gradients, with no per-leaf grad concatenate anywhere.
PyTorch has no such transform, so the port builds the same property
from buffers (:class:`FlatParams`):

* the model's parameters are views of ONE flat parameter buffer, laid
  out in the flax tree's leaf order, in each leaf's construction dtype
  (bf16 linears, fp32 norm weights); each step casts the fp32 master
  into it, one copy per run of same-dtype leaves (one copy when every
  leaf shares a dtype);
* their ``.grad``s are views of ONE flat grad buffer of the same
  layout, zeroed once per step, into which autograd accumulates in
  place;
* the flat fp32 grads are the cast of that buffer (again one copy per
  run) — what JAX's cotangent through ``astype`` is.

The torch-mode optimizers (``FusedAdam(model.parameters())``) bind each
param group with the same :class:`FlatParams`.

amp runs on the device: the loss is scaled before the backward, the
flat grads are unscaled in place by the fused non-finite-detecting
kernel (:func:`apex_tpu_torch.amp.scaler.unscale_flat_grads`), the
overflow flag is the update's ``noop_flag``, and the scale schedule
is device arithmetic — nothing is read back to the host between the
end of the backward and the new state.  The step is rule-agnostic: it
calls ``tx.update(opt, flat_grads, noop_flag=...)``, so any rule of
:mod:`apex_tpu_torch.optimizers.functional` (Adam, LAMB, SGD,
NovoGrad, Adagrad) drives it, and ``grad_transform`` may be the grad
clipper (``lambda g: contrib.clip_grad_norm_(g, 1.0)[0]``).

Typical use::

    model = llama_model_provider(cfg)                 # on the card
    tx = functional.fused_adam(lr=1e-4)               # or fused_lamb(...)
    state = init_train_state(tx, model, loss_scale="dynamic")
    step = make_train_step(lambda m, b: m(b["tokens"], b["labels"]), tx)
    state, loss = step(state, batch)
    final_params = state.params()                     # checkpoint boundary

Not ported yet: ``zero=True`` (ROADMAP queue 1, item 6), ``numerics=``
and the instrumented loop (item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from apex_tpu_torch.amp.scaler import (LossScaleState, init_loss_scale,
                                       unscale_flat_grads, update_scale)
from apex_tpu_torch.optimizers.functional import FlatState
from apex_tpu_torch.utils import round_up, tree_leaves_with_path

__all__ = ["FlatParams", "TrainState", "init_train_state",
           "make_train_step", "train_loop", "leaf_offsets"]

#: byte alignment of each same-dtype run inside the flat buffers
_RUN_ALIGN = 256


@dataclasses.dataclass(frozen=True)
class _Run:
    dtype: torch.dtype
    start: int          # first element of the run in the flat master
    stop: int
    byte_offset: int    # where the run starts in the byte buffers


class FlatParams:
    """Rebinds parameters to views of one flat parameter buffer and their
    grads to views of one flat grad buffer, both laid out in leaf order:
    the flax tree's (:func:`tree_leaves_with_path`) for a module, the
    list's own for a list of parameters (an optimizer's param group).

    Consecutive leaves of one dtype form a run; the buffers are bytes,
    each run starting at a 256-byte boundary and holding its leaves in
    their own dtype.

    ``master``, a flat fp32 buffer of the same element layout, makes
    every fp32 leaf a view of its slice of the master (the parameter IS
    its master, as in the torch-mode optimizers); :meth:`load` then
    copies only the other runs."""

    def __init__(self, params, master: Optional[torch.Tensor] = None):
        self.module = params if isinstance(params, torch.nn.Module) else None
        self.leaves = [p for _, p in tree_leaves_with_path(params)]
        if not self.leaves:
            raise ValueError("there are no parameters to bind")
        if len({id(p) for p in self.leaves}) != len(self.leaves):
            raise ValueError("a parameter appears twice in the leaves")
        device = self.leaves[0].device
        runs: List[_Run] = []
        elem, nbytes = 0, 0
        for p in self.leaves:
            if p.device != device:
                raise ValueError("every parameter must be on one device")
            if not runs or runs[-1].dtype != p.dtype:
                nbytes = round_up(nbytes, _RUN_ALIGN)
                runs.append(_Run(p.dtype, elem, elem, nbytes))
            n = p.numel()
            r = runs[-1]
            runs[-1] = dataclasses.replace(r, stop=r.stop + n)
            elem += n
            nbytes += n * p.element_size()
        self.runs = tuple(runs)
        self.numel = elem
        if master is not None and (master.dtype != torch.float32
                                   or master.shape != (elem,)):
            raise ValueError(f"master must be a flat fp32 buffer of {elem} "
                             f"elements")
        self._aliased = [master is not None and r.dtype == torch.float32
                         for r in runs]
        self.param_bytes = None if all(self._aliased) else torch.empty(
            round_up(nbytes, _RUN_ALIGN), dtype=torch.uint8, device=device)
        self.grad_bytes = torch.zeros(round_up(nbytes, _RUN_ALIGN),
                                      dtype=torch.uint8, device=device)
        self._param_runs = [
            master[r.start:r.stop] if alias
            else self._run_view(self.param_bytes, r)
            for r, alias in zip(runs, self._aliased)]
        self._grad_runs = [self._run_view(self.grad_bytes, r) for r in runs]
        self.flat_grads = torch.empty(elem, dtype=torch.float32,
                                      device=device)
        self.grad_views: List[torch.Tensor] = []
        self._bind()

    @staticmethod
    def _run_view(buf: torch.Tensor, r: _Run) -> torch.Tensor:
        es = torch.empty((), dtype=r.dtype).element_size()
        n = r.stop - r.start
        return buf[r.byte_offset:r.byte_offset + n * es].view(r.dtype)

    def _bind(self) -> None:
        run_i, elem = 0, 0
        with torch.no_grad():
            for p in self.leaves:
                while elem >= self.runs[run_i].stop:
                    run_i += 1
                r = self.runs[run_i]
                lo, hi = elem - r.start, elem - r.start + p.numel()
                pv = self._param_runs[run_i][lo:hi].view(p.shape)
                gv = self._grad_runs[run_i][lo:hi].view(p.shape)
                pv.copy_(p)
                if p.grad is not None:
                    gv.copy_(p.grad)
                p.data = pv
                p.grad = gv
                self.grad_views.append(gv)
                elem += p.numel()

    def load(self, master: torch.Tensor, start: int = 0,
             stop: Optional[int] = None) -> None:
        """Cast the fp32 master's elements ``[start, stop)`` (all of them
        by default) into the parameter buffer: one copy per run they
        touch, none for a run that is a view of the master."""
        stop = self.numel if stop is None else stop
        with torch.no_grad():
            for r, view, alias in zip(self.runs, self._param_runs,
                                      self._aliased):
                lo, hi = max(r.start, start), min(r.stop, stop)
                if lo < hi and not alias:
                    view[lo - r.start:hi - r.start].copy_(master[lo:hi])

    def zero_grad(self) -> None:
        """Zero the grad buffer and make every leaf's grad its view."""
        self.grad_bytes.zero_()
        for p, gv in zip(self.leaves, self.grad_views):
            p.grad = gv

    def cast_grads(self) -> torch.Tensor:
        """The flat fp32 grads: the cast of the grad buffer (one copy per
        run) into a persistent fp32 buffer, which is returned."""
        with torch.no_grad():
            for r, view in zip(self.runs, self._grad_runs):
                self.flat_grads[r.start:r.stop].copy_(view)
        return self.flat_grads


@dataclasses.dataclass(frozen=True)
class TrainState:
    """Train-loop state: the flat optimizer state, the (optional)
    loss-scaler state and the model's flat parameter binding."""
    opt: FlatState
    scaler: Optional[LossScaleState] = None
    flat: Optional[FlatParams] = None

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)

    def params(self) -> dict:
        """Materialize the params tree (checkpoint/eval boundary)."""
        return self.opt.params()


def init_train_state(tx, params, loss_scale=None, shard=None,
                     prefetch=None) -> TrainState:
    """Build a :class:`TrainState` from a model (``nn.Module``): the
    fp32 master from its parameters in the flax tree's leaf order, and
    its parameters rebound to views of the flat buffers
    (:class:`FlatParams`).  ``loss_scale``: None (no scaling),
    ``"dynamic"``, or a fixed float."""
    if not isinstance(params, torch.nn.Module):
        raise TypeError("init_train_state takes the model (an nn.Module): "
                        "the flat-native step rebinds its parameters")
    opt = tx.init(params, shard=shard, prefetch=prefetch)
    flat = FlatParams(params)
    if flat.numel != opt.global_numel:
        raise AssertionError("flat layout and master disagree")
    scaler = (None if loss_scale is None
              else init_loss_scale(loss_scale, device=opt.master.device))
    return TrainState(opt=opt, scaler=scaler, flat=flat)


def make_train_step(loss_fn, tx, *, has_aux: bool = False,
                    grad_transform: Optional[Callable] = None,
                    zero: bool = False, numerics: bool = False):
    """Build ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(model, batch)`` runs the model (whose parameters the step
    has just loaded from the master) and returns a scalar loss, or
    ``(loss, aux)`` with ``has_aux=True``.  ``metrics`` is the UNSCALED
    loss (or ``(loss, aux)``), a device tensor.

    ``grad_transform(flat_grads)`` runs between the backward and the
    unscale, on the flat fp32 grads, and must stay on the device.

    The master and the optimizer slots are updated in place; the
    returned state holds the same buffers with the new count and scaler
    state."""
    if zero:
        raise NotImplementedError(
            "the ZeRO-sharded step (zero=True) is not ported yet (ROADMAP "
            "queue 1, item 6)")
    if numerics:
        raise NotImplementedError(
            "the in-step numerics probes (numerics=True) are not ported "
            "yet (ROADMAP queue 1, item 7)")

    def step(state: TrainState, batch):
        opt, scaler, flat = state.opt, state.scaler, state.flat
        if flat is None:
            raise ValueError("the state has no model binding: build it "
                             "with init_train_state(tx, model)")
        flat.load(opt.master)
        flat.zero_grad()
        out = loss_fn(flat.module, batch)
        loss, aux = out if has_aux else (out, None)
        # the scaled loss drives the backward; the raw loss is the metric
        scaled = loss if scaler is None else loss * scaler.loss_scale.to(
            loss.dtype)
        scaled.backward()
        flat_g = flat.cast_grads()
        if grad_transform is not None:
            flat_g = grad_transform(flat_g)
        if scaler is not None:
            flat_g, scaler = unscale_flat_grads(flat_g, scaler)
            new_opt = tx.update(opt, flat_g, noop_flag=scaler.found_inf)
            scaler = update_scale(scaler)
        else:
            new_opt = tx.update(opt, flat_g)
        loss = loss.detach()
        metrics = (loss, aux) if has_aux else loss
        return state.replace(opt=new_opt, scaler=scaler), metrics

    return step


def train_loop(loss_fn, tx, **step_kwargs):
    """``run(state, batches) -> (state, metrics)``: the step over each
    batch in turn (the JAX package scans them in one program; PyTorch
    runs eagerly).  ``batches`` is a sequence of batches; ``metrics`` the
    list of per-step metrics (device tensors)."""
    step = make_train_step(loss_fn, tx, **step_kwargs)

    def run(state: TrainState, batches):
        metrics = []
        for batch in batches:
            state, m = step(state, batch)
            metrics.append(m)
        return state, metrics

    return run


def leaf_offsets(tree) -> "dict[str, tuple[int, int, tuple]]":
    """``{keystr: (offset, size, shape)}`` of each leaf inside the
    raveled flat buffer, in the flat layout's leaf order.  The keys are
    spelled as ``jax.tree_util.keystr`` spells them (``['a']['b']``,
    ``[0]`` for a list index), so the JAX package gives the same dict
    for the same tree.

    The flat-native escape hatch for per-leaf grad fixups (tied
    embeddings): slice the leaf out of the flat grads, fix it, write it
    back, with no tree round-trip."""
    out, off = {}, 0
    for path, leaf in tree_leaves_with_path(tree):
        size = leaf.numel()
        out["".join(f"[{k!r}]" for k in path)] = (off, size,
                                                  tuple(leaf.shape))
        off += size
    return out
