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

**ZeRO** (``make_train_step(zero=True)`` over a state from
``init_train_state(..., shard=(axis_name, dp))``), in JAX's algebra,
one process a rank: the rank's fp32 master SHARD is cast to the flat
dtype and all-gathered in that dtype (one gather a span, in span
order, under the prefetch layout), each gathered span un-padded into
the model's flat parameter buffer; the backward fills the flat grad
buffer; the grads are cast to the flat dtype span by span, zero-padded
and reduce-scattered in that dtype (the transpose of the gather), cast
to fp32 and divided by dp.  Then ``grad_transform``, the unscale with
the overflow flag all-reduced (``MAX``) over the group, the rule's
update of the shard and the scale update.  The reported loss, and the
float leaves of ``aux``, are averaged over the group; integer and bool
leaves of ``aux`` stay rank-local.

Not ported yet: ``numerics=`` and the instrumented loop (ROADMAP queue
1, item 7).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.amp.scaler import (LossScaleState, init_loss_scale,
                                       unscale_flat_grads, update_scale)
from apex_tpu_torch.optimizers.functional import FlatState
from apex_tpu_torch.parallel import _comm
from apex_tpu_torch.utils import round_up, tree_leaves_with_path

__all__ = ["FlatParams", "TrainState", "init_train_state",
           "init_zero_train_state", "make_train_step", "train_loop",
           "leaf_offsets", "zero_prefetch_default"]


def zero_prefetch_default() -> int:
    """Effective ``APEX_TPU_ZERO_PREFETCH``: the number of prefetch gather
    spans a ZeRO state is built with when ``prefetch`` is not passed.
    0/1 keep the one contiguous block."""
    return int(os.environ.get("APEX_TPU_ZERO_PREFETCH", "0"))

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
        # the flat fp32 grads of cast_grads, made at its first call (a
        # ZeRO step casts span by span and never needs them)
        self.flat_grads: Optional[torch.Tensor] = None
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
        self.load_from(master[start:stop], start)

    def load_from(self, src: torch.Tensor, start: int) -> None:
        """Cast ``src``, the flat elements ``[start, start + len(src))``
        of the layout (a gathered span, say), into the parameter buffer:
        one copy per run it touches, none for a run that is a view of the
        master."""
        stop = start + src.numel()
        with torch.no_grad():
            for r, view, alias in zip(self.runs, self._param_runs,
                                      self._aliased):
                lo, hi = max(r.start, start), min(r.stop, stop)
                if lo < hi and not alias:
                    view[lo - r.start:hi - r.start].copy_(
                        src[lo - start:hi - start])

    def zero_grad(self) -> None:
        """Zero the grad buffer and make every leaf's grad its view."""
        self.grad_bytes.zero_()
        for p, gv in zip(self.leaves, self.grad_views):
            p.grad = gv

    def cast_grads(self) -> torch.Tensor:
        """The flat fp32 grads: the cast of the grad buffer (one copy per
        run) into a persistent fp32 buffer, which is returned."""
        if self.flat_grads is None:
            self.flat_grads = torch.empty(self.numel, dtype=torch.float32,
                                          device=self.grad_bytes.device)
        self.cast_grads_into(self.flat_grads, 0)
        return self.flat_grads

    def cast_grads_into(self, dst: torch.Tensor, start: int) -> None:
        """Cast the grad buffer's flat elements ``[start, start +
        len(dst))`` into ``dst`` (of any float dtype): one copy per run
        they touch."""
        stop = start + dst.numel()
        with torch.no_grad():
            for r, view in zip(self.runs, self._grad_runs):
                lo, hi = max(r.start, start), min(r.stop, stop)
                if lo < hi:
                    dst[lo - start:hi - start].copy_(
                        view[lo - r.start:hi - r.start])


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
    ``"dynamic"``, or a fixed float.

    ``shard=(axis_name, dp[, rank])`` builds a ZeRO dp-sharded optimizer
    state (this rank's shard; see
    :class:`~apex_tpu_torch.optimizers.functional.FlatState`) for
    ``make_train_step(..., zero=True)``; the model keeps its full
    parameter and grad buffers.  ``prefetch`` (with ``shard``) selects
    the prefetch layout: this many gather spans along leaf boundaries,
    or a tuple of per-span leaf counts; ``None`` reads
    :func:`zero_prefetch_default`."""
    if not isinstance(params, torch.nn.Module):
        raise TypeError("init_train_state takes the model (an nn.Module): "
                        "the flat-native step rebinds its parameters")
    if shard is not None and prefetch is None:
        prefetch = zero_prefetch_default()
    opt = tx.init(params, shard=shard, prefetch=prefetch)
    flat = FlatParams(params)
    if flat.numel != opt.global_numel:
        raise AssertionError("flat layout and master disagree")
    scaler = (None if loss_scale is None
              else init_loss_scale(loss_scale, device=opt.master.device))
    return TrainState(opt=opt, scaler=scaler, flat=flat)


def init_zero_train_state(tx, params, axis_name, dp: int,
                          loss_scale=None, prefetch=None):
    """This rank's ZeRO state and the map of what is sharded.

    JAX returns the GLOBAL view (full padded buffers) and its
    ``PartitionSpec`` tree for ``shard_map`` to split.  Each process here
    holds only its own shard, so this returns ``(state, specs)``:
    ``state`` is :func:`init_train_state` with ``shard=(axis_name,
    dp)`` (the rank's ``1/dp`` of master and flat slots, numbers equal
    to JAX's rank-r slice of its global view), and ``specs`` mirrors
    it, naming ``axis_name`` for each dp-sharded buffer and ``None``
    for each replicated one.  The global master is reassembled by
    ``state.opt.full_master()`` (and the params tree by
    ``state.params()``), all-gathers every rank calls."""
    state = init_train_state(tx, params, loss_scale=loss_scale,
                             shard=(axis_name, int(dp)), prefetch=prefetch)
    opt = state.opt

    def spec(t):
        return axis_name if t.dim() == 1 and \
            t.shape[0] == opt.shard_len and opt.shard_dp > 1 else None

    specs = {"opt": {"master": spec(opt.master), "count": None,
                     "slots": {k: spec(v) for k, v in opt.slots.items()}},
             "scaler": None}
    return state, specs


def _pmean_float_leaves(aux, group):
    """Average the floating tensors of an aux tree over ``group`` (new
    tensors); integer and bool leaves pass through."""
    if isinstance(aux, dict):
        return {k: _pmean_float_leaves(v, group) for k, v in aux.items()}
    if isinstance(aux, (list, tuple)):
        return type(aux)(_pmean_float_leaves(v, group) for v in aux)
    if isinstance(aux, torch.Tensor) and (aux.is_floating_point()
                                          or aux.is_complex()):
        out = _comm.all_reduce(aux.detach().clone(), group)
        return out / dist.get_world_size(group)
    return aux


def _zero_gather(opt: FlatState, flat: FlatParams, group) -> None:
    """The rank's master shard, cast to the flat dtype, all-gathered span
    by span and each span un-padded into the parameter buffer."""
    dp, off = opt.shard_dp, 0
    for start, size, padded in opt.span_windows():
        lk = padded // dp
        piece = opt.master[off:off + lk].to(opt.flat_dtype)
        full = piece.new_empty(padded)
        _comm.all_gather(full, piece, group)
        flat.load_from(full[:size], start)
        off += lk
        del full


def _zero_scatter(opt: FlatState, flat: FlatParams, group) -> torch.Tensor:
    """The grad buffer cast to the flat dtype span by span, zero-padded,
    reduce-scattered in that dtype into the rank's shard, cast to fp32
    and divided by dp: the rank's fp32 grad shard."""
    dp, off = opt.shard_dp, 0
    shard = torch.empty(opt.shard_len, dtype=opt.flat_dtype,
                        device=opt.master.device)
    for start, size, padded in opt.span_windows():
        lk = padded // dp
        full = shard.new_zeros(padded)
        flat.cast_grads_into(full[:size], start)
        _comm.reduce_scatter(shard[off:off + lk], full, group)
        off += lk
        del full
    return shard.float().div_(dp)


def make_train_step(loss_fn, tx, *, has_aux: bool = False,
                    grad_transform: Optional[Callable] = None,
                    zero: bool = False, numerics: bool = False):
    """Build ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(model, batch)`` runs the model (whose parameters the step
    has just loaded from the master) and returns a scalar loss, or
    ``(loss, aux)`` with ``has_aux=True``.  ``metrics`` is the UNSCALED
    loss (or ``(loss, aux)``), a device tensor.

    ``grad_transform(flat_grads)`` runs between the backward and the
    unscale, on the flat fp32 grads, and must stay on the device (a
    :class:`~apex_tpu_torch.parallel.DistributedDataParallel`'s
    ``reduce_gradients``, say).  Under ``zero=True`` it receives the
    rank's grad SHARD, already averaged over the group.

    ``zero=True`` is the ZeRO-sharded step (see the module docstring):
    the state's optimizer must be dp-sharded
    (``init_train_state(..., shard=(axis_name, dp))``) and every rank of
    the group runs the step.  The update kernels touch the rank's
    ``1/dp`` of master and slots; the loss and the float leaves of
    ``aux`` are averaged over the group.

    The master and the optimizer slots are updated in place; the
    returned state holds the same buffers with the new count and scaler
    state."""
    if numerics:
        raise NotImplementedError(
            "the in-step numerics probes (numerics=True) are not ported "
            "yet (ROADMAP queue 1, item 7)")

    def step(state: TrainState, batch):
        opt, scaler, flat = state.opt, state.scaler, state.flat
        if flat is None:
            raise ValueError("the state has no model binding: build it "
                             "with init_train_state(tx, model)")
        if zero and not opt.shard:
            raise ValueError(
                "make_train_step(zero=True) needs a dp-sharded state: "
                "init_train_state(tx, params, shard=(axis_name, dp))")
        if not zero and opt.shard and opt.shard_dp > 1:
            raise ValueError(
                "a dp-sharded state holds this rank's shard alone: step it "
                "with make_train_step(zero=True)")
        group =opt.group() if zero and opt.shard_dp > 1 else None
        if group is not None:
            _zero_gather(opt, flat, group)
        else:
            flat.load(opt.master)
        flat.zero_grad()
        out = loss_fn(flat.module, batch)
        loss, aux = out if has_aux else (out, None)
        # the scaled loss drives the backward; the raw loss is the metric
        scaled = loss if scaler is None else loss * scaler.loss_scale.to(
            loss.dtype)
        scaled.backward()
        if group is not None:
            flat_g = _zero_scatter(opt, flat, group)
        else:
            flat_g = flat.cast_grads()
        if grad_transform is not None:
            flat_g = grad_transform(flat_g)
        if scaler is not None:
            flat_g, scaler = unscale_flat_grads(flat_g, scaler,
                                                axis_name=group)
            new_opt = tx.update(opt, flat_g, noop_flag=scaler.found_inf)
            scaler = update_scale(scaler)
        else:
            new_opt = tx.update(opt, flat_g)
        loss = loss.detach()
        if group is not None:
            loss = _comm.all_reduce(loss.clone(), group) / opt.shard_dp
            if aux is not None:
                aux = _pmean_float_leaves(aux, group)
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
