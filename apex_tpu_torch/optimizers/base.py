"""Shared machinery of the fused optimizers.

Port of ``apex_tpu/optimizers/base.py``: the per-leaf broadcast the
flat rules use where a scalar per tensor meets the flat buffer, the
ZeRO span helpers that do the same for one rank's shard of it
(:func:`shard_leaf_spans`, :func:`prefetch_leaf_spans`,
:func:`sharded_leaf_reduce` and its square-norm and nonfinite-count
forms, :func:`sharded_leaf_broadcast`), and the class API,
:class:`FusedOptimizerBase`, the stateful torch-parity shell over the
functional rules of :mod:`apex_tpu_torch.optimizers.functional` that
``FusedAdam`` and its siblings subclass.  Parameters that are
``torch.nn.Parameter``s (``FusedAdam(model.parameters())``) go to the
torch-mode twins of :mod:`apex_tpu_torch.optimizers._torch_mode`; any
other tree of tensors stays with the class itself.

The JAX span helpers take the rank as a traced value and pick its spans
with a ``lax.switch`` over every rank (above ``_SWITCH_MAX_DP`` ranks,
with sums over a zero-padded global buffer instead).  A process here
knows its rank on the host, so the helpers walk that rank's own static
spans; the caller all-reduces the partials over the group.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from apex_tpu_torch.utils import cdiv, tree_leaves_with_path, tree_ravel

__all__ = ["FusedOptimizerBase", "broadcast_leaf_scalars",
           "shard_leaf_spans", "prefetch_leaf_spans",
           "sharded_leaf_reduce", "sharded_leaf_sq_norms",
           "sharded_leaf_nonfinite_counts", "sharded_leaf_broadcast"]


def broadcast_leaf_scalars(scalars: torch.Tensor,
                           sizes: Sequence[int]) -> torch.Tensor:
    """Expand a ``(num_leaves,)`` vector to a flat per-element buffer:
    element ``j`` of leaf ``i`` holds ``scalars[i]``.  Built from static
    broadcasts and one concatenate, on the scalars' device, with no
    read back to the host."""
    if not sizes:
        return torch.zeros((0,), dtype=scalars.dtype, device=scalars.device)
    return torch.cat([scalars[i].expand(int(s))
                      for i, s in enumerate(sizes)])


def shard_leaf_spans(sizes: Sequence[int], dp: int, shard_len: int):
    """Static leaf spans per rank: ``spans[r]`` lists ``(leaf_id, lo,
    hi)``, the intersection of each leaf's ``[offset, offset+size)`` with
    rank r's padded shard window, in shard-local coordinates.  The
    padding tail is covered by no span."""
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + int(s))
    spans = []
    for r in range(dp):
        start, end = r * shard_len, (r + 1) * shard_len
        spans.append([(i, max(o, start) - start, min(o + int(s), end) - start)
                      for i, (o, s) in enumerate(zip(offs, sizes))
                      if min(o + int(s), end) > max(o, start)])
    return spans


def prefetch_leaf_spans(sizes: Sequence[int], span_leaves: Sequence[int],
                        dp: int):
    """Per-rank leaf spans for the ZeRO *prefetch* shard layout
    (``FlatState.spans``): each gather span (a group of consecutive
    leaves, padded to a ``dp`` multiple) is split ``1/dp`` and rank r's
    shard is the concatenation of its slice of every span.  The same
    ``spans[r] = [(leaf_id, lo, hi)]`` structure as
    :func:`shard_leaf_spans`, with padding gaps that can be INTERIOR
    (each span's tail)."""
    sizes = [int(s) for s in sizes]
    out = [[] for _ in range(dp)]
    leaf0 = 0
    shard_off = 0                      # shard-local offset of this span
    for count in span_leaves:
        group = sizes[leaf0:leaf0 + count]
        lk = cdiv(sum(group), dp)      # per-rank slice of this span
        offs = [0]
        for s in group:
            offs.append(offs[-1] + s)
        for r in range(dp):
            start, end = r * lk, (r + 1) * lk
            for j, (o, s) in enumerate(zip(offs, group)):
                lo, hi = max(o, start), min(o + s, end)
                if hi > lo:
                    out[r].append((leaf0 + j, shard_off + lo - start,
                                   shard_off + hi - start))
        leaf0 += count
        shard_off += lk
    return out


def rank_spans(sizes: Sequence[int], *, dp: int, shard_len: int, rank: int,
               spans=None):
    """``(leaf_id, lo, hi)`` windows of ``rank``'s shard, in shard order:
    the block layout's (:func:`shard_leaf_spans`) or, given the
    per-span leaf counts ``spans``, the prefetch layout's
    (:func:`prefetch_leaf_spans`)."""
    sizes = [int(s) for s in sizes]
    if not 0 <= int(rank) < dp:
        raise ValueError(f"rank {rank} is outside dp = {dp}")
    if spans:
        return prefetch_leaf_spans(sizes, tuple(spans), dp)[int(rank)]
    return shard_leaf_spans(sizes, dp, shard_len)[int(rank)]


def sharded_leaf_reduce(vecs: Sequence[torch.Tensor], sizes: Sequence[int],
                        *, dp: int, shard_len: int, rank: int, spans=None,
                        elem_fn) -> torch.Tensor:
    """``[len(vecs), n_leaves]`` per-tensor partial SUMS of
    ``elem_fn(shard slice)`` over ``rank``'s shard of each flat vector,
    in the static leaf-span layout (``spans``: the per-span leaf counts
    of the prefetch layout; ``None``: the contiguous block).  The caller
    all-reduces the result over the group for the global per-leaf sums.

    ``elem_fn`` maps a 1-D slice to values summed per leaf in fp32 (or
    is a sequence of such callables, one per vector); it must send 0 to
    0, as in JAX, whose fallback sums over a zero-padded buffer."""
    fns = (tuple(elem_fn) if isinstance(elem_fn, (list, tuple))
           else (elem_fn,) * len(vecs))
    if len(fns) != len(vecs):
        raise ValueError(f"elem_fn sequence has {len(fns)} entries for "
                         f"{len(vecs)} vectors")
    dev = vecs[0].device if vecs else None
    out = torch.zeros((len(vecs), len(sizes)), dtype=torch.float32,
                      device=dev)
    for i, lo, hi in rank_spans(sizes, dp=dp, shard_len=shard_len,
                                rank=rank, spans=spans):
        for k, (vec, fn) in enumerate(zip(vecs, fns)):
            out[k, i] += torch.sum(fn(vec[lo:hi]).float())
    return out


def _sq_f32(x):
    return torch.square(x.float())


def _nonfinite_f32(x):
    return (~torch.isfinite(x)).float()


def sharded_leaf_sq_norms(vecs: Sequence[torch.Tensor], sizes: Sequence[int],
                          *, dp: int, shard_len: int, rank: int,
                          spans=None) -> torch.Tensor:
    """``[len(vecs), n_leaves]`` per-tensor partial sums of squares of
    ``rank``'s shard of each flat vector (the layout contract of
    :func:`sharded_leaf_reduce`); the caller all-reduces them over the
    group.  Each window's sum is the square of the fused L2-norm
    kernel's norm of it (:func:`apex_tpu_torch.ops.fused_update.
    fused_l2norm`: one launch a window on the card, its plain version
    on the CPU)."""
    from apex_tpu_torch.ops.fused_update import fused_l2norm
    dev = vecs[0].device if vecs else None
    norms = torch.zeros((len(vecs), len(sizes)), dtype=torch.float32,
                        device=dev)
    for i, lo, hi in rank_spans(sizes, dp=dp, shard_len=shard_len,
                                rank=rank, spans=spans):
        for k, vec in enumerate(vecs):
            fused_l2norm(vec[lo:hi], out=norms[k, i])
    return torch.square(norms)


def sharded_leaf_nonfinite_counts(vecs: Sequence[torch.Tensor],
                                  sizes: Sequence[int], *, dp: int,
                                  shard_len: int, rank: int,
                                  spans=None) -> torch.Tensor:
    """``[len(vecs), n_leaves]`` per-tensor partial COUNTS of nonfinite
    (inf/nan) elements of ``rank``'s shard of each flat vector; padding
    is finite and never counts.  The caller all-reduces over the group."""
    return sharded_leaf_reduce(vecs, sizes, dp=dp, shard_len=shard_len,
                               rank=rank, spans=spans,
                               elem_fn=_nonfinite_f32)


def sharded_leaf_broadcast(scalars: torch.Tensor, sizes: Sequence[int], *,
                           dp: int, shard_len: int, rank: int,
                           pad_value: float = 1.0,
                           spans=None) -> torch.Tensor:
    """Shard-local :func:`broadcast_leaf_scalars`: a ``(n_leaves,)``
    vector expanded over ``rank``'s ``[shard_len]`` window of the flat
    per-element buffer, padding gaps (the block layout's tail, the
    prefetch layout's per-span tails) filled with ``pad_value``."""
    vals, span_sizes, pos = [], [], 0
    pad = torch.full((), pad_value, dtype=scalars.dtype,
                     device=scalars.device)
    for i, lo, hi in rank_spans(sizes, dp=dp, shard_len=shard_len,
                                rank=rank, spans=spans):
        if lo > pos:
            vals.append(pad)
            span_sizes.append(lo - pos)
        vals.append(scalars[i])
        span_sizes.append(hi - lo)
        pos = hi
    if pos < shard_len:
        vals.append(pad)
        span_sizes.append(shard_len - pos)
    if not vals:
        return torch.zeros((0,), dtype=scalars.dtype, device=scalars.device)
    return broadcast_leaf_scalars(torch.stack(vals), span_sizes)


def _leaf_sizes(tree) -> tuple[int, ...]:
    return tuple(int(t.numel()) for _, t in tree_leaves_with_path(tree))


def _materialize_params(params):
    """``(params, to_twin)``: generators (``model.parameters()``) are
    materialized so the probe does not consume them; ``to_twin`` is
    whether the first leaf of the first non-empty group is an
    ``nn.Parameter`` (a model's parameters, for the torch-mode twin)."""
    if params is None:
        return params, False
    if not isinstance(params, (list, tuple, dict, torch.Tensor)) \
            and hasattr(params, "__iter__"):
        params = list(params)
    probe = params
    if isinstance(params, (list, tuple)) and params \
            and isinstance(params[0], dict) and "params" in params[0]:
        # torch param-group dicts; materialize each group's params too
        params = [dict(g, params=_materialize_params(g["params"])[0])
                  for g in params]
        # probe the first NON-empty group (a decay/no-decay split can
        # legitimately leave an earlier group empty)
        probe = next((g["params"] for g in params
                      if tree_leaves_with_path(g["params"])), [])
    leaves = tree_leaves_with_path(probe)
    return params, bool(leaves) and isinstance(leaves[0][1],
                                               torch.nn.Parameter)


class _Group:
    """One parameter group: flat fp32 master + per-leaf layout info."""

    def __init__(self, params, options: dict[str, Any]):
        flat, unravel = tree_ravel(params)
        # a copy: a single fp32 leaf's ravel may alias the caller's tensor,
        # and the update writes the master in place
        self.master = flat.to(torch.float32, copy=True)
        self.unravel = unravel
        # the ravel dtype (the leaves' promoted dtype): step() casts the
        # master to it before the unravel casts each leaf to its own
        self.flat_dtype = flat.dtype
        self.sizes = _leaf_sizes(params)
        self.shapes = tuple(tuple(t.shape)
                            for _, t in tree_leaves_with_path(params))
        self.offsets = []
        off = 0
        for s in self.sizes:
            self.offsets.append(off)
            off += s
        self.numel = off
        self.options = dict(options)
        self.state: dict[str, torch.Tensor] = {}

    def params(self):
        return self.unravel(self.master.to(self.flat_dtype))

    def ravel_grads(self, grads):
        gflat, _ = tree_ravel(grads)
        return gflat


class FusedOptimizerBase:
    """Base for FusedAdam/FusedLAMB/FusedSGD/FusedNovoGrad/FusedAdagrad.

    ``params`` is a tree of tensors (nested dicts, lists, tuples), or a
    list of dicts ``{"params": tree, **per_group_overrides}`` (torch
    param-group parity, reference: ``apex/optimizers/fused_adam.py ::
    FusedAdam.__init__``).  ``nn.Parameter``s go to the torch-mode twin
    named by ``_TORCH_IMPL``.

    A step runs the group's functional rule over its flat fp32 master in
    place: on CUDA, one launch of the rule's kernel per group."""

    #: name of the torch-mode twin in ``_torch_mode`` (reference scripts
    #: pass ``model.parameters()`` to these classes)
    _TORCH_IMPL: str | None = None

    def __new__(cls, params=None, *args, **kwargs):
        kw_params = params is None and "params" in kwargs
        if kw_params:
            params = kwargs["params"]
        params, to_twin = _materialize_params(params)
        if to_twin:
            if kw_params:
                kwargs = {k: v for k, v in kwargs.items() if k != "params"}
            if cls._TORCH_IMPL is None:
                raise TypeError(
                    f"{cls.__name__} received nn.Parameters but has no "
                    "torch-mode implementation; pass a tree of tensors (or "
                    "use FusedAdam/FusedLAMB/FusedSGD, which accept both).")
            from apex_tpu_torch.optimizers import _torch_mode
            return getattr(_torch_mode, cls._TORCH_IMPL)(
                params, *args, **kwargs)
        obj = super().__new__(cls)
        # hand the (possibly materialized) params to __init__ — a
        # consumed generator can't be iterated twice
        obj.__dict__["_materialized_params"] = params
        return obj

    def __init__(self, params, defaults: dict[str, Any]):
        params = self.__dict__.pop("_materialized_params", params)
        self.defaults = dict(defaults)
        if isinstance(params, (list, tuple)) and params and \
                isinstance(params[0], dict):
            groups = []
            for g in params:
                opts = dict(defaults)
                opts.update({k: v for k, v in g.items() if k != "params"})
                groups.append(_Group(g["params"], opts))
        else:
            groups = [_Group(params, dict(defaults))]
        self.param_groups = groups
        self._step_count = 0
        for g in self.param_groups:
            g.tx = self._make_tx(g.options)
            self._init_group_state(g)

    # -- subclass interface -------------------------------------------------
    def _make_tx(self, options: dict):
        """Build the group's functional rule
        (:mod:`apex_tpu_torch.optimizers.functional`) from the STATIC
        parts of its options; per-step hyperparameters come from
        :meth:`_traced_hyper`."""
        raise NotImplementedError

    def _traced_hyper(self, options: dict, device) -> dict:
        """The group's per-step hyperparameters as 0-d fp32 tensors on
        ``device``."""
        raise NotImplementedError

    def _init_group_state(self, group: _Group) -> None:
        group.state = dict(group.tx.init_slots(group.master,
                                               sizes=tuple(group.sizes)))

    def _step_group(self, group: _Group, gflat: torch.Tensor, step: int,
                    noop_flag, grad_scale) -> None:
        """Update group.master and group.state in place — a thin
        stateful shell over the functional core: pack the group into a
        FlatState, run the rule's update, unpack."""
        from apex_tpu_torch.optimizers import functional
        # rebuild the rule from the CURRENT options: a change to a static
        # knob (bias_correction, nesterov, ...) between steps takes effect
        group.tx = self._make_tx(group.options)
        dev = group.master.device
        state = functional.FlatState(
            master=group.master,
            # update() advances the count: seed it one behind the class
            # counter so bias corrections see the identical step value
            count=torch.full((), float(step - 1), dtype=torch.float32,
                             device=dev),
            slots=group.state,
            sizes=tuple(group.sizes))
        state = group.tx.update(
            state, gflat, noop_flag=noop_flag, grad_scale=grad_scale,
            **self._traced_hyper(group.options, dev))
        group.master = state.master
        group.state = dict(state.slots)

    # -- public API ---------------------------------------------------------
    @property
    def step_count(self) -> int:
        return self._step_count

    def step(self, grads, *, noop_flag=0.0, grad_scale=1.0):
        """Apply one optimizer step.

        ``grads``: a tree matching the params (single group) or a
        sequence of trees (one per group).  ``noop_flag`` and
        ``grad_scale`` may be 0-d device tensors (an amp scaler's
        ``found_inf`` feeds ``noop_flag`` with no sync).  Returns the
        updated params (same structure and dtypes as at construction)."""
        if len(self.param_groups) == 1:
            grads_list: Sequence = [grads]
        else:
            grads_list = list(grads)
            if len(grads_list) != len(self.param_groups):
                raise ValueError(
                    f"expected {len(self.param_groups)} grad trees, got "
                    f"{len(grads_list)}")
        self._step_count += 1
        for group, g in zip(self.param_groups, grads_list):
            gflat = group.ravel_grads(g)
            self._step_group(group, gflat, self._step_count, noop_flag,
                             grad_scale)
        outs = [g.params() for g in self.param_groups]
        return outs[0] if len(outs) == 1 else outs

    def zero_grad(self, set_to_none: bool = True) -> None:
        """No-op (grads are explicit arguments of step); kept for API
        parity."""

    # -- checkpointing (parity: torch optimizer state_dict contract) --------
    def state_dict(self) -> dict:
        # copies: the buffers are updated in place by the next step, and a
        # checkpoint must outlive it
        return {
            "step": self._step_count,
            "groups": [
                {
                    "master": g.master.clone(),
                    "state": {k: v.clone() for k, v in g.state.items()},
                    "options": dict(g.options),
                }
                for g in self.param_groups
            ],
        }

    def load_state_dict(self, sd: dict) -> None:
        self._step_count = int(sd["step"])
        if len(sd["groups"]) != len(self.param_groups):
            raise ValueError("param_groups mismatch in load_state_dict")
        for g, gs in zip(self.param_groups, sd["groups"]):
            # copies: the next step updates them in place, and they must
            # not alias the checkpoint tensors the caller still holds
            dev = g.master.device
            g.master = torch.as_tensor(gs["master"]).to(
                device=dev, dtype=torch.float32, copy=True)
            g.state = {k: torch.as_tensor(v).to(device=dev, copy=True)
                       for k, v in gs["state"].items()}
            g.options.update(gs.get("options", {}))
