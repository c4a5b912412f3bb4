"""Shared machinery of the fused optimizers.

Port of the dense half of ``apex_tpu/optimizers/base.py``: the per-leaf
broadcast the flat rules use where a scalar per tensor meets the flat
buffer, and the class API, :class:`FusedOptimizerBase`, the stateful
torch-parity shell over the functional rules of
:mod:`apex_tpu_torch.optimizers.functional` that ``FusedAdam`` and its
siblings subclass.  Parameters that are ``torch.nn.Parameter``s
(``FusedAdam(model.parameters())``) go to the torch-mode twins of
:mod:`apex_tpu_torch.optimizers._torch_mode`; any other tree of tensors
stays with the class itself.  The ZeRO span helpers
(``shard_leaf_spans`` and friends) come with the sharded state (ROADMAP
queue 1, item 6).
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from apex_tpu_torch.utils import tree_leaves_with_path, tree_ravel

__all__ = ["broadcast_leaf_scalars", "FusedOptimizerBase"]


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
