"""MoE layer: dense dispatch/combine and all-to-all expert parallelism.

Port of ``apex_tpu/transformer/moe/layer.py`` (GShard / Switch, with
Megatron-core's layer naming).  Routing decisions become a 0/1
``dispatch`` tensor ``[tokens, E, capacity]``; moving tokens into the
expert-major buffer is ``einsum('sec,sh->ech')`` and returning them the
gate-weighted transpose (``dispatch_mode="onehot"``), or the same slots
as gather indices that move only the ``E * C`` rows that exist
(``"gather"``; ``"auto"`` picks by the expert count,
:func:`resolve_dispatch_mode`).  Both share one slot assignment
(:func:`_slot_positions`: GShard's k-major priority, one cumsum), so they
route and drop identically.

Expert parallelism: with ``E`` experts over ``ep`` ranks of the expert
group, each rank dispatches its tokens into the global ``[E, C, h]``
buffer, one all-to-all (:func:`~apex_tpu_torch.transformer.
tensor_parallel.mappings.all_to_all`, JAX's ``split_axis=0,
concat_axis=0``) reshards it so each rank holds its ``E/ep`` experts'
slots from every rank (``[E_local, ep*C, h]``), and the inverse
all-to-all brings the expert outputs home; the backward is the mirrored
pair.  Under tensor parallelism each expert's ffn dim is sharded: the
buffer enters through ``copy_to_tensor_model_parallel_region`` and the
expert outputs are summed by ``reduce_from_...`` before the combine
(the router's grads then agree on every tensor rank); under sequence
parallelism the sequence is gathered in (``tensor_parallel_output_grad
=False``) and the output's shard sliced back out.

The JAX package's dispatch, combine and expert FFNs are ``jnp`` einsums
that XLA compiles (no Pallas kernel), so here they are PyTorch products
(``torch.einsum``, ``torch.bmm``) on the activations' device.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.parallel import _comm
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.moe.experts import (GroupedMLP, expert_init,
                                                    gelu)
from apex_tpu_torch.transformer.moe.router import TopKRouter
from apex_tpu_torch.transformer.parallel_state import (CONTEXT_AXIS,
                                                       DATA_AXIS,
                                                       EXPERT_AXIS,
                                                       TENSOR_AXIS)
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.transformer.tensor_parallel.random import fold_generator
from apex_tpu_torch.utils import round_up

__all__ = ["MoELayer", "compute_dispatch_and_combine",
           "compute_dispatch_indices", "reduce_moe_grads",
           "resolve_dispatch_mode"]


def _world(axes) -> int:
    """The size of the group over ``axes`` (names, or a group)."""
    return dist.get_world_size(parallel_state.resolve_group(axes))


def _leaves(tree, path=()):
    """``(path, tensor)`` of a nested dict of tensors; a dotted key counts
    as its parts (a flat ``named_parameters`` dict is a tree too)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + tuple(str(k).split(".")))
    else:
        yield path, tree


def reduce_moe_grads(grads, *, dense_axes=None, expert_axes=None):
    """Average an MoE grad tree over each param's replica axes, in place
    (the tree is returned).

    MoE splits the data-parallel reduction: leaves under an ``experts``
    key (the GroupedMLP weights) replicate along ``expert_axes`` only
    (the expert axis holds different experts); every other leaf (the
    router, and any dense param of the same tree) along ``dense_axes``.
    ``grads`` is a nested dict of tensors or a flat dict of dotted names
    (``model.named_parameters()``'s).

    With the default ``None`` axes both are read from the live topology:
    dense ``(data, expert[, context])``, expert
    ``parallel_state.get_expert_param_grad_axes()`` (``data[, context]``);
    without a topology they are ``(data, expert)`` and ``data``, whose
    groups then raise ``RuntimeError`` naming ``initialize_model_parallel``
    (a collective never quietly runs as one rank).  An axis name, a
    tuple of names or a ``ProcessGroup`` may be passed instead; an empty
    tuple reduces nothing.

    Each reduction is a mean (sum, then divide by the group's size).
    Expert leaves are then scaled by ``world(expert_axes) /
    world(dense_axes)``: the loss is averaged over the dense replicas but
    an expert weight has replicas only along ``expert_axes``, so the mean
    alone would be ep times the gradient and the experts would train at
    ``lr * ep``."""
    if dense_axes is None or expert_axes is None:
        live = parallel_state.model_parallel_is_initialized()
        if dense_axes is None:
            dense_axes = (DATA_AXIS, EXPERT_AXIS)
            if live and parallel_state.get_context_parallel_world_size() > 1:
                dense_axes += (CONTEXT_AXIS,)
        if expert_axes is None:
            expert_axes = (parallel_state.get_expert_param_grad_axes()
                           if live else (DATA_AXIS,))
    n_dense = _world(dense_axes) if dense_axes != () else 1
    n_expert = _world(expert_axes) if expert_axes != () else 1
    for path, g in _leaves(grads):
        if "experts" in path:
            if n_expert > 1:
                _comm.all_reduce(g, parallel_state.resolve_group(
                    expert_axes)).div_(n_expert)
            scale = n_expert / n_dense
            if scale != 1.0:
                g.mul_(scale)
        elif n_dense > 1:
            _comm.all_reduce(g, parallel_state.resolve_group(
                dense_axes)).div_(n_dense)
    return grads


def _slot_positions(expert_index, num_experts: int):
    """Both dispatch forms' slot assignment: GShard priority, (k-slot,
    token) order, one cumsum over the k-major flattened one-hot.
    ``(onehot [S, k, E], pos [S, k, E])``, ``pos`` the higher-priority
    claims on each expert."""
    s, k = expert_index.shape
    onehot = F.one_hot(expert_index.long(), num_experts).float()
    km = onehot.transpose(0, 1).reshape(k * s, num_experts)
    pos = torch.cumsum(km, dim=0) - km                   # slots before me
    pos = pos.reshape(k, s, num_experts).transpose(0, 1)
    return onehot, pos


def compute_dispatch_and_combine(gates, expert_index, num_experts: int,
                                 capacity: int):
    """Top-k routing as dense tensors: ``(dispatch, combine)`` ``[S, E,
    C]``, ``dispatch`` 0/1 (token s in slot c of expert e) and ``combine
    = gate * dispatch``.  Tokens past an expert's capacity are dropped
    (zero rows in both)."""
    onehot, pos = _slot_positions(expert_index, num_experts)
    within = onehot * (pos < capacity)                   # kept choices
    kept = within.sum(dim=1)                             # [S, E] in {0, 1}
    pos_se = (pos * within).sum(dim=1)                   # [S, E]
    gate_se = (gates[..., None] * within).sum(dim=1)     # [S, E]
    dispatch = kept[..., None] * F.one_hot(pos_se.long(), capacity).float()
    combine = gate_se[..., None] * dispatch
    return dispatch, combine


def compute_dispatch_indices(gates, expert_index, num_experts: int,
                             capacity: int):
    """The same slot assignment as :func:`compute_dispatch_and_combine`
    (identical drops) as gather indices:

    * ``slot_token`` [E, C] -- the token feeding each slot, or S (one past
      the last token) for an empty slot;
    * ``token_slot`` [S, k] -- the flat slot ``e*C + c`` of each routing
      choice, or E*C when it is dropped;
    * ``token_gate`` [S, k] -- the gate, 0 when dropped.

    The indices are int64 (JAX's int32: torch indexes with int64)."""
    s, k = gates.shape
    onehot, pos = _slot_positions(expert_index, num_experts)
    kept = (onehot * (pos < capacity)).sum(-1) > 0       # [S, k]
    c_sk = (pos * onehot).sum(-1).long()
    flat = expert_index.long() * capacity + c_sk
    sentinel = num_experts * capacity
    token_slot = torch.where(kept, flat, torch.full_like(flat, sentinel))
    token_gate = gates * kept
    tok_ids = torch.arange(s, device=gates.device)[:, None].expand(s, k)
    # kept slots are unique: collisions only at the sentinel, sliced off
    slot_token = torch.full((sentinel + 1,), s, dtype=torch.long,
                            device=gates.device).scatter_(
        0, token_slot.reshape(-1), tok_ids.reshape(-1))
    return (slot_token[:sentinel].reshape(num_experts, capacity),
            token_slot, token_gate)


#: ``dispatch_mode="auto"``: gather from this many experts, one-hot
#: below (the JAX package's threshold, from its TPU one-hot sweep; it
#: has not been measured on the H100)
_AUTO_GATHER_MIN_E = 64


def resolve_dispatch_mode(dispatch_mode: str, num_experts: int,
                          tokens: int, capacity: int,
                          hidden: int) -> str:
    """``"auto"`` resolved from the shape (an expert-count threshold,
    :data:`_AUTO_GATHER_MIN_E`); an explicit mode as it is.  ``tokens``,
    ``capacity`` and ``hidden`` are taken for a measured refinement."""
    if dispatch_mode != "auto":
        return dispatch_mode
    del tokens, capacity, hidden
    return "gather" if num_experts >= _AUTO_GATHER_MIN_E else "onehot"


class MoELayer(nn.Module):
    """Sparsely-activated FFN (Megatron-core: ``MoELayer``): children
    ``router`` (:class:`TopKRouter`, replicated) and ``experts``
    (:class:`GroupedMLP` of this rank's ``num_experts / ep`` experts at
    ffn width ``ffn / tp``, bias-free at tp > 1).

    ``forward(x, deterministic=True, generator=None)`` on ``x [...,
    hidden]`` (leading dims flattened into tokens) returns ``(y, aux)``:
    the loss terms ``aux["load_balancing_loss"]`` and ``aux["z_loss"]``
    (scale and add them to the task loss), and the detached diagnostics
    ``aux["expert_load"]`` ([E] capacity-fill fractions) and
    ``aux["dropped_fraction"]``, which must not be added to it.
    ``generator`` draws the router's jitter in training mode.

    ``expert_parallel_size``, ``tensor_parallel_size`` and
    ``sequence_parallel`` compose as in the module docstring, over the
    groups of ``expert_axis`` and ``tensor_axis`` (names, or process
    groups).  At sizes above 1 each rank's experts are drawn from a
    stream with its expert and tensor ranks folded in (JAX folds them
    into the init key), so the ranks hold different experts; the router
    is drawn alike on every rank.  ``generator`` of ``__init__`` seeds
    both (default: the device's default generator)."""

    def __init__(self, num_experts: int, hidden_size: int,
                 ffn_hidden_size: int, top_k: int = 2,
                 capacity_factor: float = 1.25,
                 capacity: Optional[int] = None,
                 expert_parallel_size: int = 1, expert_axis=EXPERT_AXIS,
                 tensor_parallel_size: int = 1, tensor_axis=TENSOR_AXIS,
                 sequence_parallel: bool = False,
                 activation: Callable = gelu,
                 params_dtype: Any = torch.float32, jitter_eps: float = 0.0,
                 load_balancing_type: str = "aux_loss",
                 dispatch_mode: str = "auto", device=None, generator=None):
        super().__init__()
        self.num_experts, self.hidden_size = num_experts, hidden_size
        self.ffn_hidden_size, self.top_k = ffn_hidden_size, top_k
        self.capacity_factor, self.capacity = capacity_factor, capacity
        self.expert_parallel_size = expert_parallel_size
        self.expert_axis = expert_axis
        self.tensor_parallel_size = tensor_parallel_size
        self.tensor_axis = tensor_axis
        self.sequence_parallel = sequence_parallel
        self.dispatch_mode = dispatch_mode
        self._check()
        ep, tp = expert_parallel_size, tensor_parallel_size
        self.router = TopKRouter(
            num_experts, hidden_size, top_k=top_k, jitter_eps=jitter_eps,
            load_balancing_type=load_balancing_type, device=device,
            generator=generator)
        egen = generator
        if ep > 1 or tp > 1:
            ranks = (dist.get_rank(parallel_state.resolve_group(expert_axis))
                     if ep > 1 else 0,
                     dist.get_rank(parallel_state.resolve_group(tensor_axis))
                     + 1 if tp > 1 else 0)
            egen = fold_generator(generator, *ranks,
                                  device=torch.device(device or "cpu"))
        self.experts = GroupedMLP(
            num_experts // ep, hidden_size, ffn_hidden_size // tp,
            activation=activation, use_bias=(tp == 1),
            params_dtype=params_dtype, init_method=expert_init,
            device=device, generator=egen)

    def _check(self) -> None:
        ep, tp = self.expert_parallel_size, self.tensor_parallel_size
        if self.num_experts % ep:
            raise ValueError(f"num_experts ({self.num_experts}) not "
                             f"divisible by expert_parallel_size ({ep})")
        if self.ffn_hidden_size % tp:
            raise ValueError(f"ffn_hidden_size ({self.ffn_hidden_size}) "
                             f"not divisible by tensor_parallel_size ({tp})")
        if self.dispatch_mode not in ("auto", "onehot", "gather"):
            raise ValueError(
                f"dispatch_mode must be 'auto', 'onehot' or 'gather', "
                f"got {self.dispatch_mode!r}")

    def capacity_for(self, tokens: int) -> int:
        """Slots an expert for ``tokens`` tokens: ``capacity``, else
        ``round_up(max(1, ceil(capacity_factor * tokens * top_k / E)),
        8)`` (Python floats, as JAX computes it)."""
        if self.capacity is not None:
            return self.capacity
        return round_up(max(1, math.ceil(
            self.capacity_factor * tokens * self.top_k / self.num_experts)),
            8)

    def forward(self, x, *, deterministic: bool = True, generator=None):
        self._check()
        ep, tp = self.expert_parallel_size, self.tensor_parallel_size
        if self.sequence_parallel:
            # every tensor rank routes the same tokens; the backward
            # slices (the cotangent here is already full on each rank)
            x = mappings.gather_from_sequence_parallel_region(
                x, self.tensor_axis, tensor_parallel_output_grad=False)
        lead, h = x.shape[:-1], x.shape[-1]
        tokens = x.reshape(-1, h)
        s = tokens.shape[0]
        e = self.num_experts
        cap = self.capacity_for(s)
        gates, expert_index, aux = self.router(
            tokens, deterministic=deterministic, generator=generator)
        dt = tokens.dtype
        gather = resolve_dispatch_mode(self.dispatch_mode, e, s, cap,
                                       h) == "gather"
        if gather:
            slot_token, token_slot, token_gate = compute_dispatch_indices(
                gates, expert_index, e, cap)
            # one zero pad row: empty slots (index s) read it
            pad = torch.cat([tokens, tokens.new_zeros(1, h)])
            buf = pad[slot_token]                            # [E, C, h]
            slots = (slot_token < s).sum(dim=1).float().detach()
        else:
            dispatch, combine = compute_dispatch_and_combine(
                gates, expert_index, e, cap)
            slots = dispatch.sum(dim=(0, 2)).detach()
        aux["expert_load"] = slots / cap
        aux["dropped_fraction"] = 1.0 - slots.sum() / (s * self.top_k)
        if not gather:
            buf = torch.einsum("sec,sh->ech", dispatch.to(dt), tokens)
        e_local = e // ep
        if ep > 1:
            # [E, C, h] -> rows by destination rank -> exchange ->
            # [E_local, ep*C, h]: my experts' slots from every rank
            buf = mappings.all_to_all(buf.reshape(ep, e_local, cap, h),
                                      self.expert_axis, 0, 0)
            buf = buf.transpose(0, 1).reshape(e_local, ep * cap, h)
        if tp > 1:
            buf = mappings.copy_to_tensor_model_parallel_region(
                buf, self.tensor_axis)
        expert_out = self.experts(buf)
        if tp > 1:
            # the ffn shards' partials summed before the combine, so that
            # the router's grads see the full expert output on every rank
            expert_out = mappings.reduce_from_tensor_model_parallel_region(
                expert_out, self.tensor_axis)
        if ep > 1:
            expert_out = expert_out.reshape(e_local, ep, cap, h)
            expert_out = mappings.all_to_all(
                expert_out.transpose(0, 1).contiguous(), self.expert_axis,
                0, 0)
            expert_out = expert_out.reshape(e, cap, h)
        if gather:
            out_pad = torch.cat([expert_out.reshape(e * cap, h),
                                 expert_out.new_zeros(1, h)])
            picked = out_pad[token_slot]                     # [S, k, h]
            y = torch.einsum("skh,sk->sh", picked,
                             token_gate.to(picked.dtype))
        else:
            y = torch.einsum("sec,ech->sh", combine.to(dt), expert_out)
        y = y.reshape(*lead, h)
        if self.sequence_parallel:
            # the output is full on each rank: slice this rank's shard
            y = mappings.scatter_to_sequence_parallel_region(
                y, self.tensor_axis)
        return y, aux
