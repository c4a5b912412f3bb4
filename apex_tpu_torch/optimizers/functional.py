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

**ZeRO.**  ``init(params, shard=(axis_name, dp[, rank]), prefetch=)``
builds one rank's ``1/dp`` shard of the dp-padded master and of the
flat slots, in JAX's two layouts: the contiguous block (the master
zero-padded to a dp multiple, rank r's slice ``[r * L, (r + 1) * L)``),
or with ``prefetch`` the per-span layout (:func:`prefetch_span_layout`:
each span of consecutive leaves padded to a dp multiple on its own,
rank r's shard the concatenation of its slice of every span).  The
shard holds the same numbers in the same order as JAX's rank-r slice
of ``init_zero_train_state``'s global view.  ``axis_name`` is a
mesh-axis name or a ``ProcessGroup``
(:func:`apex_tpu_torch.transformer.parallel_state.resolve_group`);
``rank`` defaults to this process's rank in it.  Adam, SGD and
Adagrad update the shard unchanged; LAMB's global grad norm and trust
ratios and NovoGrad's per-tensor moments sum shard partials over the
group (:mod:`apex_tpu_torch.optimizers.base`'s span helpers).
:func:`shard_flat_grads` reduce-scatters full flat grads into a rank's
shard, and :func:`shard_from_global_master` builds a rank's shard from
an unpadded global master (a JAX checkpoint's, say).

The JAX ``update`` is pure and XLA donates the old buffers; here the
kernels update master and slots IN PLACE and ``update`` returns a new
:class:`FlatState` over the same buffers with the advanced count (a
0-d device tensor: the bias corrections are computed from it on the
device).  As in JAX the count advances on a skipped (noop) step too,
and every quantity between the grads and the new state (clip factor,
norms, ratios, flags) stays a device tensor: nothing is read back.

"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.ops.fused_update import (_scalar, fused_adagrad_flat,
                                             fused_adam_flat, fused_l2norm,
                                             fused_lamb_phase1_flat,
                                             fused_sgd_flat)
from apex_tpu_torch.optimizers.base import (broadcast_leaf_scalars,
                                            rank_spans,
                                            sharded_leaf_broadcast,
                                            sharded_leaf_sq_norms)
from apex_tpu_torch.parallel import _comm
from apex_tpu_torch.utils import (cdiv, ravel_layout, tree_leaves_with_path,
                                  tree_ravel)

__all__ = ["FlatState", "fused_adam", "fused_lamb", "fused_sgd",
           "fused_novograd", "fused_adagrad", "shard_flat_grads",
           "export_params", "prefetch_span_layout",
           "shard_from_global_master"]


def prefetch_span_layout(sizes, k: int) -> tuple:
    """Group ``len(sizes)`` leaves into at most ``k`` gather spans of
    roughly equal element counts, aligned to leaf boundaries: a tuple of
    per-span LEAF COUNTS (``sum == len(sizes)``), the static
    ``FlatState.spans`` layout.  Greedy: close a span once it reaches
    ``total/k`` elements."""
    sizes = [int(s) for s in sizes]
    k = max(1, min(int(k), len(sizes)))
    target = sum(sizes) / k
    counts, run, acc = [], 0, 0
    for i, s in enumerate(sizes):
        run += 1
        acc += s
        remaining_leaves = len(sizes) - i - 1
        if (acc >= target and len(counts) < k - 1) \
                or remaining_leaves < (k - 1 - len(counts)):
            counts.append(run)
            run, acc = 0, 0
    if run:
        counts.append(run)
    return tuple(counts)


def _normalize_prefetch(prefetch, sizes) -> tuple:
    """Resolve a ``prefetch=`` argument to the static ``FlatState.spans``
    tuple: a tuple of per-span leaf counts passes through (checked), an
    int > 1 is grouped by :func:`prefetch_span_layout`, and ``None``/0/1
    mean the contiguous block layout (``()``)."""
    if prefetch is None:
        return ()
    if isinstance(prefetch, tuple):
        spans = tuple(int(c) for c in prefetch)
        if spans and (min(spans) <= 0 or sum(spans) != len(sizes)):
            raise ValueError(
                f"prefetch span layout {spans} must be positive leaf "
                f"counts summing to the number of leaves "
                f"({len(sizes)}); got sum {sum(spans)}")
        return spans
    return (prefetch_span_layout(sizes, int(prefetch))
            if int(prefetch) > 1 else ())


def _span_sizes(sizes, spans) -> tuple:
    out, leaf = [], 0
    for count in spans:
        out.append(sum(sizes[leaf:leaf + count]))
        leaf += count
    return tuple(out)


def _layout_master(master, *, sizes, spans, dp: int):
    """Pad a GLOBAL unpadded flat buffer to its dp-shardable layout:
    zero-pad to the dp multiple (block layout), or per-span pad and
    rank-major permute (:func:`_enspan`, prefetch layout)."""
    if spans:
        span_sizes = _span_sizes(sizes, spans)
        span_padded = tuple(cdiv(s, dp) * dp for s in span_sizes)
        return _enspan(master, span_sizes, span_padded, dp)
    n = int(master.shape[0])
    padded = cdiv(n, dp) * dp
    if padded != n:
        return torch.cat([master, master.new_zeros(padded - n)])
    return master


@dataclasses.dataclass(frozen=True)
class FlatState:
    """Flat optimizer state: fp32 master + per-rule slot buffers.

    ``sizes`` (per-leaf element counts, in the flax tree's leaf order),
    ``flat_dtype`` (the leaves' promoted dtype, the buffer dtype of
    ``tree_ravel``) and ``unravel`` are static layout.

    ``shard`` is the ZeRO mode: ``()`` (dense) or ``(axis_name, dp)``,
    this state holding one ``1/dp`` shard of the dp-padded master and of
    the flat slots, owned by one rank of the group ``axis_name`` names
    (a mesh-axis name or a ``ProcessGroup``).  ``spans`` is the
    prefetch layout: ``()`` (the contiguous block) or the per-span leaf
    counts, each span padded to a dp multiple on its own and split
    ``1/dp`` (see the module docstring)."""
    master: torch.Tensor            # fp32 flat master buffer (or shard)
    count: torch.Tensor             # 0-d f32: completed update count
    slots: dict                     # rule buffers, keyed like state_dict
    sizes: tuple = ()
    flat_dtype: torch.dtype = torch.float32
    unravel: Optional[Callable] = None
    shard: tuple = ()
    spans: tuple = ()

    def replace(self, **kw) -> "FlatState":
        return dataclasses.replace(self, **kw)

    @property
    def global_numel(self) -> int:
        """Unpadded element count of the GLOBAL flat master."""
        return sum(self.sizes)

    @property
    def offsets(self) -> tuple:
        """Each leaf's first element in the flat buffers."""
        out, off = [], 0
        for s in self.sizes:
            out.append(off)
            off += s
        return tuple(out)

    # -- ZeRO shard layout (all static Python ints) ----------------------
    @property
    def shard_axis(self):
        return self.shard[0] if self.shard else None

    @property
    def shard_dp(self) -> int:
        return int(self.shard[1]) if self.shard else 1

    @property
    def span_sizes(self) -> tuple:
        """Unpadded element count of each prefetch span (``()`` for the
        block layout)."""
        return _span_sizes(self.sizes, self.spans)

    @property
    def span_padded(self) -> tuple:
        """Per-span dp-padded element counts."""
        dp = self.shard_dp
        return tuple(cdiv(s, dp) * dp for s in self.span_sizes)

    @property
    def padded_numel(self) -> int:
        if self.spans:
            return sum(self.span_padded)
        return cdiv(self.global_numel, self.shard_dp) * self.shard_dp

    @property
    def shard_len(self) -> int:
        """Per-rank shard length: ``padded_numel / dp`` elements."""
        return self.padded_numel // self.shard_dp

    def span_windows(self) -> list:
        """``(global_start, size, padded)`` of each gather span: the
        prefetch spans, or the whole master as one span (block layout)."""
        if not self.spans:
            return [(0, self.global_numel, self.padded_numel)]
        out, start = [], 0
        for size, padded in zip(self.span_sizes, self.span_padded):
            out.append((start, size, padded))
            start += size
        return out

    def group(self):
        """The process group of a sharded state."""
        from apex_tpu_torch.transformer.parallel_state import resolve_group
        return resolve_group(self.shard_axis)

    def shard_rank(self) -> int:
        """This process's rank in :meth:`group`."""
        return _group_rank(self.shard_axis, self.shard_dp)

    def _despan(self, flat):
        """Reassemble the GLOBAL unpadded flat master from a rank-major
        span-layout padded buffer."""
        dp, lt = self.shard_dp, self.shard_len
        parts, off = [], 0
        for size_k, padded_k in zip(self.span_sizes, self.span_padded):
            lk = padded_k // dp
            span = torch.cat([flat[r * lt + off:r * lt + off + lk]
                              for r in range(dp)])
            parts.append(span[:size_k])
            off += lk
        return torch.cat(parts)

    def full_master(self, dtype=None) -> torch.Tensor:
        """The GLOBAL unpadded flat master (JAX's ``_full_master``).  A
        rank's shard is all-gathered over the group (collective: every
        rank calls it), in ``dtype`` when given; a full-length buffer
        (dense, or a padded global view) is only sliced."""
        flat = self.master if dtype is None else self.master.to(dtype)
        if self.shard and self.shard_dp > 1 \
                and flat.shape[0] != self.padded_numel:
            full = flat.new_empty(self.padded_numel)
            _comm.all_gather(full, flat.contiguous(), self.group())
            flat = full
        if self.spans and self.shard_dp > 1:
            return self._despan(flat)
        n = self.global_numel
        return flat[:n] if flat.shape[0] != n else flat

    def params(self, dtype=None) -> dict:
        """Materialize the params tree (the checkpoint/eval boundary):
        new tensors in the construction dtypes, or floating leaves cast
        to ``dtype``.  A sharded state all-gathers its master in the
        flat dtype (collective)."""
        if self.unravel is None:
            raise ValueError(
                "FlatState was initialized from a flat buffer (no "
                "unravel); read .master directly or init from a tree")
        tree = self.unravel(self.full_master(self.flat_dtype))
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


def _enspan(flat, span_sizes, span_padded, dp):
    """Permute a GLOBAL unpadded flat buffer into the rank-major
    prefetch layout: each span zero-padded to its dp multiple, then the
    per-rank slices concatenated rank-major (rank r's shard is block r).
    Inverse of :meth:`FlatState._despan`."""
    padded_spans, off = [], 0
    for size_k, padded_k in zip(span_sizes, span_padded):
        span = flat[off:off + size_k]
        if padded_k != size_k:
            span = torch.cat([span, span.new_zeros(padded_k - size_k)])
        padded_spans.append(span)
        off += size_k
    blocks = []
    for r in range(dp):
        for span, padded_k in zip(padded_spans, span_padded):
            lk = padded_k // dp
            blocks.append(span[r * lk:(r + 1) * lk])
    return torch.cat(blocks)


def shard_flat_grads(flat_grads: torch.Tensor, state: FlatState, *,
                     mean: bool = True) -> torch.Tensor:
    """Reduce-scatter a FULL per-rank flat grad buffer into this rank's
    shard (the ZeRO-2 grad reduction): zero-pad to the padded length
    (permuted rank-major per span under ``spans``), reduce-scatter over
    the shard's group in the grads' dtype, and (by default) divide by dp.
    Returns a new shard-length buffer; no-op (beyond the mean) when the
    state is dense or dp == 1."""
    if not state.shard or state.shard_dp == 1:
        return flat_grads
    if state.spans:
        flat_grads = _enspan(flat_grads, state.span_sizes,
                             state.span_padded, state.shard_dp)
    else:
        pad = state.padded_numel - state.global_numel
        if pad:
            flat_grads = torch.cat([flat_grads, flat_grads.new_zeros(pad)])
    gshard = flat_grads.new_empty(state.shard_len)
    _comm.reduce_scatter(gshard, flat_grads.contiguous(), state.group())
    return gshard / state.shard_dp if mean else gshard


def _shard_of(flat: torch.Tensor, shard_len: int, rank: int) -> torch.Tensor:
    return flat[int(rank) * shard_len:(int(rank) + 1) * shard_len].clone()


def _rank_shard(flat: torch.Tensor, *, sizes, spans, dp: int,
                rank: int) -> torch.Tensor:
    """Rank ``rank``'s shard of a GLOBAL unpadded flat buffer, built
    without the padded global layout: ``_shard_of(_layout_master(flat),
    shard_len, rank)``, element for element, in O(shard) memory."""
    span_sizes = _span_sizes(sizes, spans) if spans else (int(flat.shape[0]),)
    lks = [cdiv(size, dp) for size in span_sizes]
    out = flat.new_zeros(sum(lks))
    start = dst = 0
    for size, lk in zip(span_sizes, lks):
        lo, hi = min(rank * lk, size), min((rank + 1) * lk, size)
        out[dst:dst + hi - lo].copy_(flat[start + lo:start + hi])
        start += size
        dst += lk
    return out


def _group_rank(axis_name, dp: int) -> int:
    """This process's rank in the group ``axis_name`` names, which must
    hold ``dp`` ranks."""
    from apex_tpu_torch.transformer.parallel_state import resolve_group
    group = resolve_group(axis_name)
    size = dist.get_world_size(group)
    if size != dp:
        raise RuntimeError(f"shard dp={dp} needs a group of {dp} ranks; "
                           f"{axis_name!r} has {size}")
    return dist.get_rank(group)


def _init_state(tx, params, shard=None, prefetch=None) -> FlatState:
    """Shared init: ravel a tree (an ``nn.Module`` or a nested dict of
    tensors), or take an already-flat buffer, into a fresh fp32 master
    plus the rule's zero slots, on the parameters' device.

    ``shard=(axis_name, dp[, rank])`` keeps only ``rank``'s ``1/dp``
    shard of the dp-padded master (and slots); ``rank`` defaults to this
    process's rank in the group ``axis_name`` names (which must hold dp
    ranks); pass an int to build one rank's shard without a group
    (checkpoint resharding, tests).  ``prefetch`` (with ``shard``)
    selects the layered-prefetch layout: an int asks for that many
    gather spans, a tuple of per-span leaf counts is used as is;
    ``None``/0/1 keep the contiguous block layout."""
    if isinstance(params, torch.Tensor) and params.dim() == 1:
        flat, unravel = params.detach(), None
        sizes = (int(flat.numel()),)
    else:
        flat, unravel = tree_ravel(params)
        sizes = tuple(int(t.numel()) for _, t in
                      tree_leaves_with_path(params))
    flat_dtype = flat.dtype
    shard_static: tuple = ()
    spans: tuple = ()
    if shard is None:
        master = flat.to(torch.float32, copy=True)
    else:
        axis_name, dp, *rank_opt = shard
        dp = int(dp)
        shard_static = (axis_name, dp)
        spans = _normalize_prefetch(prefetch, sizes)
        rank = int(rank_opt[0]) if rank_opt else (
            _group_rank(axis_name, dp) if dp > 1 else 0)
        master = _rank_shard(flat.to(torch.float32), sizes=sizes,
                             spans=spans, dp=dp, rank=rank)
    return FlatState(
        master=master,
        count=torch.zeros((), dtype=torch.float32, device=master.device),
        slots=tx.init_slots(master, sizes=sizes),
        sizes=sizes, flat_dtype=flat_dtype, unravel=unravel,
        shard=shard_static, spans=spans)


def shard_from_global_master(tx, master, params, *, shard,
                             prefetch=None) -> FlatState:
    """A rank's ZeRO state from an UNPADDED GLOBAL flat master (a numpy
    array or tensor of ``sum(sizes)`` elements, e.g. the JAX package's
    ravelled params or a ``DistributedFused*`` checkpoint's
    ``"master"``): ``tx.init(params, shard=shard, prefetch=prefetch)``
    with its master replaced by that rank's shard of ``master`` (fresh
    slots).  ``params`` (a model or tree on the target device) supplies
    the layout."""
    state = _init_state(tx, params, shard=shard, prefetch=prefetch)
    dp = state.shard_dp
    rank = int(shard[2]) if len(shard) > 2 else (
        _group_rank(shard[0], dp) if dp > 1 else 0)
    if not isinstance(master, torch.Tensor):
        master = torch.from_numpy(np.array(master, dtype=np.float32))
    if master.shape != (state.global_numel,):
        raise ValueError(f"the global master has {state.global_numel} "
                         f"elements, got {tuple(master.shape)}")
    state.master.copy_(_rank_shard(
        master.to(device=state.master.device, dtype=torch.float32),
        sizes=state.sizes, spans=state.spans, dp=dp, rank=rank))
    return state


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
        # global grad norm clip (reference: the first multi_tensor_l2norm);
        # under ZeRO the shard's sum of squares is summed over the group
        gnorm = fused_l2norm(g)
        sharded = bool(state.shard) and state.shard_dp > 1
        if sharded:
            group = state.group()
            gnorm = torch.sqrt(_comm.all_reduce(gnorm * gnorm, group))
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
        if sharded:
            # EXACT per-tensor trust ratios across shards (reference:
            # DistributedFusedLAMB's multi_tensor_l2norm + group
            # all-reduce): per-leaf partial sums of squares over this
            # rank's windows, summed over the group
            layout = dict(dp=state.shard_dp, shard_len=state.shard_len,
                          rank=state.shard_rank(), spans=state.spans)
            sq = _comm.all_reduce(sharded_leaf_sq_norms(
                (p, u), state.sizes, **layout), group)
            w_norm, u_norm = torch.sqrt(sq)
            leaves = [(i, lo, hi - lo) for i, lo, hi in
                      rank_spans(state.sizes, **layout)]
        else:
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
        sharded = bool(state.shard) and state.shard_dp > 1
        if sharded:
            # per-tensor ||g||^2 from grad SHARDS: this rank's window
            # sums, summed over the group (the exp_avg_sq slot is one
            # scalar per leaf, replicated, not sharded)
            layout = dict(dp=state.shard_dp, shard_len=state.shard_len,
                          rank=state.shard_rank(), spans=state.spans)
            gsq = _comm.all_reduce(sharded_leaf_sq_norms(
                (g32,), state.sizes, **layout)[0], state.group())
        else:
            gsq = torch.stack([torch.sum(torch.square(g32[off:off + size]))
                               for _, off, size in _leaves(state)])
        first = t <= 1.0
        v_init = torch.zeros_like(gsq) if self.init_zero else gsq
        v_new = torch.where(first, v_init, b2 * v + (1.0 - b2) * gsq)
        denom_scalars = torch.sqrt(v_new) + _scalar(
            self.eps if eps is None else eps, dev)
        denom = (sharded_leaf_broadcast(denom_scalars, state.sizes, **layout)
                 if sharded else
                 broadcast_leaf_scalars(denom_scalars, state.sizes))
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
