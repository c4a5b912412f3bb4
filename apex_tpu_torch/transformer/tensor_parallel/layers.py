"""Tensor-parallel layers over the mappings collectives.

Port of ``apex_tpu/transformer/tensor_parallel/layers.py`` (reference:
``apex/transformer/tensor_parallel/layers.py``):
``ColumnParallelLinear`` (out-features sharded), ``RowParallelLinear``
(in-features sharded, the partial products all-reduced) and
``VocabParallelEmbedding`` (vocab rows sharded) as ``nn.Module``s with
the flax modules' parameter names (``weight``, ``bias``) and layouts
(linear weights ``[out / tp, in]`` and ``[out, in / tp]``, so the
forward is ``x @ W.T``; the embedding ``[vocab / tp, dim]``), returning
``(output, output_bias)`` from the linears as the JAX layers do.

The tensor-parallel size is the topology's where
:func:`~apex_tpu_torch.transformer.parallel_state.initialize_model_parallel`
has run (JAX's ``_tp_world()``), else ``tensor_model_parallel_size=``
(default 1); ``axis_name`` may also be a ``ProcessGroup``.  Each rank
holds its own shard; at tp > 1 the shards are drawn from a generator
seeded with the rank folded in, as JAX folds it into the key.

* ``overlap_chunks`` (``None`` reads ``APEX_TPU_TP_OVERLAP_CHUNKS`` at
  construction): RowParallelLinear computes ``all_reduce(x @ W^T)`` as
  a ring whose every step is one token chunk's GEMM added to the partial
  arriving from the previous rank (:class:`_RingRowMatmul`), its
  backward the fused path's own; ColumnParallelLinear's backward
  all-reduce of the input grad goes through ``mappings.ring_psum``.
* ``gradient_accumulation_fusion``: the weight is the fp32 master, cast
  to the activations' type for the forward GEMM; the backward makes the
  weight grad in fp32 from the 16-bit operands, never rounded to 16 bits
  (cuBLAS writes fp32 from its accumulator).  A weight of another dtype
  raises JAX's ``ValueError``.
* At tp > 1 the GEMMs run in :class:`_LinearFn`, whose backward
  (:func:`_matmul_linear_bwd`) the ring's shares, so the two give the
  same gradients bit for bit.  The weight GEMMs are cuBLAS
  (``torch.matmul``), as XLA computes them in the JAX package.

Sequence parallelism (``sequence_parallel_enabled``, activations
``[s/tp, b, h]`` between the layers): ColumnParallelLinear all-gathers
the sequence in (``gather_from_sequence_parallel_region``, whose
backward reduce-scatters the input grad) and refuses ``gather_output``;
RowParallelLinear requires ``input_is_parallel`` and reduce-scatters its
partial products out (``reduce_scatter_to_sequence_parallel_region``;
the chunked ring stays off under it), the bias added after.  At tp = 1
both regions are the identity.
Initialisation draws normals with the variance of the JAX initialisers
(Glorot ``fan_avg`` on the shard for the linears, N(0, 0.02^2) for the
embedding); the JAX package's random bits cannot be reproduced, so
parity tests load the same weights on both sides.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops.fused_lm_xent import _wgrad_add_
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS
from apex_tpu_torch.transformer.tensor_parallel import mappings
from apex_tpu_torch.transformer.utils import VocabUtility, divide

__all__ = [
    "ColumnParallelLinear",
    "RowParallelLinear",
    "VocabParallelEmbedding",
    "linear_with_grad_accumulation_and_async_allreduce",
    "set_tensor_model_parallel_attributes",
    "set_defaults_if_not_set_tensor_model_parallel_attributes",
    "copy_tensor_model_parallel_attributes",
    "param_is_not_tensor_parallel_duplicate",
    "glorot_normal_",
]

def glorot_normal_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """Fill ``w [out, in]`` with N(0, 2 / (fan_in + fan_out)), the
    variance of flax's ``xavier_normal``."""
    std = math.sqrt(2.0 / (w.shape[0] + w.shape[1]))
    with torch.no_grad():
        return w.normal_(0.0, std, generator=generator)


def _shard_generator(device, tp: int, axis_name):
    """The generator a rank's shard is drawn from: ``None`` (the default
    stream) at tp = 1; at tp > 1 one seeded from the default stream with
    the tensor rank folded in, so the shards differ."""
    if tp == 1:
        return None
    base = int(torch.randint(0, 2 ** 31 - 1, ()))
    rank = dist.get_rank(parallel_state.resolve_group(axis_name))
    g = torch.Generator(device=device or "cpu")
    g.manual_seed(base * 65537 + rank)
    return g


def _mm(x, w):
    """``x @ w.T`` in the operands' promoted dtype (jnp.matmul's)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt).T)


def _matmul_linear_bwd(x, w, dy, fp32_wgrad: bool):
    """Backward of ``x @ W^T``: ``dx = dy @ W`` and the weight grad,
    made in fp32 from the operands with ``fp32_wgrad`` (the
    ``gradient_accumulation_fusion`` regime).  The one copy of it: the
    fused path and the ring share it, so they cannot drift."""
    if fp32_wgrad:
        dx = torch.matmul(dy, w.to(dy.dtype))
    else:
        dt = torch.promote_types(dy.dtype, w.dtype)
        dx = torch.matmul(dy.to(dt), w.to(dt))
    dy2 = dy.reshape(-1, dy.shape[-1])
    x2 = x.reshape(-1, x.shape[-1])
    if fp32_wgrad:
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        _wgrad_add_(dw, dy2, x2)
    else:
        dt = torch.promote_types(dy.dtype, x.dtype)
        dw = torch.matmul(dy2.to(dt).T, x2.to(dt))
    return dx.to(x.dtype), dw.to(w.dtype)


class _LinearFn(torch.autograd.Function):
    """``x @ W^T`` with :func:`_matmul_linear_bwd` as its backward; with
    ``fp32_wgrad`` the fp32 master is cast to ``x``'s type forward."""

    @staticmethod
    def forward(ctx, x, w, fp32_wgrad: bool):
        ctx.save_for_backward(x, w)
        ctx.fp32_wgrad = fp32_wgrad
        return torch.matmul(x, w.to(x.dtype).T) if fp32_wgrad else _mm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _matmul_linear_bwd(x, w, dy, ctx.fp32_wgrad)
        return dx, dw, None


class _RingRowMatmul(torch.autograd.Function):
    """``all_reduce(x @ W^T)`` over ``group`` as a ``chunks``-chunk ring:
    each ring step computes one token chunk's partial GEMM and adds it to
    the accumulator arriving from the previous rank, then an all-gather
    in rank order.  The bytes are the fused all-reduce's.  The backward
    is the fused path's exact backward (``dy`` is replicated: the
    all-reduce's transpose is the identity)."""

    @staticmethod
    def forward(ctx, x, w, group, axis_name, chunks: int, fused: bool):
        n = dist.get_world_size(group)
        m, gsz, csz = mappings._ring_geometry(axis_name, n, chunks,
                                              x.shape[0], "overlap_chunks")
        wl = w.to(x.dtype) if fused else w

        def piece(g, c):
            return _mm(x.narrow(0, g * gsz + c * csz, csz), wl)

        ctx.save_for_backward(x, w)
        ctx.fused = fused
        return mappings._ring_reduce(piece, group, n, m)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = _matmul_linear_bwd(x, w, dy, ctx.fused)
        return dx, dw, None, None, None, None


def _require_fp32_master(weight) -> None:
    """``gradient_accumulation_fusion`` needs an fp32 (master) weight: a
    16-bit one would round the fp32 wgrad back to 16 bits (the
    reference requires an fp32 ``main_grad`` likewise)."""
    if weight.dtype != torch.float32:
        raise ValueError(
            "gradient_accumulation_fusion requires fp32 (master) "
            f"weights, got {weight.dtype}; the reference's "
            "wgrad_gemm_accum_fp32 equally requires param.main_grad "
            "to be fp32")


def _maybe_fused_matmul(x, weight, fused: bool, tp: int):
    """The GEMM of the Column/Row parallel linears: the fp32-wgrad
    Function under fusion, :class:`_LinearFn` at tp > 1, else
    ``F.linear`` (autograd's backward)."""
    if fused:
        _require_fp32_master(weight)
        return _LinearFn.apply(x, weight, True)
    if tp > 1:
        return _LinearFn.apply(x, weight, False)
    return F.linear(x, weight)


def linear_with_grad_accumulation_and_async_allreduce(
        input, weight, bias=None, gradient_accumulation_fusion: bool = False,
        async_grad_allreduce: bool = True,
        sequence_parallel_enabled: bool = False,
        axis_name=TENSOR_AXIS, overlap_chunks: Optional[int] = None):
    """The functional core of ColumnParallelLinear: ``weight`` is ``[out
    / tp, in]``; ``x @ W^T (+ b)`` after ``copy_to`` (whose backward
    all-reduces the input grad; ``overlap_chunks > 1`` through the ring,
    ``None`` reads ``APEX_TPU_TP_OVERLAP_CHUNKS``).  The tp size is the
    ``axis_name`` group's when a topology or a group is at hand, else 1.
    With ``sequence_parallel_enabled`` the input ``[s/tp, b, h]`` is
    all-gathered along the sequence first, the input grad
    reduce-scattered back (``gather_from_sequence_parallel_region``)."""
    chunks = mappings.tp_overlap_chunks(overlap_chunks)
    tp = mappings.axis_size(axis_name)
    x = input
    if sequence_parallel_enabled:
        if tp > 1:
            x = mappings.gather_from_sequence_parallel_region(
                input, axis_name, tensor_parallel_output_grad=True)
    elif async_grad_allreduce and tp > 1:
        x = mappings.copy_to_tensor_model_parallel_region(
            input, axis_name, chunks=chunks)
    out = _maybe_fused_matmul(x, weight, gradient_accumulation_fusion, tp)
    if bias is not None:
        out = out + bias
    return out


class ColumnParallelLinear(nn.Module):
    """Linear with out-features sharded over TP: ``Y_i = X @ A_i^T (+
    b_i)``.  Returns ``(output, output_bias)``; the bias is deferred
    when ``skip_bias_add``; ``gather_output`` all-gathers the shards.
    ``sequence_parallel_enabled``: the input is ``[s/tp, b, h]``,
    all-gathered along the sequence for the GEMM (``gather_output`` then
    raises ``AssertionError``, as JAX's assert does)."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 gather_output: bool = True, *, skip_bias_add: bool = False,
                 no_async_tensor_model_parallel_allreduce: bool = False,
                 params_dtype=torch.float32, device=None,
                 tensor_model_parallel_size: Optional[int] = None,
                 gradient_accumulation_fusion: bool = False,
                 sequence_parallel_enabled: bool = False,
                 axis_name=TENSOR_AXIS,
                 overlap_chunks: Optional[int] = None):
        super().__init__()
        self.tp = mappings.axis_size(axis_name, tensor_model_parallel_size)
        self.axis_name = axis_name
        self.input_size, self.output_size = input_size, output_size
        self.gather_output = gather_output
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.skip_bias_add = skip_bias_add
        self.async_grad_allreduce = not no_async_tensor_model_parallel_allreduce
        self.gradient_accumulation_fusion = gradient_accumulation_fusion
        self.overlap_chunks = mappings.tp_overlap_chunks(overlap_chunks)
        out = divide(output_size, self.tp)
        kw = dict(dtype=params_dtype, device=device)
        self.weight = nn.Parameter(glorot_normal_(
            torch.empty(out, input_size, **kw),
            _shard_generator(device, self.tp, axis_name)))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out, **kw))
        else:
            self.register_parameter("bias", None)

    def forward(self, input_):
        out = linear_with_grad_accumulation_and_async_allreduce(
            input_, self.weight,
            bias=None if self.skip_bias_add else self.bias,
            gradient_accumulation_fusion=self.gradient_accumulation_fusion,
            async_grad_allreduce=self.async_grad_allreduce,
            sequence_parallel_enabled=self.sequence_parallel_enabled,
            axis_name=self.axis_name, overlap_chunks=self.overlap_chunks)
        if self.gather_output:
            if self.sequence_parallel_enabled:
                raise AssertionError(
                    "gather_output incompatible with sequence_parallel "
                    "(reference asserts the same)")
            if self.tp > 1:
                out = mappings.gather_from_tensor_model_parallel_region(
                    out, self.axis_name)
        return out, (self.bias if self.skip_bias_add else None)


class RowParallelLinear(nn.Module):
    """Linear with in-features sharded over TP: ``Y = sum_i X_i @
    A_i^T``, the partial products all-reduced (or, with
    ``overlap_chunks > 1``, reduced on the chunked ring); the bias is
    added after the reduction.  Returns ``(output, output_bias)``.
    ``sequence_parallel_enabled``: the partial products are
    reduce-scattered to sequence shards ``[s/tp, b, h]`` instead (the
    ring stays off); ``input_is_parallel`` is required (JAX's assert,
    ``AssertionError``)."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 input_is_parallel: bool = False, *,
                 skip_bias_add: bool = False, params_dtype=torch.float32,
                 device=None, tensor_model_parallel_size: Optional[int] = None,
                 gradient_accumulation_fusion: bool = False,
                 sequence_parallel_enabled: bool = False,
                 axis_name=TENSOR_AXIS,
                 overlap_chunks: Optional[int] = None):
        super().__init__()
        self.tp = mappings.axis_size(axis_name, tensor_model_parallel_size)
        self.axis_name = axis_name
        self.input_size, self.output_size = input_size, output_size
        self.input_is_parallel = input_is_parallel
        self.sequence_parallel_enabled = sequence_parallel_enabled
        self.skip_bias_add = skip_bias_add
        self.gradient_accumulation_fusion = gradient_accumulation_fusion
        self.overlap_chunks = mappings.tp_overlap_chunks(overlap_chunks)
        kw = dict(dtype=params_dtype, device=device)
        self.weight = nn.Parameter(glorot_normal_(
            torch.empty(output_size, divide(input_size, self.tp), **kw),
            _shard_generator(device, self.tp, axis_name)))
        if bias:
            self.bias = nn.Parameter(torch.zeros(output_size, **kw))
        else:
            self.register_parameter("bias", None)

    def forward(self, input_):
        fused = self.gradient_accumulation_fusion
        sp = self.sequence_parallel_enabled
        if sp and not self.input_is_parallel:
            raise AssertionError("sequence_parallel requires input_is_parallel")
        if self.tp == 1:
            out = _maybe_fused_matmul(input_, self.weight, fused, 1)
        else:
            x = input_ if self.input_is_parallel else \
                mappings.scatter_to_tensor_model_parallel_region(
                    input_, self.axis_name)
            if sp:
                out = mappings.reduce_scatter_to_sequence_parallel_region(
                    _maybe_fused_matmul(x, self.weight, fused, self.tp),
                    self.axis_name)
            elif self.overlap_chunks > 1:
                if fused:
                    _require_fp32_master(self.weight)
                out = _RingRowMatmul.apply(
                    x, self.weight,
                    parallel_state.resolve_group(self.axis_name),
                    self.axis_name, self.overlap_chunks, fused)
            else:
                out = mappings.reduce_from_tensor_model_parallel_region(
                    _maybe_fused_matmul(x, self.weight, fused, self.tp),
                    self.axis_name)
        if self.skip_bias_add:
            return out, self.bias
        if self.bias is not None:
            out = out + self.bias
        return out, None


class _EmbeddingMatmulGrad(torch.autograd.Function):
    """``weight[ids]`` whose backward builds the table grad as a one-hot
    x dy product (fp32 accumulation) instead of a scatter-add.  The
    backward makes a ``[tokens, vocab_shard]`` one-hot in dy's type: at
    8k tokens x 32k vocab in fp32, ~1 GB."""

    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.wdtype = weight.shape[0], weight.dtype
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, dy):
        ids, = ctx.saved_tensors
        dyf = dy.reshape(-1, dy.shape[-1])
        onehot = F.one_hot(ids.reshape(-1).long(), ctx.vocab).to(dyf.dtype)
        dw = torch.zeros(ctx.vocab, dyf.shape[-1], dtype=torch.float32,
                         device=dyf.device)
        _wgrad_add_(dw, onehot, dyf)
        return dw.to(ctx.wdtype), None


class VocabParallelEmbedding(nn.Module):
    """Embedding with vocab rows sharded over TP: ids outside the rank's
    range are masked to 0, looked up locally, zeroed and all-reduced (no
    gather of the table).  The lookup's backward is autograd's
    scatter-add, or with ``grad_via_matmul`` a one-hot product (see
    :class:`_EmbeddingMatmulGrad` for its transient)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 params_dtype=torch.float32, device=None,
                 tensor_model_parallel_size: Optional[int] = None,
                 axis_name=TENSOR_AXIS, grad_via_matmul: bool = False):
        super().__init__()
        self.tp = mappings.axis_size(axis_name, tensor_model_parallel_size)
        self.axis_name = axis_name
        self.grad_via_matmul = grad_via_matmul
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        w = torch.empty(divide(num_embeddings, self.tp), embedding_dim,
                        dtype=params_dtype, device=device)
        with torch.no_grad():
            w.normal_(0.0, 0.02, generator=_shard_generator(
                device, self.tp, axis_name))
        self.weight = nn.Parameter(w)

    def _lookup(self, ids):
        if self.grad_via_matmul:
            return _EmbeddingMatmulGrad.apply(self.weight, ids)
        return F.embedding(ids, self.weight)

    def forward(self, input_):
        if self.tp == 1:
            return self._lookup(input_)
        per = self.weight.shape[0]
        rank = dist.get_rank(parallel_state.resolve_group(self.axis_name))
        start, end = VocabUtility.vocab_range_from_per_partition_vocab_size(
            per, rank, self.tp)
        mask = (input_ < start) | (input_ >= end)
        out = self._lookup((input_ - start).clamp(0, per - 1))
        out = out.masked_fill(mask[..., None], 0.0)
        return mappings.reduce_from_tensor_model_parallel_region(
            out, self.axis_name)


# --- param attribute helpers (reference: same names) ------------------------

_TP_DEFAULTS = {"tensor_model_parallel": False,
                "partition_dim": -1,
                "partition_stride": 1}


def set_tensor_model_parallel_attributes(tensor, is_parallel: bool, dim: int,
                                         stride: int) -> None:
    for attr in _TP_DEFAULTS:
        assert not hasattr(tensor, attr)
    tensor.tensor_model_parallel = is_parallel
    tensor.partition_dim = dim
    tensor.partition_stride = stride


def set_defaults_if_not_set_tensor_model_parallel_attributes(tensor) -> None:
    for attr, default in _TP_DEFAULTS.items():
        if not hasattr(tensor, attr):
            setattr(tensor, attr, default)


def copy_tensor_model_parallel_attributes(destination, source) -> None:
    for attr in _TP_DEFAULTS:
        if hasattr(source, attr):
            setattr(destination, attr, getattr(source, attr))


def param_is_not_tensor_parallel_duplicate(param) -> bool:
    """True if the param is TP-sharded (not a replicated duplicate) or this
    is TP rank 0: it is counted exactly once globally."""
    if getattr(param, "tensor_model_parallel", False):
        return True
    return parallel_state.get_tensor_model_parallel_rank() == 0
