"""Tensor-parallel layers at tp = 1.

Port of ``apex_tpu/transformer/tensor_parallel/layers.py``:
``ColumnParallelLinear``, ``RowParallelLinear`` and
``VocabParallelEmbedding`` as ``nn.Module``s with the flax modules'
parameter names (``weight``, ``bias``) and layouts (linear weights
``[out, in]``, so the forward is ``x @ W.T``; the embedding
``[vocab, dim]``), returning ``(output, output_bias)`` from the linears
as the JAX layers do.  The weight GEMMs and their backward are
``torch.matmul`` and autograd: the JAX package leaves them to XLA too.

Only one tensor-parallel rank exists in this slice: a
``tensor_model_parallel_size`` above 1, sequence parallelism, the
chunked comm/compute ring (``overlap_chunks``) and the fp32-wgrad
fusion raise ``NotImplementedError`` (ROADMAP queue 1, item 6).

Initialisation draws normals with the variance of the JAX initialisers
(Glorot ``fan_avg`` for the linears, N(0, 0.02^2) for the embedding);
``LlamaModel.reset_parameters(generator=)`` draws them again from a
seeded generator.  The JAX package's own random bits cannot be
reproduced, so parity tests load the same weights on both sides
(:func:`apex_tpu_torch.inference.weights.load_jax_params`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "glorot_normal_"]

_ROADMAP_TP = "ROADMAP queue 1, item 6 (multi-GPU layers over NCCL)"


def glorot_normal_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """Fill ``w [out, in]`` with N(0, 2 / (fan_in + fan_out)), the
    variance of flax's ``xavier_normal``."""
    std = math.sqrt(2.0 / (w.shape[0] + w.shape[1]))
    with torch.no_grad():
        return w.normal_(0.0, std, generator=generator)


def _check_tp(layer: str, tp: int, **unported) -> None:
    if tp != 1:
        raise NotImplementedError(
            f"{layer} at tensor_model_parallel_size {tp}: only tp = 1 is "
            f"ported ({_ROADMAP_TP})")
    on = [k for k, v in unported.items() if v]
    if on:
        raise NotImplementedError(
            f"{layer}: {', '.join(on)} is not ported ({_ROADMAP_TP})")


class ColumnParallelLinear(nn.Module):
    """Linear with out-features sharded over TP (one shard at tp = 1):
    ``Y = X @ A^T (+ b)``.  Returns ``(output, output_bias)``; the bias
    is deferred when ``skip_bias_add``."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 gather_output: bool = True, *, skip_bias_add: bool = False,
                 params_dtype=torch.float32, device=None,
                 tensor_model_parallel_size: int = 1,
                 gradient_accumulation_fusion: bool = False,
                 sequence_parallel_enabled: bool = False,
                 overlap_chunks: Optional[int] = None):
        super().__init__()
        _check_tp("ColumnParallelLinear", tensor_model_parallel_size,
                  gradient_accumulation_fusion=gradient_accumulation_fusion,
                  sequence_parallel_enabled=sequence_parallel_enabled,
                  overlap_chunks=(overlap_chunks or 1) > 1)
        self.input_size, self.output_size = input_size, output_size
        self.gather_output = gather_output
        self.skip_bias_add = skip_bias_add
        kw = dict(dtype=params_dtype, device=device)
        self.weight = nn.Parameter(glorot_normal_(
            torch.empty(output_size, input_size, **kw)))
        if bias:
            self.bias = nn.Parameter(torch.zeros(output_size, **kw))
        else:
            self.register_parameter("bias", None)

    def forward(self, input_):
        b = None if self.skip_bias_add else self.bias
        out = F.linear(input_, self.weight, b)
        return out, (self.bias if self.skip_bias_add else None)


class RowParallelLinear(nn.Module):
    """Linear with in-features sharded over TP (one shard at tp = 1):
    ``Y = X @ A^T (+ b)``, the bias added after the (here trivial)
    reduction.  Returns ``(output, output_bias)``."""

    def __init__(self, input_size: int, output_size: int, bias: bool = True,
                 input_is_parallel: bool = False, *,
                 skip_bias_add: bool = False, params_dtype=torch.float32,
                 device=None, tensor_model_parallel_size: int = 1,
                 gradient_accumulation_fusion: bool = False,
                 sequence_parallel_enabled: bool = False,
                 overlap_chunks: Optional[int] = None):
        super().__init__()
        _check_tp("RowParallelLinear", tensor_model_parallel_size,
                  gradient_accumulation_fusion=gradient_accumulation_fusion,
                  sequence_parallel_enabled=sequence_parallel_enabled,
                  overlap_chunks=(overlap_chunks or 1) > 1)
        self.input_size, self.output_size = input_size, output_size
        self.input_is_parallel = input_is_parallel
        self.skip_bias_add = skip_bias_add
        kw = dict(dtype=params_dtype, device=device)
        self.weight = nn.Parameter(glorot_normal_(
            torch.empty(output_size, input_size, **kw)))
        if bias:
            self.bias = nn.Parameter(torch.zeros(output_size, **kw))
        else:
            self.register_parameter("bias", None)

    def forward(self, input_):
        out = F.linear(input_, self.weight)
        if self.skip_bias_add:
            return out, self.bias
        if self.bias is not None:
            out = out + self.bias
        return out, None


class VocabParallelEmbedding(nn.Module):
    """Embedding with vocab rows sharded over TP (one shard at tp = 1):
    a row lookup whose backward is autograd's scatter-add, as XLA's
    ``take`` transpose is in the JAX package."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 params_dtype=torch.float32, device=None,
                 tensor_model_parallel_size: int = 1):
        super().__init__()
        _check_tp("VocabParallelEmbedding", tensor_model_parallel_size)
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        w = torch.empty(num_embeddings, embedding_dim, dtype=params_dtype,
                        device=device)
        with torch.no_grad():
            w.normal_(0.0, 0.02)
        self.weight = nn.Parameter(w)

    def forward(self, input_):
        return F.embedding(input_, self.weight)
