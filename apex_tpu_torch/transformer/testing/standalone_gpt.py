"""Standalone Megatron-style GPT of the port, at tp = 1.

Port of ``apex_tpu/transformer/testing/standalone_gpt.py``:
:class:`GPTConfig` (with its ``ffn`` property), :class:`ParallelMLP`,
:class:`ParallelAttention`, :class:`ParallelTransformerLayer`,
:class:`GPTEmbedding`, :class:`GPTModel` and :func:`gpt_model_provider`
as ``nn.Module``s whose named parameters map one to one onto the flax
tree's key paths (``layer_0.self_attention.query_key_value.weight`` is
``layer_0/self_attention/query_key_value/weight``,
``embedding.position_embeddings`` the learned position table).  Same op
sequence: activations ``[s, b, h]``; a vocab-parallel word embedding
plus learned positions; pre-LN blocks on the fused LayerNorm (fp32
affine parameters whatever ``params_dtype``); the qkv projection
interleaved per head (``[q(d), k(d), v(d)]`` for each head); the flash
kernels with the optional boolean mask (True = masked); a GELU MLP in
the tanh approximation, as ``jax.nn.gelu`` computes it; a final
LayerNorm and logits tied to the word embedding; the tp = 1 cross
entropy over fp32 logits when labels are given.

Training mode (``deterministic=False``) applies the JAX module's
dropout: hidden dropout after the embedding, after attention and after
the MLP (``hidden_dropout``), and attention dropout on the
probabilities inside the flash kernels (``attention_dropout``), one
seed drawn for each layer and each call.  Randomness comes from the
``torch.Generator`` the caller passes (``generator=``, the counterpart
of flax's ``rngs={"dropout": key}``), which lives on the activations'
device: the hidden masks are ``torch.rand`` draws from it, and each
attention seed is an int32 drawn from it as a one-element tensor on
that device and handed to the kernels as their seed operand, so a
training step never syncs with the host for its randomness.  The
attention keep mask is the JAX package's bit for bit given the same
seed; the hidden masks cannot be (a ``torch.Generator`` does not draw
flax's bits), so they are the same distribution.

With labels and ``fused_head_xent`` > 0 (or ``APEX_TPU_XENT_CHUNK``) the
loss is the chunked fused head (:mod:`apex_tpu_torch.ops.fused_lm_xent`)
on the tied word embedding; otherwise ``ce_half_residuals`` keeps the
cross entropy's softmax residual in bf16.  ``remat`` recomputes each
layer in the backward (:func:`apex_tpu_torch.utils.remat`), replaying
the generator so the recompute draws the forward's masks and seeds.

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP
queue 1, item 6, "multi-GPU layers over NCCL"): ``scan_layers`` (with
or without ``remat``), sequence and context parallelism and the MoE
FFN.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.fused_lm_xent import (fused_lm_head_cross_entropy,
                                              xent_chunk_default)
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.utils import remat, resolve_device

__all__ = ["GPTConfig", "ParallelMLP", "ParallelAttention",
           "ParallelTransformerLayer", "GPTEmbedding", "GPTModel",
           "gpt_model_provider", "model_device", "hidden_dropout"]

_MULTI = "ROADMAP queue 1, item 6 (multi-GPU layers over NCCL)"


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Megatron-style hyperparameters, the JAX package's defaults.
    GPT-3 1.3B: hidden 2048, 24 layers, 16 heads, max_seq 2048, vocab
    51200."""
    vocab_size: int = 51200
    hidden_size: int = 1024
    ffn_hidden_size: Optional[int] = None      # default 4*hidden
    num_layers: int = 12
    num_attention_heads: int = 16
    max_seq_length: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    params_dtype: Any = torch.float32
    sequence_parallel: bool = False
    context_parallel: bool = False
    remat: bool = False
    scan_layers: bool = False
    embedding_grad_via_matmul: bool = False
    ce_half_residuals: bool = False
    # chunked fused LM head + cross entropy: the token chunk; None reads
    # APEX_TPU_XENT_CHUNK (default 0, the unfused head)
    fused_head_xent: Optional[int] = None
    num_moe_experts: Optional[int] = None
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_load_balancing_type: str = "aux_loss"
    expert_model_parallel: bool = False

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size


def model_device(device) -> torch.device:
    """The device a standalone model is built on: CUDA unless ``"cpu"``
    is asked for, or ``"meta"`` for a model with no storage, whose
    forward is then run over a parameter tree with
    ``torch.func.functional_call`` (the serving engines do)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _need_generator(generator):
    if generator is None:
        raise ValueError(
            "dropout in training mode (deterministic=False) needs "
            "generator=, a torch.Generator on the activations' device (the "
            "counterpart of flax's rngs={'dropout': key})")
    return generator


def hidden_dropout(x, rate: float, deterministic: bool, generator=None):
    """flax ``nn.Dropout``: in training mode with ``rate > 0``, each
    element kept with probability ``1 - rate`` (a ``torch.rand`` draw
    from ``generator``) and scaled by ``1 / (1 - rate)``; else ``x``."""
    if deterministic or rate <= 0.0:
        return x
    u = torch.rand(x.shape, generator=_need_generator(generator),
                   device=x.device)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate),
                       torch.zeros_like(x))


def attention_seed(generator, device):
    """One attention-dropout seed: an int32 drawn from ``generator`` as a
    one-element tensor on ``device`` (no host sync), the counterpart of
    ``jax.random.bits(make_rng("dropout"))``."""
    return torch.randint(-2 ** 31, 2 ** 31, (1,),
                         generator=_need_generator(generator), device=device,
                         dtype=torch.int32)


def gelu(x):
    """``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class ParallelMLP(nn.Module):
    """h -> 4h (column) -> gelu -> h (row)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        kw = dict(params_dtype=cfg.params_dtype, device=device)
        self.dense_h_to_4h = ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn, gather_output=False, **kw)
        self.dense_4h_to_h = RowParallelLinear(
            cfg.ffn, cfg.hidden_size, input_is_parallel=True, **kw)

    def forward(self, x, deterministic: bool = True, generator=None):
        h, _ = self.dense_h_to_4h(x)
        out, _ = self.dense_4h_to_h(gelu(h))
        return out


class ParallelAttention(nn.Module):
    """Self-attention: the interleaved qkv projection, the flash
    kernels (causal or not, with the optional boolean mask, and in
    training mode attention dropout from one seed drawn from
    ``generator`` a call), the output projection."""

    def __init__(self, cfg: GPTConfig, causal: bool = True, device=None):
        super().__init__()
        self.cfg, self.causal = cfg, causal
        kw = dict(params_dtype=cfg.params_dtype, device=device)
        self.query_key_value = ColumnParallelLinear(
            cfg.hidden_size, 3 * cfg.hidden_size, gather_output=False, **kw)
        self.dense = RowParallelLinear(
            cfg.hidden_size, cfg.hidden_size, input_is_parallel=True, **kw)

    def forward(self, x, attention_mask=None, deterministic: bool = True,
                generator=None):
        cfg = self.cfg
        s, b = x.shape[0], x.shape[1]
        heads = cfg.num_attention_heads
        head_dim = cfg.hidden_size // heads
        qkv, _ = self.query_key_value(x)
        qkv = qkv.reshape(s, b, heads, 3 * head_dim)
        q, k, v = torch.split(qkv, head_dim, dim=-1)
        # [s, b, n, d] -> [b, n, s, d]
        q, k, v = (t.permute(1, 2, 0, 3) for t in (q, k, v))
        rate = (cfg.attention_dropout
                if not deterministic and cfg.attention_dropout > 0.0 else 0.0)
        seed = attention_seed(generator, x.device) if rate else None
        ctx = flash_attention(q, k, v, causal=self.causal,
                              mask=attention_mask, dropout_rate=rate,
                              dropout_seed=seed)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, -1)
        out, _ = self.dense(ctx)
        return out


class ParallelTransformerLayer(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, cfg: GPTConfig, causal: bool = True, device=None):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = FusedLayerNorm(cfg.hidden_size, device=device)
        self.self_attention = ParallelAttention(cfg, causal=causal,
                                                device=device)
        self.post_attention_layernorm = FusedLayerNorm(cfg.hidden_size,
                                                       device=device)
        self.mlp = ParallelMLP(cfg, device=device)

    def forward(self, x, attention_mask=None, deterministic: bool = True,
                generator=None):
        rate = self.cfg.hidden_dropout
        h = self.self_attention(self.input_layernorm(x), attention_mask,
                                deterministic, generator)
        x = x + hidden_dropout(h, rate, deterministic, generator)
        h = self.mlp(self.post_attention_layernorm(x), deterministic)
        return x + hidden_dropout(h, rate, deterministic, generator)


class GPTEmbedding(nn.Module):
    """Vocab-parallel word embedding + learned positions; tokens ``[b,
    s]`` -> hidden ``[s, b, h]``."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, params_dtype=cfg.params_dtype,
            device=device)
        pos = torch.empty(cfg.max_seq_length, cfg.hidden_size,
                          dtype=cfg.params_dtype, device=device)
        with torch.no_grad():
            pos.normal_(0.0, 0.02)
        self.position_embeddings = nn.Parameter(pos)

    def forward(self, tokens, deterministic: bool = True, generator=None):
        s = tokens.shape[1]
        h = self.word_embeddings(tokens) + self.position_embeddings[None, :s]
        return hidden_dropout(h.transpose(0, 1), self.cfg.hidden_dropout,
                              deterministic, generator)     # [s, b, h]


def _check_config(cfg) -> None:
    if parallel_state.model_parallel_is_initialized() and \
            parallel_state.get_tensor_model_parallel_world_size() > 1:
        raise NotImplementedError(
            "GPT and BERT at tensor_model_parallel_size "
            f"{parallel_state.get_tensor_model_parallel_world_size()} are "
            f"not ported ({_MULTI}): the JAX reference's tied raw-einsum "
            "head leaves each rank a rank-partial dhidden, so its grads at "
            "tp > 1 are not tp = 1's (ROADMAP queue 3, \"tied heads at "
            "tp > 1\")")
    for flag in ("sequence_parallel", "context_parallel", "scan_layers",
                 "expert_model_parallel"):
        if getattr(cfg, flag, False):
            raise NotImplementedError(
                f"{flag} is not ported yet ({_MULTI})")
    if getattr(cfg, "num_moe_experts", None):
        raise NotImplementedError(f"the MoE FFN is not ported yet ({_MULTI})")


def _run_layers(layers, h, attention_mask, deterministic: bool,
                generator, recompute: bool):
    """``h`` through each layer in turn; with ``recompute`` each layer
    under :func:`apex_tpu_torch.utils.remat` (the generator replayed)."""
    for layer in layers:
        if recompute:
            h = remat(layer, h, attention_mask, deterministic, generator,
                      generator=generator)
        else:
            h = layer(h, attention_mask, deterministic, generator)
    return h


class GPTModel(nn.Module):
    """embedding -> N layers -> final LayerNorm -> logits tied to the
    word embedding ``[s, b, vocab]``, or the mean cross entropy with
    ``labels [b, s]``.  Built on CUDA unless ``device="cpu"`` (or
    ``"meta"``, see :func:`model_device`).  ``deterministic=False``
    with ``generator=`` is training mode (the module docstring)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        device = model_device(device)
        _check_config(cfg)
        self.cfg = cfg
        self.embedding = GPTEmbedding(cfg, device=device)
        for i in range(cfg.num_layers):
            setattr(self, f"layer_{i}",
                    ParallelTransformerLayer(cfg, device=device))
        self.final_layernorm = FusedLayerNorm(cfg.hidden_size, device=device)

    def forward(self, tokens, labels=None, attention_mask=None,
                deterministic: bool = True, generator=None):
        cfg = self.cfg
        if tokens.shape[1] > cfg.max_seq_length:
            raise ValueError(
                f"sequence length {tokens.shape[1]} exceeds "
                f"max_seq_length {cfg.max_seq_length}")
        h = self.embedding(tokens, deterministic, generator)
        h = _run_layers([getattr(self, f"layer_{i}")
                         for i in range(cfg.num_layers)], h, attention_mask,
                        deterministic, generator, cfg.remat)
        h = self.final_layernorm(h)
        emb = self.embedding.word_embeddings.weight
        if labels is None:
            return torch.einsum("sbh,vh->sbv", h, emb)
        chunk = cfg.fused_head_xent
        if chunk is None:
            chunk = xent_chunk_default()
        if chunk > 0:
            loss = fused_lm_head_cross_entropy(h, emb, labels.T,
                                               token_chunk=chunk)
            return loss.mean()
        logits = torch.einsum("sbh,vh->sbv", h, emb)
        loss = vocab_parallel_cross_entropy(
            logits.float(), labels.T, half_residuals=cfg.ce_half_residuals)
        return loss.mean()


def gpt_model_provider(cfg: GPTConfig = GPTConfig(),
                       device=None) -> GPTModel:
    return GPTModel(cfg, device=device)
