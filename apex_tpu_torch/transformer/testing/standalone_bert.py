"""Standalone Megatron-style BERT of the port, at tp = 1.

Port of ``apex_tpu/transformer/testing/standalone_bert.py``:
:class:`BertConfig` (with ``gpt_cfg()``), :class:`BertModel` and
:func:`bert_model_provider`.  The GPT blocks of
:mod:`~apex_tpu_torch.transformer.testing.standalone_gpt` with
``causal=False``, token-type embeddings, the padding mask (``[b, s]``,
1 = keep) turned into the flash kernels' boolean ``[b, 1, s, s]`` with
True = masked, the MLM transform head (dense, GELU in the tanh
approximation, LayerNorm) with logits tied to the word embedding, and
the binary (NSP) head on the pooled first position.

Named parameters are the flax tree's key paths: the ``nn.Dense``
layers keep flax's ``kernel [in, out]`` and ``bias``, ``nn.Embed`` its
``embedding``.  The token-type table is always built (the flax module
creates it when ``token_types`` is passed, as the serving engine's
``encode`` always does).  ``deterministic=False`` with ``generator=``
is training mode, as in ``standalone_gpt``: hidden dropout after the
embeddings and in each layer, attention dropout inside the flash
kernels; the padding mask reaches them as the JAX package's ``mask3``
``[b, s, s]``, read by the ``h`` heads of each sequence.  ``remat`` and
``ce_half_residuals`` act as in ``standalone_gpt``.  ``sequence_parallel``
places JAX's regions (the sequence scattered after the embeddings,
gathered before the final LayerNorm) as the GPT does: at tp = 1, the
only tensor-parallel size BERT takes, both are the identity.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.transformer.tensor_parallel import (
    VocabParallelEmbedding,
    mappings,
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import glorot_normal_
from apex_tpu_torch.transformer.testing.standalone_gpt import (
    GPTConfig,
    ParallelTransformerLayer,
    _check_config,
    gelu,
    hidden_dropout,
    model_device,
    _run_layers,
    _sequence_region,
)

__all__ = ["BertConfig", "BertModel", "bert_model_provider"]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """BERT-large: hidden 1024, layers 24, heads 16, max_seq 512."""
    vocab_size: int = 30592                  # divisible-by-TP padded vocab
    hidden_size: int = 1024
    ffn_hidden_size: Optional[int] = None
    num_layers: int = 24
    num_attention_heads: int = 16
    max_seq_length: int = 512
    num_token_types: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    params_dtype: Any = torch.float32
    sequence_parallel: bool = False
    remat: bool = False
    embedding_grad_via_matmul: bool = False
    ce_half_residuals: bool = False

    def gpt_cfg(self) -> GPTConfig:
        return GPTConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            ffn_hidden_size=self.ffn_hidden_size,
            num_layers=self.num_layers,
            num_attention_heads=self.num_attention_heads,
            max_seq_length=self.max_seq_length,
            hidden_dropout=self.hidden_dropout,
            attention_dropout=self.attention_dropout,
            params_dtype=self.params_dtype,
            sequence_parallel=self.sequence_parallel,
            remat=self.remat,
            embedding_grad_via_matmul=self.embedding_grad_via_matmul,
            ce_half_residuals=self.ce_half_residuals)


class _Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, ``kernel [in, out]``."""

    def __init__(self, n_in: int, n_out: int, dtype, device):
        super().__init__()
        self.kernel = nn.Parameter(glorot_normal_(
            torch.empty(n_in, n_out, dtype=dtype, device=device)))
        self.bias = nn.Parameter(torch.zeros(n_out, dtype=dtype,
                                             device=device))

    def forward(self, x):
        return torch.matmul(x, self.kernel) + self.bias


class _Embed(nn.Module):
    """flax ``nn.Embed``: rows of ``embedding [num, features]``."""

    def __init__(self, num: int, features: int, dtype, device):
        super().__init__()
        w = torch.empty(num, features, dtype=dtype, device=device)
        with torch.no_grad():
            w.normal_(0.0, features ** -0.5)
        self.embedding = nn.Parameter(w)

    def forward(self, ids):
        return self.embedding[ids.long()]


class BertModel(nn.Module):
    """Embeddings -> N bidirectional layers -> final LayerNorm -> MLM
    head with tied logits ``[s, b, vocab]`` (+ NSP logits ``[b, 2]``
    from the pooled first position when ``add_binary_head``).  Built on
    CUDA unless ``device="cpu"`` (or ``"meta"``)."""

    def __init__(self, cfg: BertConfig, add_binary_head: bool = True,
                 device=None):
        super().__init__()
        device = model_device(device)
        gcfg = cfg.gpt_cfg()
        _check_config(gcfg)
        self.cfg, self.add_binary_head = cfg, add_binary_head
        dt = cfg.params_dtype
        self.word_embeddings = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, params_dtype=dt, device=device)
        pos = torch.empty(cfg.max_seq_length, cfg.hidden_size, dtype=dt,
                          device=device)
        with torch.no_grad():
            pos.normal_(0.0, 0.02)
        self.position_embeddings = nn.Parameter(pos)
        self.tokentype_embeddings = _Embed(cfg.num_token_types,
                                           cfg.hidden_size, dt, device)
        for i in range(cfg.num_layers):
            setattr(self, f"layer_{i}", ParallelTransformerLayer(
                gcfg, causal=False, device=device))
        self.final_layernorm = FusedLayerNorm(cfg.hidden_size, device=device)
        self.lm_head_dense = _Dense(cfg.hidden_size, cfg.hidden_size, dt,
                                    device)
        self.lm_head_layernorm = FusedLayerNorm(cfg.hidden_size,
                                                device=device)
        if add_binary_head:
            self.pooler = _Dense(cfg.hidden_size, cfg.hidden_size, dt, device)
            self.binary_head = _Dense(cfg.hidden_size, 2, dt, device)

    def forward(self, tokens, token_types=None, attention_mask=None,
                lm_labels=None, deterministic: bool = True, loss_mask=None,
                generator=None):
        cfg = self.cfg
        b, s = tokens.shape
        h = self.word_embeddings(tokens) + self.position_embeddings[None, :s]
        if token_types is not None:
            h = h + self.tokentype_embeddings(token_types)
        h = _sequence_region(h.transpose(0, 1), cfg,
                             mappings.scatter_to_sequence_parallel_region)
        h = hidden_dropout(h, cfg.hidden_dropout, deterministic,
                           generator)                   # [s, b, h]
        # padding mask [b, s] (1 = keep) -> [b, 1, s, s], True = masked,
        # built once: every layer's kernels read it as mask3 [b, s, s]
        mask4 = None
        if attention_mask is not None:
            keep = attention_mask.to(torch.bool)
            mask4 = (~keep)[:, None, None, :].expand(b, 1, s, s).contiguous()
        h = _run_layers([getattr(self, f"layer_{i}")
                         for i in range(cfg.num_layers)], h, mask4,
                        deterministic, generator, cfg.remat)
        h = _sequence_region(h, cfg, lambda t: (
            mappings.gather_from_sequence_parallel_region(
                t, tensor_parallel_output_grad=False)))
        h = self.final_layernorm(h)
        t = self.lm_head_layernorm(gelu(self.lm_head_dense(h)))
        lm_logits = torch.einsum("sbh,vh->sbv", t,
                                 self.word_embeddings.weight)
        binary_logits = None
        if self.add_binary_head:
            pooled = torch.tanh(self.pooler(h[0]))      # first position
            binary_logits = self.binary_head(pooled)
        if lm_labels is None:
            return lm_logits, binary_logits
        loss = vocab_parallel_cross_entropy(
            lm_logits.float(), lm_labels.T,
            half_residuals=cfg.ce_half_residuals)
        w = loss_mask if loss_mask is not None else attention_mask
        if w is not None:
            w = w.T.float()
            loss = (loss * w).sum() / torch.clamp(w.sum(), min=1.0)
        else:
            loss = loss.mean()
        return loss, binary_logits


def bert_model_provider(cfg: BertConfig = BertConfig(),
                        add_binary_head: bool = True,
                        device=None) -> BertModel:
    return BertModel(cfg, add_binary_head=add_binary_head, device=device)
