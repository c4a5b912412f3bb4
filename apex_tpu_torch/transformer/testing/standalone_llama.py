"""Standalone LLaMA-family decoder of the port, at tp = 1.

Port of ``apex_tpu/transformer/testing/standalone_llama.py``:
:class:`LlamaConfig` (with its ``kv_heads`` and ``ffn`` properties),
:func:`_rope_cos_sin`, and the training model — :class:`LlamaAttention`,
:class:`LlamaMLP`, :class:`LlamaBlock`, :class:`LlamaModel` and
:func:`llama_model_provider` — as ``nn.Module``s whose named parameters
map one to one onto the flax tree's key paths
(``layer_0.attention.q_proj.weight`` is ``layer_0/attention/q_proj/
weight``).  Same op sequence: pre-norm fused RMSNorm (fp32 weights
whatever ``params_dtype``), RoPE, the packed ``kv_proj`` (each kv
head's k and v side by side), GQA by broadcasting k/v to the q heads
before the causal flash kernels, SwiGLU, an untied LM head and the
tp = 1 cross entropy over fp32 logits.  Serving runs the forwards in
:mod:`apex_tpu_torch.inference.models` over the same parameter tree.

Not ported yet: the chunked fused LM head + cross entropy
(``fused_head_xent`` > 0, or ``APEX_TPU_XENT_CHUNK``; ROADMAP queue 1,
"chunked fused LM head"), activation recompute (``remat``) and tp > 1;
they raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.normalization import FusedRMSNorm
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.transformer.functional.fused_rope import (
    fused_apply_rotary_pos_emb_cached,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import glorot_normal_
from apex_tpu_torch.utils import resolve_device

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaBlock",
           "LlamaModel", "llama_model_provider"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Defaults give a test-scale model; override for real sizes
    (Llama-3-8B: hidden 4096, 32 layers, 32 heads, 8 kv heads, ffn
    14336, vocab 128256, rope_theta 500000, max_seq 8192)."""
    vocab_size: int = 32000
    hidden_size: int = 512
    num_layers: int = 4
    num_attention_heads: int = 8
    num_kv_heads: Optional[int] = None         # None = MHA; < heads = GQA
    ffn_hidden_size: Optional[int] = None      # None = LLaMA's 8/3 rule
    max_seq_length: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    params_dtype: Any = torch.float32
    remat: bool = False
    # chunked fused LM head + cross entropy: None reads
    # APEX_TPU_XENT_CHUNK (default 0, the unfused head); > 0 is not
    # ported yet
    fused_head_xent: Optional[int] = None

    def __post_init__(self):
        if self.num_attention_heads % self.kv_heads:
            raise ValueError(
                f"num_attention_heads ({self.num_attention_heads}) must "
                f"be a multiple of num_kv_heads ({self.kv_heads})")

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_attention_heads

    @property
    def ffn(self) -> int:
        if self.ffn_hidden_size is not None:
            return self.ffn_hidden_size
        # LLaMA sizing: 2/3 * 4h, rounded up to a multiple of 256
        raw = int(8 * self.hidden_size / 3)
        return (raw + 255) // 256 * 256


def _rope_cos_sin(seq_len: int, dim: int, theta: float, device=None):
    """[s, 1, 1, dim] fp32 cos/sin tables (NeoX half-split convention —
    the layout ``_rotate_half`` in fused_rope expects)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    freqs = torch.outer(torch.arange(seq_len, dtype=torch.float32,
                                     device=device), inv)
    emb = torch.cat([freqs, freqs], dim=-1)[:, None, None, :]
    return torch.cos(emb), torch.sin(emb)


def _xent_chunk(cfg) -> int:
    if cfg.fused_head_xent is not None:
        return int(cfg.fused_head_xent)
    return int(os.environ.get("APEX_TPU_XENT_CHUNK", "0"))


class LlamaAttention(nn.Module):
    """GQA self-attention: RoPE on q/k, causal flash attention core."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.hidden_size // cfg.num_attention_heads
        kw = dict(bias=False, params_dtype=cfg.params_dtype, device=device)
        self.q_proj = ColumnParallelLinear(
            cfg.hidden_size, cfg.num_attention_heads * hd,
            gather_output=False, **kw)
        self.kv_proj = ColumnParallelLinear(
            cfg.hidden_size, 2 * cfg.kv_heads * hd, gather_output=False,
            **kw)
        self.o_proj = RowParallelLinear(
            cfg.num_attention_heads * hd, cfg.hidden_size,
            input_is_parallel=True, **kw)

    def forward(self, x):
        cfg = self.cfg
        s, b = x.shape[0], x.shape[1]
        heads, kvh = cfg.num_attention_heads, cfg.kv_heads
        hd = cfg.hidden_size // heads
        q, _ = self.q_proj(x)
        kv, _ = self.kv_proj(x)
        q = q.reshape(s, b, heads, hd)
        k, v = torch.split(kv.reshape(s, b, kvh, 2 * hd), hd, dim=-1)
        cos, sin = _rope_cos_sin(s, hd, cfg.rope_theta, device=x.device)
        q = fused_apply_rotary_pos_emb_cached(q, cos, sin)
        k = fused_apply_rotary_pos_emb_cached(k, cos, sin)
        group = heads // kvh
        if group > 1:      # GQA: share each kv head across its q heads
            k, v = (t[:, :, :, None, :].expand(s, b, kvh, group, hd)
                    .reshape(s, b, heads, hd) for t in (k, v))
        # [s, b, n, d] -> [b, n, s, d]
        q, k, v = (t.permute(1, 2, 0, 3) for t in (q, k, v))
        ctx = flash_attention(q, k, v, causal=True)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, heads * hd)
        out, _ = self.o_proj(ctx)
        return out


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        kw = dict(bias=False, params_dtype=cfg.params_dtype, device=device)
        self.gate_proj = ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn, gather_output=False, **kw)
        self.up_proj = ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn, gather_output=False, **kw)
        self.down_proj = RowParallelLinear(
            cfg.ffn, cfg.hidden_size, input_is_parallel=True, **kw)

    def forward(self, x):
        gate, _ = self.gate_proj(x)
        up, _ = self.up_proj(x)
        out, _ = self.down_proj(F.silu(gate) * up)
        return out


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.input_norm = FusedRMSNorm(cfg.hidden_size, eps=cfg.rms_eps,
                                       device=device)
        self.attention = LlamaAttention(cfg, device=device)
        self.post_attention_norm = FusedRMSNorm(
            cfg.hidden_size, eps=cfg.rms_eps, device=device)
        self.mlp = LlamaMLP(cfg, device=device)

    def forward(self, x):
        x = x + self.attention(self.input_norm(x))
        return x + self.mlp(self.post_attention_norm(x))


class LlamaModel(nn.Module):
    """tokens [b, s] -> mean loss (with labels) or [s, b, vocab]
    logits.  Layers are the attributes ``layer_0`` .. ``layer_{n-1}``,
    the flax module names.  Built on CUDA unless ``device="cpu"``."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        if cfg.remat:
            raise NotImplementedError(
                "activation recompute (remat) is not ported yet (ROADMAP "
                "queue 1, 'chunked fused LM head and remat')")
        self.cfg = cfg
        self.embed_tokens = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, params_dtype=cfg.params_dtype,
            device=device)
        for i in range(cfg.num_layers):
            setattr(self, f"layer_{i}", LlamaBlock(cfg, device=device))
        self.final_norm = FusedRMSNorm(cfg.hidden_size, eps=cfg.rms_eps,
                                       device=device)
        self.lm_head = ColumnParallelLinear(
            cfg.hidden_size, cfg.vocab_size, bias=False, gather_output=False,
            params_dtype=cfg.params_dtype, device=device)

    def reset_parameters(self, generator=None):
        """Draw every weight anew at the JAX initialisers' scales: the
        linears N(0, 2 / (fan_in + fan_out)), the embedding N(0, 0.02^2),
        the norms 1."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("norm.weight"):
                    p.fill_(1.0)
                elif name.startswith("embed_tokens"):
                    p.normal_(0.0, 0.02, generator=generator)
                else:
                    glorot_normal_(p, generator=generator)

    def forward(self, tokens, labels=None):
        cfg = self.cfg
        if tokens.shape[1] > cfg.max_seq_length:
            raise ValueError(
                f"sequence length {tokens.shape[1]} exceeds "
                f"max_seq_length {cfg.max_seq_length}")
        if labels is not None and _xent_chunk(cfg) > 0:
            raise NotImplementedError(
                "the chunked fused LM head + cross entropy (fused_head_xent "
                "/ APEX_TPU_XENT_CHUNK > 0) is not ported yet (ROADMAP "
                "queue 1, 'chunked fused LM head and remat')")
        h = self.embed_tokens(tokens).transpose(0, 1)      # [s, b, h]
        for i in range(cfg.num_layers):
            h = getattr(self, f"layer_{i}")(h)
        h = self.final_norm(h)
        logits, _ = self.lm_head(h)
        if labels is None:
            return logits
        loss = vocab_parallel_cross_entropy(logits.float(), labels.T)
        return loss.mean()


def llama_model_provider(cfg: LlamaConfig = LlamaConfig(),
                         device=None) -> LlamaModel:
    return LlamaModel(cfg, device=device)
