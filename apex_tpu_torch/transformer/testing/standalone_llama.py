"""The LLaMA configuration and RoPE tables of the port.

Port of the config half of ``apex_tpu/transformer/testing/
standalone_llama.py``: :class:`LlamaConfig` (with its ``kv_heads`` and
``ffn`` properties) and :func:`_rope_cos_sin`.  The flax training model
comes with the training slice; serving runs the forwards in
:mod:`apex_tpu_torch.inference.models` over the same parameter tree.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["LlamaConfig"]


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
