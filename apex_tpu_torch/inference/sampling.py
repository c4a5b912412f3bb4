"""Token sampling: greedy / temperature / top-k with an explicit
``torch.Generator``.

Port of ``apex_tpu/inference/sampling.py``.  The JAX package threads a
PRNG key per call (folded from the step counter); here the engine owns
one seeded ``torch.Generator`` on its device and every sampled call
draws from it in turn.  The two give different bits from the same seed,
so parity with the JAX package is held on greedy decoding; sampled
decoding is held on the top-k mask and on the distribution.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SamplingConfig", "greedy", "sample_token"]


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Sampling policy.  ``temperature = 0`` means greedy (the HF
    convention); ``top_k = 0`` means the full vocabulary."""
    temperature: float = 0.0
    top_k: int = 0

    def __post_init__(self):
        # a negative temperature would silently invert the distribution
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0 (0 = greedy), got "
                f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = full vocab), "
                             f"got {self.top_k}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


def greedy(logits):
    """Argmax over the last axis -> int32 token ids (first maximum on
    ties, as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _top_k_mask(logits, k: int):
    """Mask logits outside the per-row top k to -inf."""
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= thresh, logits,
                       torch.full_like(logits, float("-inf")))


def sample_token(logits, generator: Optional[torch.Generator],
                 cfg: SamplingConfig):
    """Draw one token per row of ``logits [..., vocab]``; the generator
    is ignored under greedy."""
    if cfg.is_greedy:
        return greedy(logits)
    scaled = logits.float() / cfg.temperature
    if cfg.top_k:
        scaled = _top_k_mask(scaled, min(cfg.top_k, logits.shape[-1]))
    probs = torch.softmax(scaled, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    toks = torch.multinomial(flat, 1, generator=generator)
    return toks.reshape(probs.shape[:-1]).to(torch.int32)
