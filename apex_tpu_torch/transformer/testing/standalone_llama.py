"""Standalone LLaMA-family decoder of the port.

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
vocab-parallel cross entropy over fp32 logits.  With labels and
``fused_head_xent`` > 0 (or ``APEX_TPU_XENT_CHUNK``) the loss is the
chunked fused head (:mod:`apex_tpu_torch.ops.fused_lm_xent`) on the same
``lm_head.weight``, so no ``[tokens, vocab]`` logits are made; ``remat``
recomputes each layer in the backward (:func:`apex_tpu_torch.utils.remat`).
Neither changes a parameter name.  Serving runs the forwards in
:mod:`apex_tpu_torch.inference.models` over the same parameter tree.

Tensor parallelism (tp from ``parallel_state``'s topology, one process
a rank): each rank holds ``heads / tp`` q heads and its shards of the
column- and row-parallel projections, the embedding and the head.
When tp divides ``kv_heads`` each rank owns whole kv heads of the
packed ``kv_proj``; otherwise ``kv_proj`` is replicated (``copy_to``
before a plain linear), each local q head takes its kv head by the
global index ``rank * heads_local + i``, and the replicated weight's
grads must be all-reduced by :func:`reduce_llama_grads` or the ranks
part.  The head is the column-parallel linear with the sharded cross
entropy, or the fused vocab-parallel head with ``grad_input_psum``.
:func:`apex_tpu_torch.inference.weights.shard_llama_params` gives a
rank its shard of a tp = 1 tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.normalization import FusedRMSNorm
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.fused_lm_xent import (
    fused_lm_head_cross_entropy, fused_lm_head_vocab_parallel_cross_entropy,
    xent_chunk_default)
from apex_tpu_torch.parallel import _comm
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.functional.fused_rope import (
    fused_apply_rotary_pos_emb_cached,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    copy_to_tensor_model_parallel_region,
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import glorot_normal_
from apex_tpu_torch.transformer.tensor_parallel.mappings import axis_size
from apex_tpu_torch.transformer.utils import divide
from apex_tpu_torch.utils import remat, resolve_device

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaBlock",
           "LlamaModel", "llama_model_provider", "reduce_llama_grads"]


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
    # the embedding's backward as a one-hot product instead of a
    # scatter-add (VocabParallelEmbedding(grad_via_matmul=True))
    embedding_grad_via_matmul: bool = False
    # chunked fused LM head + cross entropy: the token chunk; None reads
    # APEX_TPU_XENT_CHUNK (default 0, the unfused head)
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


class LlamaAttention(nn.Module):
    """GQA self-attention: q heads (and, when tp divides them, kv heads)
    sharded over the tensor ranks; RoPE on q/k; causal flash attention
    core."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.hidden_size // cfg.num_attention_heads
        kw = dict(bias=False, params_dtype=cfg.params_dtype, device=device)
        self.tp = axis_size()
        self.heads_local = divide(cfg.num_attention_heads, self.tp)
        self.kv_sharded = cfg.kv_heads % self.tp == 0
        self.q_proj = ColumnParallelLinear(
            cfg.hidden_size, cfg.num_attention_heads * hd,
            gather_output=False, **kw)
        if self.kv_sharded:
            self.kv_proj = ColumnParallelLinear(
                cfg.hidden_size, 2 * cfg.kv_heads * hd, gather_output=False,
                **kw)
        else:
            # replicated: every rank computes all kv heads
            self.kv_proj = nn.Linear(cfg.hidden_size, 2 * cfg.kv_heads * hd,
                                     bias=False, dtype=cfg.params_dtype,
                                     device=device)
            glorot_normal_(self.kv_proj.weight)
        self.o_proj = RowParallelLinear(
            cfg.num_attention_heads * hd, cfg.hidden_size,
            input_is_parallel=True, **kw)

    def forward(self, x):
        cfg = self.cfg
        s, b = x.shape[0], x.shape[1]
        heads, kvh = cfg.num_attention_heads, cfg.kv_heads
        hd = cfg.hidden_size // heads
        hl = self.heads_local
        q, _ = self.q_proj(x)
        if self.kv_sharded:
            kv, _ = self.kv_proj(x)
            kv_local = kvh // self.tp
        else:
            # copy_to's backward all-reduces dx, so the grads upstream
            # agree across ranks; the kv WEIGHT grads are each rank's
            # partial (reduce_llama_grads)
            x_kv = copy_to_tensor_model_parallel_region(x) \
                if self.tp > 1 else x
            kv = self.kv_proj(x_kv)
            kv_local = kvh
        q = q.reshape(s, b, hl, hd)
        k, v = torch.split(kv.reshape(s, b, kv_local, 2 * hd), hd, dim=-1)
        cos, sin = _rope_cos_sin(s, hd, cfg.rope_theta, device=x.device)
        q = fused_apply_rotary_pos_emb_cached(q, cos, sin)
        k = fused_apply_rotary_pos_emb_cached(k, cos, sin)
        group = heads // kvh
        if self.kv_sharded:
            if group > 1:      # GQA: share each kv head across its q heads
                k, v = (t[:, :, :, None, :].expand(s, b, kv_local, group, hd)
                        .reshape(s, b, hl, hd) for t in (k, v))
        else:
            # replicated kv: each LOCAL q head's kv head by its global
            # index rank * heads_local + i
            rank = parallel_state.get_tensor_model_parallel_rank() \
                if self.tp > 1 else 0
            ids = (rank * hl + torch.arange(hl, device=x.device)) // group
            k, v = (t.index_select(2, ids) for t in (k, v))
        # [s, b, n, d] -> [b, n, s, d]
        q, k, v = (t.permute(1, 2, 0, 3) for t in (q, k, v))
        ctx = flash_attention(q, k, v, causal=True)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, hl * hd)
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
        self.cfg = cfg
        self.embed_tokens = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, params_dtype=cfg.params_dtype,
            device=device, grad_via_matmul=cfg.embedding_grad_via_matmul)
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
        h = self.embed_tokens(tokens).transpose(0, 1)      # [s, b, h]
        for i in range(cfg.num_layers):
            layer = getattr(self, f"layer_{i}")
            h = remat(layer, h) if cfg.remat else layer(h)
        h = self.final_norm(h)
        chunk = cfg.fused_head_xent
        if chunk is None:
            chunk = xent_chunk_default()
        if labels is not None and chunk > 0:
            if self.lm_head.tp > 1:
                # grad_input_psum: the column-parallel head's all-reduce
                # of dhidden
                loss = fused_lm_head_vocab_parallel_cross_entropy(
                    h, self.lm_head.weight, labels.T, token_chunk=chunk,
                    grad_input_psum=True)
            else:
                loss = fused_lm_head_cross_entropy(
                    h, self.lm_head.weight, labels.T, token_chunk=chunk)
            return loss.mean()
        logits, _ = self.lm_head(h)
        if labels is None:
            return logits
        loss = vocab_parallel_cross_entropy(logits.float(), labels.T)
        return loss.mean()


def reduce_llama_grads(grads, cfg: LlamaConfig, *, offsets=None):
    """The replicated-kv path's grad reduction: when tp does not divide
    ``kv_heads`` the ``kv_proj`` weights are replicated but each rank
    backpropagates only its own q heads' share, so their grads are
    all-reduced over the tensor group (in place).  Every other
    replicated weight (the norms) gets equal grads on every rank.  The
    grads unchanged when kv is sharded or tp = 1.

    ``grads`` is a grad tree (nested dicts of tensors, the model's key
    paths), or the flat grads of the flat-native step with ``offsets``,
    :func:`apex_tpu_torch.train_step.leaf_offsets` of the model, so it
    serves as ``make_train_step(grad_transform=...)``.  A ZeRO step's
    grad shard has no such windows: a flat length other than the
    layout's raises ``ValueError``."""
    tp = axis_size()
    if tp == 1 or cfg.kv_heads % tp == 0:
        return grads
    group = parallel_state.get_tensor_model_parallel_group()
    if isinstance(grads, torch.Tensor):
        if offsets is None:
            raise ValueError("flat grads need offsets= (leaf_offsets of "
                             "the model) to find the kv_proj windows")
        total = sum(size for _, size, _ in offsets.values())
        if grads.numel() != total:
            raise ValueError(
                f"{grads.numel()} flat grads are not the {total} of the "
                f"layout: the kv_proj windows index the full grads (a ZeRO "
                f"shard has none)")
        for key, (off, size, _) in offsets.items():
            if "kv_proj" in key:
                _comm.all_reduce(grads[off:off + size], group)
        return grads

    def fix(node, inside):
        if isinstance(node, dict):
            return {k: fix(v, inside or k == "kv_proj")
                    for k, v in node.items()}
        return _comm.all_reduce(node, group) if inside else node

    return fix(grads, False)


def llama_model_provider(cfg: LlamaConfig = LlamaConfig(),
                         device=None) -> LlamaModel:
    return LlamaModel(cfg, device=device)
