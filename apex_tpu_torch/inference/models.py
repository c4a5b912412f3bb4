"""Prefill/decode forwards of LLaMA over the param tree, in PyTorch.

Port of the LLaMA, tp = 1 half of ``apex_tpu/inference/models.py``: the
same parameter tree (``model.init``'s key paths, weights ``[out, in]``
so a linear is ``x @ W.T``), the same op sequence call for call — the
RMSNorm kernel, the causal flash-attention kernel for a cold prefill,
the paged decode-attention kernel for every decode layer, RoPE, the
packed ``kv_proj`` split, GQA — so prefill and decode logits track the
JAX package on the same weights.

Where the JAX forwards branch on traced values inside one compiled
program (``lax.cond`` on the prefill start), these branch in Python:
PyTorch runs eagerly.  GPT and BERT, tensor-parallel serving, the fused
decode block and speculative verify are later slices (ROADMAP queue 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from apex_tpu_torch.inference import kv_cache
from apex_tpu_torch.ops import rms_norm
from apex_tpu_torch.ops.attention import (flash_attention,
                                          prefix_window_attention)
from apex_tpu_torch.ops.paged_attention import paged_decode_attention
from apex_tpu_torch.transformer.functional.fused_rope import (
    fused_apply_rotary_pos_emb_cached,
)
from apex_tpu_torch.transformer.testing.standalone_llama import (
    _rope_cos_sin,
)

__all__ = ["model_dims", "tp_dims", "check_supported", "prefill_forward",
           "decode_forward"]


def model_dims(kind: str, cfg) -> dict:
    """Static cache geometry for a model config: layers / kv_heads /
    head_dim (+ query heads)."""
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    kv_heads = (cfg.kv_heads if kind == "llama"
                else cfg.num_attention_heads)
    return {"layers": cfg.num_layers, "heads": cfg.num_attention_heads,
            "kv_heads": kv_heads, "head_dim": head_dim}


def tp_dims(kind: str, cfg, tp: int) -> dict:
    """Per-rank geometry; this slice serves tp = 1 only."""
    if tp != 1:
        raise NotImplementedError(
            f"tensor-parallel serving (tp={tp}) is a later slice of the "
            f"port (ROADMAP queue 1, 'tp and spec')")
    d = model_dims(kind, cfg)
    return dict(d, heads_local=d["heads"], kv_heads_local=d["kv_heads"],
                kv_heads_pool=d["kv_heads"], rep=1)


def check_supported(kind: str, cfg) -> None:
    if kind in ("gpt", "bert"):
        raise NotImplementedError(
            f"{kind!r} serving is a later slice of the port (ROADMAP "
            f"queue 1, 'the dense cache and GPT serving'); this slice "
            f"serves 'llama'")
    if kind != "llama":
        raise ValueError(f"unknown generative model kind {kind!r}")
    for flag in ("sequence_parallel", "context_parallel", "scan_layers"):
        if getattr(cfg, flag, False):
            raise ValueError(
                f"inference forwards run tp=1 unrolled; cfg.{flag} is a "
                "training-topology knob — export the weights into a "
                "plain config instead")
    if getattr(cfg, "num_moe_experts", None):
        raise ValueError("MoE FFN decode is not implemented yet")


def _params_subtree(params):
    """Accept ``model.init``'s ``{"params": ...}`` or the bare tree."""
    return params["params"] if "params" in params and isinstance(
        params["params"], dict) else params


def _linear(p, x):
    """Column/RowParallelLinear at tp=1: ``x @ W.T (+ b)`` with the
    layers' ``[out, in]`` weight layout."""
    y = torch.matmul(x, p["weight"].T)
    if "bias" in p:
        y = y + p["bias"]
    return y


def _last_row(h, length: int):
    """Hidden state at the last REAL position of a bucket-padded
    ``[s, b, hid]`` activation (sliced before the LM head)."""
    return h[int(length) - 1]                               # [b, hid]


def _suffix_attend(cache, layer: int, row, q, k, v, start: int):
    """Prefill attention for a (possibly mid-prompt) token slab: cold
    (``start == 0``) it is the causal flash kernel with the kv heads
    broadcast over their query groups; warm (a prefix-cache hit or a
    later chunk of a chunked prefill) each row also attends to the
    cached prefix gathered from the slot's pages through ``row``.

    ``q``: ``[b, h, s, d]``; ``k``/``v``: pre-broadcast
    ``[b, kv_heads, s, d]``."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    group = h // kvh
    if start == 0:
        if group > 1:                   # GQA: share kv across the group
            k, v = (t[:, :, None].expand(b, kvh, group, s, d)
                    .reshape(b, h, s, d) for t in (k, v))
        return flash_attention(q, k, v, causal=True)
    # pk/pv [pages, kvh, ps, d] -> the slot's virtual window
    # [1, kvh, max_seq, d] in row order; unowned ordinals gather the
    # trash page (finite garbage masked by start)
    idx = torch.as_tensor(row, device=q.device).long()

    def window(pool):
        w = pool[:, layer][idx]                         # [mpps, kvh, ps, d]
        return w.permute(1, 0, 2, 3).reshape(1, kvh, -1, d).to(q.dtype)

    return prefix_window_attention(q, k, v, window(cache.k),
                                   window(cache.v), start)


def _llama_proj(lp, h, heads, kv_heads, head_dim):
    """q, and k/v split from the packed ``kv_proj``: per kv head, its k
    and v columns sit side by side (``[kv_heads, 2 * head_dim]``)."""
    q = _linear(lp["attention"]["q_proj"], h)
    kv = _linear(lp["attention"]["kv_proj"], h)
    q = q.reshape(*h.shape[:-1], heads, head_dim)
    k, v = torch.chunk(kv.reshape(*h.shape[:-1], kv_heads, 2 * head_dim),
                       2, dim=-1)
    return q, k, v


def _llama_mlp(lp, h):
    gate = _linear(lp["mlp"]["gate_proj"], h)
    up = _linear(lp["mlp"]["up_proj"], h)
    return _linear(lp["mlp"]["down_proj"], F.silu(gate) * up)


def _llama_prefill(cfg, params, tokens, length=None, cache=None, row=None,
                   start=0):
    p = _params_subtree(params)
    b, s = tokens.shape
    dims = tp_dims("llama", cfg, 1)
    heads, kv_heads = dims["heads_local"], dims["kv_heads_local"]
    head_dim = dims["head_dim"]
    group = heads // kv_heads
    suffix = cache is not None
    dev = tokens.device

    h = p["embed_tokens"]["weight"][tokens.long()]          # [b, s, h]
    h = h.transpose(0, 1)                                   # [s, b, h]
    if suffix:
        # RoPE at the slab's absolute positions start + i (clamped for
        # dead bucket-padding rows), indexed from the full-window table
        cos_t, sin_t = _rope_cos_sin(cache.max_seq, head_dim,
                                     cfg.rope_theta, device=dev)
        positions = torch.clamp(
            start + torch.arange(s, device=dev), max=cache.max_seq - 1)
        cos, sin = cos_t[positions], sin_t[positions]       # [s, 1, 1, d]
    else:
        cos, sin = _rope_cos_sin(s, head_dim, cfg.rope_theta, device=dev)

    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = p[f"layer_{i}"]
        x = h
        h1 = rms_norm(x, lp["input_norm"]["weight"], eps=cfg.rms_eps)
        q, k, v = _llama_proj(lp, h1, heads, kv_heads, head_dim)
        q = fused_apply_rotary_pos_emb_cached(q, cos, sin)
        k = fused_apply_rotary_pos_emb_cached(k, cos, sin)
        # cache the PRE-broadcast kv (once per kv head)
        ks.append(k.permute(1, 2, 0, 3)[0])                 # [kv, s, d]
        vs.append(v.permute(1, 2, 0, 3)[0])
        if suffix:
            qb, kb, vb = (t.permute(1, 2, 0, 3) for t in (q, k, v))
            ctx = _suffix_attend(cache, i, row, qb, kb, vb, int(start))
        else:
            if group > 1:               # GQA: share kv across the group
                k, v = (t[:, :, :, None, :].expand(
                    s, b, kv_heads, group, head_dim
                ).reshape(s, b, heads, head_dim) for t in (k, v))
            q, k, v = (t.permute(1, 2, 0, 3) for t in (q, k, v))
            ctx = flash_attention(q, k, v, causal=True)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, -1)
        x = x + _linear(lp["attention"]["o_proj"], ctx)
        h1 = rms_norm(x, lp["post_attention_norm"]["weight"],
                      eps=cfg.rms_eps)
        h = x + _llama_mlp(lp, h1)

    h = rms_norm(h, p["final_norm"]["weight"], eps=cfg.rms_eps)
    if length is not None:
        last = length - start if suffix else length   # local slab index
        logits = _linear(p["lm_head"], _last_row(h, last))    # [b, v]
    else:
        logits = _linear(p["lm_head"], h)                     # [s, b, v]
    return logits, torch.stack(ks), torch.stack(vs)


def _llama_decode(cfg, params, cache, tokens):
    p = _params_subtree(params)
    dims = tp_dims("llama", cfg, 1)
    heads, kv_heads = dims["heads_local"], dims["kv_heads_local"]
    head_dim = dims["head_dim"]
    # a slot at the end of its window computes garbage that is never
    # appended (advance flags it); clamp so the table read stays in range
    positions = torch.clamp(cache.lengths.long(), max=cache.max_seq - 1)
    dev = cache.device

    h = p["embed_tokens"]["weight"][tokens.long()]          # [slots, h]
    cos_t, sin_t = _rope_cos_sin(cache.max_seq, head_dim, cfg.rope_theta,
                                 device=dev)
    cos_t = cos_t.reshape(cache.max_seq, head_dim)
    sin_t = sin_t.reshape(cache.max_seq, head_dim)
    cos = cos_t[positions][:, None, :]                      # [slots, 1, d]
    sin = sin_t[positions][:, None, :]

    live = cache.lengths + 1            # incl. the token written now
    targets = kv_cache.append_targets(cache)  # same rows every layer
    for i in range(cfg.num_layers):
        lp = p[f"layer_{i}"]
        x = h
        h1 = rms_norm(x, lp["input_norm"]["weight"], eps=cfg.rms_eps)
        q, k_tok, v_tok = _llama_proj(lp, h1, heads, kv_heads, head_dim)
        q = fused_apply_rotary_pos_emb_cached(q, cos, sin)
        k_tok = fused_apply_rotary_pos_emb_cached(k_tok, cos, sin)
        cache = kv_cache.append_layer(cache, i, k_tok, v_tok, targets)
        # grouped-query scoring straight off the per-kv-head pool
        ctx = paged_decode_attention(q, cache.k[:, i], cache.v[:, i],
                                     cache.page_table, live)
        x = x + _linear(lp["attention"]["o_proj"],
                        ctx.reshape(ctx.shape[0], -1))
        h1 = rms_norm(x, lp["post_attention_norm"]["weight"],
                      eps=cfg.rms_eps)
        h = x + _llama_mlp(lp, h1)

    h = rms_norm(h, p["final_norm"]["weight"], eps=cfg.rms_eps)
    logits = _linear(p["lm_head"], h)                       # [slots, v]
    return logits, cache


def prefill_forward(kind: str, cfg, params, tokens, length=None, *,
                    cache=None, row=None, prefill_from=None):
    """Full-prompt forward: ``tokens [1, s]`` -> ``(logits, k_stack,
    v_stack)`` with k/v ``[layers, kv_heads, s, head_dim]``.

    With ``length`` (the real prompt length inside a bucket-padded
    ``s``) the LM head runs on ONLY the last real position —
    ``logits [1, v]``; without it every position is projected
    (``logits [s, 1, v]``, the full-forward shape).

    Suffix mode: with ``cache`` (the :class:`~apex_tpu_torch.inference.
    kv_cache.PagedKVCache`), ``row`` (the slot's page-table row) and
    ``prefill_from`` (prompt tokens already cached), ``tokens`` is the
    bucket-padded uncached tail at absolute positions ``prefill_from +
    i`` and ``length`` is the TOTAL live length; ``prefill_from == 0``
    is the cold path."""
    if tokens.dim() != 2 or tokens.shape[0] != 1:
        raise ValueError(
            f"prefill takes one prompt [1, s], got {tuple(tokens.shape)}")
    check_supported(kind, cfg)
    if cache is None:
        return _llama_prefill(cfg, params, tokens, length)
    if row is None or prefill_from is None or length is None:
        raise ValueError(
            "suffix prefill needs cache, row, prefill_from AND length")
    return _llama_prefill(cfg, params, tokens, int(length), cache=cache,
                          row=row, start=int(prefill_from))


def decode_forward(kind: str, cfg, params, cache, tokens):
    """One-token step for every slot: ``tokens [slots]`` -> ``(logits
    [slots, v], cache)`` with the new k/v appended (in place) at each
    slot's position.  Lengths do not advance here."""
    check_supported(kind, cfg)
    return _llama_decode(cfg, params, cache, tokens)
