"""Prefill/decode forwards of GPT and LLaMA over the param tree, in
PyTorch.

Port of the tp = 1 half of ``apex_tpu/inference/models.py``: the same
parameter trees (``model.init``'s key paths, weights ``[out, in]`` so a
linear is ``x @ W.T``), the same op sequence call for call — the norm
kernel (GPT's LayerNorm with bias, LLaMA's RMSNorm), the causal
flash-attention kernel for a cold prefill, per decode layer the
attention of whichever cache the engine runs (the dense slot cache's
:func:`~apex_tpu_torch.ops.attention.decode_attention`, the paged
pool's decode kernel), GPT's learned positions, interleaved qkv, biases
and GELU MLP (tanh approximation) with logits tied to the word
embedding, LLaMA's RoPE, packed ``kv_proj`` split and GQA — so prefill
and decode logits track the JAX package on the same weights.

Where the JAX forwards branch on traced values inside one compiled
program (``lax.cond`` on the prefill start), these branch in Python:
PyTorch runs eagerly.  With ``fused`` (the layout of
:func:`fused_layer_params`, paged engines only) every decode layer is
one launch of the fused-block kernel instead.  Tensor-parallel serving
and speculative verify are later slices (ROADMAP queue 1, "tp and
spec").
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from apex_tpu_torch.inference import kv_cache
from apex_tpu_torch.ops import layer_norm, rms_norm
from apex_tpu_torch.ops.attention import (decode_attention, flash_attention,
                                          prefix_window_attention)
from apex_tpu_torch.ops.paged_attention import (fused_block_decode,
                                                paged_decode_attention)
from apex_tpu_torch.transformer.functional.fused_rope import (
    fused_apply_rotary_pos_emb_cached,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import gelu
from apex_tpu_torch.transformer.testing.standalone_llama import (
    _rope_cos_sin,
)

__all__ = ["model_dims", "tp_dims", "check_supported", "prefill_forward",
           "decode_forward", "fused_layer_params"]


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
    if kind not in ("gpt", "llama"):
        raise ValueError(f"unknown generative model kind {kind!r} "
                         "(expected 'gpt' or 'llama')")
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


def _cache_attend(cache, layer: int, q, live):
    """Single-token attention against ONE layer of whichever cache the
    engine runs: the dense slot window (:func:`~apex_tpu_torch.ops.
    attention.decode_attention`) or the paged pool through the slot
    page table (:func:`~apex_tpu_torch.ops.paged_attention.
    paged_decode_attention`).  Both score the pre-broadcast per-kv-head
    cache (GQA/MQA grouped)."""
    if isinstance(cache, kv_cache.PagedKVCache):
        return paged_decode_attention(q, cache.k[:, layer],
                                      cache.v[:, layer], cache.page_table,
                                      live, xla_max_pages=cache.attn_max_pages)
    return decode_attention(q, cache.k[:, layer], cache.v[:, layer], live)


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


def _fused_vec(p, name, width):
    """A norm parameter or a linear's bias as the fused layout's fp32
    ``[1, width]`` row."""
    return p[name].reshape(1, width).to(torch.float32)


def _gpt_fused_layer(lp, cfg, heads, d):
    """One GPT layer in the fused layout: the interleaved
    ``query_key_value`` (per head ``[q(d), k(d), v(d)]``) deinterleaved
    into ``wq``/``wk``/``wv`` and their biases, every vector fp32."""
    hidden = cfg.hidden_size
    att = lp["self_attention"]
    qkv = att["query_key_value"]
    w = qkv["weight"].T.reshape(hidden, heads, 3, d)
    b = _fused_vec(qkv, "bias", 3 * heads * d).reshape(heads, 3, d)
    ln1, ln2 = lp["input_layernorm"], lp["post_attention_layernorm"]
    mlp = lp["mlp"]
    blk = {"ln1_w": _fused_vec(ln1, "weight", hidden),
           "ln1_b": _fused_vec(ln1, "bias", hidden),
           "wo": att["dense"]["weight"].T.contiguous(),
           "bo": _fused_vec(att["dense"], "bias", hidden),
           "ln2_w": _fused_vec(ln2, "weight", hidden),
           "ln2_b": _fused_vec(ln2, "bias", hidden),
           "wu": mlp["dense_h_to_4h"]["weight"].T.contiguous(),
           "bu": _fused_vec(mlp["dense_h_to_4h"], "bias", cfg.ffn),
           "wd": mlp["dense_4h_to_h"]["weight"].T.contiguous(),
           "bd": _fused_vec(mlp["dense_4h_to_h"], "bias", hidden)}
    for j, n in enumerate("qkv"):
        blk[f"w{n}"] = w[:, :, j, :].reshape(hidden, heads * d).contiguous()
        blk[f"b{n}"] = b[:, j, :].reshape(1, heads * d).contiguous()
    return blk


def fused_layer_params(kind: str, cfg, params):
    """The per-layer weights in the fused-block layout, built once at
    engine construction: matmul-ready ``[in, out]`` matrices ``wq``,
    ``wk``, ``wv``, ``wo`` and the MLP's.  LLaMA: ``wk``/``wv`` split
    from the packed ``kv_proj`` (each kv head's k and v columns side by
    side), ``wg``, ``wu``, ``wd`` and the RMSNorm weights
    ``ln1_w``/``ln2_w`` as ``[1, hidden]``.  GPT: ``wq``/``wk``/``wv``
    deinterleaved from ``query_key_value`` with their biases
    ``bq``/``bk``/``bv``, ``bo``, the LayerNorms ``ln1_w``/``ln1_b``/
    ``ln2_w``/``ln2_b``, ``wu``/``bu``/``wd``/``bd``; every GPT vector
    is an fp32 ``[1, n]`` row (the kernel computes them in fp32; the
    JAX layout keeps their dtype).  A contiguous copy of every layer:
    the engine then holds both layouts (prefill reads the original
    tree)."""
    check_supported(kind, cfg)
    p = _params_subtree(params)
    dims = model_dims(kind, cfg)
    d = dims["head_dim"]
    hidden = cfg.hidden_size

    def io(w):                                  # [out, in] -> [in, out]
        return w.T.contiguous()

    out = []
    for i in range(cfg.num_layers):
        lp = p[f"layer_{i}"]
        if kind == "gpt":
            out.append(_gpt_fused_layer(lp, cfg, dims["heads"], d))
            continue
        att = lp["attention"]
        kvw = att["kv_proj"]["weight"].T
        kvh = kvw.shape[1] // (2 * d)
        kvw = kvw.reshape(hidden, kvh, 2, d)
        out.append({
            "ln1_w": lp["input_norm"]["weight"].reshape(1, hidden),
            "wq": io(att["q_proj"]["weight"]),
            "wk": kvw[:, :, 0, :].reshape(hidden, kvh * d).contiguous(),
            "wv": kvw[:, :, 1, :].reshape(hidden, kvh * d).contiguous(),
            "wo": io(att["o_proj"]["weight"]),
            "ln2_w": lp["post_attention_norm"]["weight"].reshape(1, hidden),
            "wg": io(lp["mlp"]["gate_proj"]["weight"]),
            "wu": io(lp["mlp"]["up_proj"]["weight"]),
            "wd": io(lp["mlp"]["down_proj"]["weight"]),
        })
    return out


# --------------------------------------------------------------------------
# GPT (standalone_gpt mirror)
# --------------------------------------------------------------------------

def _gpt_attn_proj(lp, h, heads, head_dim):
    """qkv projection + the model's reshape/split layout (per head
    ``[q(d), k(d), v(d)]``): q/k/v with a trailing ``[..., heads,
    head_dim]``."""
    qkv = _linear(lp["self_attention"]["query_key_value"], h)
    qkv = qkv.reshape(*h.shape[:-1], heads, 3 * head_dim)
    return torch.split(qkv, head_dim, dim=-1)


def _gpt_mlp(lp, h):
    return _linear(lp["mlp"]["dense_4h_to_h"],
                   gelu(_linear(lp["mlp"]["dense_h_to_4h"], h)))


def _ln(p, x):
    return layer_norm(x, p["weight"], p["bias"])


def _gpt_prefill(cfg, params, tokens, length=None, cache=None, row=None,
                 start=0):
    p = _params_subtree(params)
    b, s = tokens.shape
    dims = model_dims("gpt", cfg)
    heads, head_dim = dims["heads"], dims["head_dim"]
    suffix = cache is not None
    emb_w = p["embedding"]["word_embeddings"]["weight"]
    pos_tab = p["embedding"]["position_embeddings"]
    h = emb_w[tokens.long()]                                # [b, s, h]
    if suffix:
        # rows sit at absolute positions start + i (clamped: dead
        # bucket-padding rows past the table stay in range)
        positions = torch.clamp(
            start + torch.arange(s, device=tokens.device),
            max=pos_tab.shape[0] - 1)
        h = h + pos_tab[positions][None]
    else:
        h = h + pos_tab[None, :s]
    h = h.transpose(0, 1)                                   # [s, b, h]

    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = p[f"layer_{i}"]
        x = h
        h1 = _ln(lp["input_layernorm"], x)
        q, k, v = _gpt_attn_proj(lp, h1, heads, head_dim)   # [s, b, n, d]
        q, k, v = (t.permute(1, 2, 0, 3) for t in (q, k, v))
        ks.append(k[0])                                     # [n, s, d]
        vs.append(v[0])
        if suffix:
            ctx = _suffix_attend(cache, i, row, q, k, v, int(start))
        else:
            ctx = flash_attention(q, k, v, causal=True)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, -1)
        x = x + _linear(lp["self_attention"]["dense"], ctx)
        h = x + _gpt_mlp(lp, _ln(lp["post_attention_layernorm"], x))

    h = _ln(p["final_layernorm"], h)
    if length is not None:
        last = length - start if suffix else length   # local slab index
        logits = torch.matmul(_last_row(h, last), emb_w.T)    # [b, v]
    else:
        logits = torch.einsum("sbh,vh->sbv", h, emb_w)      # tied head
    return logits, torch.stack(ks), torch.stack(vs)


def _gpt_decode(cfg, params, cache, tokens, fused=None):
    p = _params_subtree(params)
    dims = model_dims("gpt", cfg)
    heads, head_dim = dims["heads"], dims["head_dim"]
    positions = cache.lengths                               # [slots]
    emb_w = p["embedding"]["word_embeddings"]["weight"]
    pos_tab = p["embedding"]["position_embeddings"]
    # a slot at the end of the table (its length at capacity) reads the
    # last row: its token is never appended (advance flags it), where
    # the JAX take reads a row of NaN
    rows = torch.clamp(positions.long(), max=pos_tab.shape[0] - 1)
    h = emb_w[tokens.long()] + pos_tab[rows]                # [slots, h]

    live = positions + 1                # incl. the token written now
    targets = kv_cache.append_targets(cache)  # same rows every layer
    for i in range(cfg.num_layers):
        if fused is not None:
            # the whole block in one kernel; only the pool append is
            # left to the per-op path
            h, k_tok, v_tok = fused_block_decode(
                h, fused[i], cache.k[:, i], cache.v[:, i], cache.page_table,
                positions, kind="gpt", eps=1e-5)
            cache = kv_cache.append_layer(cache, i, k_tok, v_tok, targets)
            continue
        lp = p[f"layer_{i}"]
        x = h
        h1 = _ln(lp["input_layernorm"], x)
        q, k_tok, v_tok = _gpt_attn_proj(lp, h1, heads, head_dim)
        cache = kv_cache.append_layer(cache, i, k_tok, v_tok, targets)
        ctx = _cache_attend(cache, i, q, live)
        x = x + _linear(lp["self_attention"]["dense"],
                        ctx.reshape(ctx.shape[0], -1))
        h = x + _gpt_mlp(lp, _ln(lp["post_attention_layernorm"], x))

    h = _ln(p["final_layernorm"], h)
    return torch.matmul(h, emb_w.T), cache                 # [slots, v]


# --------------------------------------------------------------------------
# LLaMA (standalone_llama mirror; GQA/MQA cached once per kv head)
# --------------------------------------------------------------------------

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


def _llama_decode_layer(lp, h, cache, i, cos, sin, live, targets, dims,
                        eps):
    """One unfused decode layer: RMSNorm, q/kv, RoPE, the pool append,
    paged attention over ``live`` tokens, o-proj, RMSNorm, the MLP."""
    heads, kv_heads = dims["heads_local"], dims["kv_heads_local"]
    x = h
    h1 = rms_norm(x, lp["input_norm"]["weight"], eps=eps)
    q, k_tok, v_tok = _llama_proj(lp, h1, heads, kv_heads, dims["head_dim"])
    q = fused_apply_rotary_pos_emb_cached(q, cos, sin)
    k_tok = fused_apply_rotary_pos_emb_cached(k_tok, cos, sin)
    cache = kv_cache.append_layer(cache, i, k_tok, v_tok, targets)
    # grouped-query scoring straight off the per-kv-head cache or pool
    ctx = _cache_attend(cache, i, q, live)
    x = x + _linear(lp["attention"]["o_proj"], ctx.reshape(ctx.shape[0], -1))
    h1 = rms_norm(x, lp["post_attention_norm"]["weight"], eps=eps)
    return x + _llama_mlp(lp, h1), cache


def _llama_decode(cfg, params, cache, tokens, fused=None):
    p = _params_subtree(params)
    dims = tp_dims("llama", cfg, 1)
    head_dim = dims["head_dim"]
    # a slot at the end of its window computes garbage that is never
    # appended (advance flags it); clamp so the table read stays in range
    positions = torch.clamp(cache.lengths.long(), max=cache.max_seq - 1)
    dev = cache.device

    h = p["embed_tokens"]["weight"][tokens.long()]          # [slots, h]
    cos_t, sin_t = _rope_cos_sin(cache.max_seq, head_dim, cfg.rope_theta,
                                 device=dev)
    cos2 = cos_t.reshape(cache.max_seq, head_dim)[positions]  # [slots, d]
    sin2 = sin_t.reshape(cache.max_seq, head_dim)[positions]
    cos, sin = cos2[:, None, :], sin2[:, None, :]           # [slots, 1, d]

    live = cache.lengths + 1            # incl. the token written now
    targets = kv_cache.append_targets(cache)  # same rows every layer
    for i in range(cfg.num_layers):
        if fused is not None:
            # one kernel for the layer: it reads the pool at the
            # pre-append lengths and folds the current token in itself
            h, k_tok, v_tok = fused_block_decode(
                h, fused[i], cache.k[:, i], cache.v[:, i], cache.page_table,
                cache.lengths, kind="llama", eps=cfg.rms_eps, cos=cos2,
                sin=sin2)
            cache = kv_cache.append_layer(cache, i, k_tok, v_tok, targets)
            continue
        h, cache = _llama_decode_layer(p[f"layer_{i}"], h, cache, i, cos,
                                       sin, live, targets, dims, cfg.rms_eps)

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

    Suffix mode (paged engines): with ``cache`` (the
    :class:`~apex_tpu_torch.inference.kv_cache.PagedKVCache`), ``row``
    (the slot's page-table row) and ``prefill_from`` (prompt tokens
    already cached), ``tokens`` is the bucket-padded uncached tail at
    absolute positions ``prefill_from + i`` and ``length`` is the TOTAL
    live length; ``prefill_from == 0`` is the cold path."""
    if tokens.dim() != 2 or tokens.shape[0] != 1:
        raise ValueError(
            f"prefill takes one prompt [1, s], got {tuple(tokens.shape)}")
    check_supported(kind, cfg)
    fn = _gpt_prefill if kind == "gpt" else _llama_prefill
    if cache is None:
        return fn(cfg, params, tokens, length)
    if row is None or prefill_from is None or length is None:
        raise ValueError(
            "suffix prefill needs cache, row, prefill_from AND length")
    return fn(cfg, params, tokens, int(length), cache=cache, row=row,
              start=int(prefill_from))


def decode_forward(kind: str, cfg, params, cache, tokens, fused=None):
    """One-token step for every slot: ``tokens [slots]`` -> ``(logits
    [slots, v], cache)`` with the new k/v appended (in place) at each
    slot's position, on the dense slot cache or the paged pool.
    Lengths do not advance here.

    ``fused`` is the per-layer layout of :func:`fused_layer_params`:
    with it every decoder layer is one fused-block kernel launch
    instead of the per-op sequence — the same embedding, LM head and
    pool append, logits within tolerance of the unfused path (the
    kernel keeps the residual in fp32 inside a layer, where the per-op
    path rounds it at each sublayer)."""
    check_supported(kind, cfg)
    fn = _gpt_decode if kind == "gpt" else _llama_decode
    return fn(cfg, params, cache, tokens, fused=fused)
