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
one launch of the fused-block kernel instead.

The speculative verify forward (:func:`verify_forward`) scores an
``S``-token slab per slot in one batched step: the slab's k/v appended
at ``[lengths, lengths + S)`` (:func:`~apex_tpu_torch.inference.
kv_cache.append_slab`), then per layer the dense cache's
:func:`~apex_tpu_torch.ops.attention.slab_decode_attention` or the
paged pool's :func:`~apex_tpu_torch.ops.paged_attention.
paged_slab_attention` (the paged decode kernel over the folded slab on
CUDA).  A fused engine verifies through the unfused tree, as in JAX.
Tensor-parallel serving is a later slice (ROADMAP queue 1, "tp and
spec").
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex_tpu_torch.inference import kv_cache
from apex_tpu_torch.ops import layer_norm, rms_norm
from apex_tpu_torch.ops.attention import (decode_attention, flash_attention,
                                          prefix_window_attention,
                                          slab_decode_attention)
from apex_tpu_torch.ops.paged_attention import (fused_block_decode,
                                                paged_decode_attention,
                                                paged_slab_attention)
from apex_tpu_torch.transformer.functional.fused_rope import (
    fused_apply_rotary_pos_emb_cached,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import gelu
from apex_tpu_torch.transformer.testing.standalone_llama import (
    _rope_cos_sin,
)

__all__ = ["model_dims", "tp_dims", "check_supported", "prefill_forward",
           "decode_forward", "verify_forward", "fused_layer_params",
           "expand_kv_for_tp", "param_partition_specs",
           "fused_partition_specs", "shard_tree"]


def model_dims(kind: str, cfg) -> dict:
    """Static cache geometry for a model config: layers / kv_heads /
    head_dim (+ query heads)."""
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    kv_heads = (cfg.kv_heads if kind == "llama"
                else cfg.num_attention_heads)
    return {"layers": cfg.num_layers, "heads": cfg.num_attention_heads,
            "kv_heads": kv_heads, "head_dim": head_dim}


def tp_dims(kind: str, cfg, tp: int) -> dict:
    """Per-rank geometry under tensor-parallel serving, validated.

    ``heads_local`` / ``kv_heads_local`` are what each rank's forwards
    compute with; ``kv_heads_pool`` is the global kv-head count of the
    sharded paged pool (``kv_heads * rep``: GQA/MQA heads replicate
    below tp, each kv head repeated ``rep = tp / kv_heads`` times
    head-major, so the plain shard over the pool's kv-head dim hands
    every rank the kv head its query group reads)."""
    d = model_dims(kind, cfg)
    heads, kvh = d["heads"], d["kv_heads"]
    if tp <= 1:
        return dict(d, heads_local=heads, kv_heads_local=kvh,
                    kv_heads_pool=kvh, rep=1)
    if heads % tp:
        raise ValueError(
            f"tp={tp} does not divide num_attention_heads={heads}")
    if kvh % tp == 0:
        rep = 1
    elif tp % kvh == 0:
        rep = tp // kvh
    else:
        raise ValueError(
            f"tp={tp} vs kv_heads={kvh}: need tp | kv_heads (shard) or "
            f"kv_heads | tp (replicate below tp)")
    return dict(d, heads_local=heads // tp,
                kv_heads_local=max(kvh // tp, 1),
                kv_heads_pool=kvh * rep, rep=rep)


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


def _row_linear(p, x, tp: int = 1, group=None):
    """RowParallelLinear's forward: the local in-shard product, ONE
    ``all_reduce`` at the row boundary, the bias added once after it (a
    bias on every rank would add ``tp`` copies).  At tp = 1 this is
    :func:`_linear`."""
    y = torch.matmul(x, p["weight"].T)
    if tp > 1:
        dist.all_reduce(y, group=group)
    if "bias" in p:
        y = y + p["bias"]
    return y


def _vocab_embed(emb_w, tokens, tp: int = 1, group=None):
    """The vocab-parallel embedding lookup: each rank holds rows
    ``[rank * vp, (rank + 1) * vp)`` of the table (``rank`` its rank in
    ``group``), out-of-shard tokens take row 0 and are zeroed, and the
    ``all_reduce`` reassembles the full embedding on every rank."""
    if tp <= 1:
        return emb_w[tokens.long()]
    vp = emb_w.shape[0]
    start = dist.get_rank(group) * vp
    t = tokens.long()
    mask = (t < start) | (t >= start + vp)
    e = emb_w[torch.clamp(t - start, 0, vp - 1)]
    e = torch.where(mask[..., None], torch.zeros((), dtype=e.dtype,
                                                 device=e.device), e)
    dist.all_reduce(e, group=group)
    return e


def _gather_logits(local, tp: int = 1, group=None):
    """Reassemble vocab-sharded logits: the rank shards gathered from
    ``group`` and concatenated along the vocab dim in rank order, which
    is the vocab order (shard ``r`` holds rows ``[r * vp, (r + 1) *
    vp)``).  A gather is a copy, so every rank holds the same logits bit
    for bit."""
    if tp <= 1:
        return local
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(tp)]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim=-1)


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


def _slab_attend(cache, layer: int, q, lengths):
    """Verify-slab attention against ONE layer of whichever cache the
    engine runs: the dense slot window scored directly
    (:func:`~apex_tpu_torch.ops.attention.slab_decode_attention`) or the
    paged pool through the slot page table
    (:func:`~apex_tpu_torch.ops.paged_attention.paged_slab_attention`).
    ``lengths`` is the live count before the slab was appended."""
    if isinstance(cache, kv_cache.PagedKVCache):
        return paged_slab_attention(q, cache.k[:, layer], cache.v[:, layer],
                                    cache.page_table, lengths)
    return slab_decode_attention(q, cache.k[:, layer], cache.v[:, layer],
                                 lengths)


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


def _llama_mlp(lp, h, tp: int = 1, group=None):
    gate = _linear(lp["mlp"]["gate_proj"], h)
    up = _linear(lp["mlp"]["up_proj"], h)
    return _row_linear(lp["mlp"]["down_proj"], F.silu(gate) * up, tp, group)


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
    return list(_fused_layers(kind, cfg, params))


def _fused_layers(kind: str, cfg, params):
    """:func:`fused_layer_params` one layer at a time (a generator): a
    tensor-parallel engine shards each layer as it is built, so the
    whole unsharded layout is never alive at once."""
    check_supported(kind, cfg)
    p = _params_subtree(params)
    dims = model_dims(kind, cfg)
    d = dims["head_dim"]
    hidden = cfg.hidden_size

    def io(w):                                  # [out, in] -> [in, out]
        return w.T.contiguous()

    for i in range(cfg.num_layers):
        lp = p[f"layer_{i}"]
        if kind == "gpt":
            yield _gpt_fused_layer(lp, cfg, dims["heads"], d)
            continue
        att = lp["attention"]
        kvw = att["kv_proj"]["weight"].T
        # the kv-head count from the weight, not the config: a
        # kv-expanded tree (expand_kv_for_tp) carries kv_heads * rep
        kvh = kvw.shape[1] // (2 * d)
        kvw = kvw.reshape(hidden, kvh, 2, d)
        yield {
            "ln1_w": lp["input_norm"]["weight"].reshape(1, hidden),
            "wq": io(att["q_proj"]["weight"]),
            "wk": kvw[:, :, 0, :].reshape(hidden, kvh * d).contiguous(),
            "wv": kvw[:, :, 1, :].reshape(hidden, kvh * d).contiguous(),
            "wo": io(att["o_proj"]["weight"]),
            "ln2_w": lp["post_attention_norm"]["weight"].reshape(1, hidden),
            "wg": io(lp["mlp"]["gate_proj"]["weight"]),
            "wu": io(lp["mlp"]["up_proj"]["weight"]),
            "wd": io(lp["mlp"]["down_proj"]["weight"]),
        }


# --------------------------------------------------------------------------
# tensor-parallel shards
# --------------------------------------------------------------------------

#: parent module names whose ``weight`` is column-partitioned (``[out,
#: in]``, the out dim sharded: heads, ffn or vocab major, so whole heads
#: land on a rank) and whose ``bias`` shards with the out dim
_COL_PARENTS = frozenset({
    "query_key_value", "dense_h_to_4h",            # gpt
    "q_proj", "kv_proj", "gate_proj", "up_proj",   # llama
    "lm_head", "word_embeddings", "embed_tokens",  # vocab-sharded
})

#: parent module names whose ``weight`` is row-partitioned (the in dim
#: sharded); their bias stays whole, added once after the all_reduce
_ROW_PARENTS = frozenset({
    "dense", "dense_4h_to_h",                      # gpt
    "o_proj", "down_proj",                         # llama
})


def expand_kv_for_tp(kind: str, cfg, params, tp: int):
    """Replicate GQA/MQA kv heads below tp (``rep = tp / kv_heads >
    1``): each kv head's PACKED ``[k | v]`` rows of ``kv_proj`` (its
    ``2 * head_dim`` outputs side by side) repeat ``rep`` times head
    major, so the plain column shard of the expanded out dim hands every
    rank exactly the kv head its query group reads.  A new tree (the
    given one is not changed); the tree itself when ``rep == 1`` (tp =
    1, MHA, or GQA that tp divides)."""
    td = tp_dims(kind, cfg, tp)
    rep, kvh, d = td["rep"], td["kv_heads"], td["head_dim"]
    if rep == 1:
        return params
    sub = _params_subtree(params)
    fixed = dict(sub)
    for name, lp in sub.items():
        if not name.startswith("layer_"):
            continue
        kvp = dict(lp["attention"]["kv_proj"])
        w = kvp["weight"]                          # [kvh * 2d, hidden]
        kvp["weight"] = w.reshape(kvh, 2 * d, w.shape[1]).repeat_interleave(
            rep, dim=0).reshape(kvh * rep * 2 * d, w.shape[1])
        if "bias" in kvp:
            kvp["bias"] = kvp["bias"].reshape(kvh, 2 * d).repeat_interleave(
                rep, dim=0).reshape(-1)
        fixed[name] = dict(lp, attention=dict(lp["attention"], kv_proj=kvp))
    if sub is not params:
        return {**params, "params": fixed}
    return fixed


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_partition_specs(kind: str, cfg, params, tp: int):
    """The dim each leaf of the (kv-expanded) tree is sharded on, in the
    tree's shape: 0 for a column-partitioned weight (q/k/v, gate, up,
    the embedding and the LM head, over heads, ffn and vocab) and its
    bias, 1 for a row-partitioned weight (the out-projection, down),
    ``None`` for a leaf every rank holds whole (norms, the position
    table, a row bias).  The JAX package's ``PartitionSpec`` tree, dim
    for dim; every leaf is ``None`` at tp = 1.  Divisibility is checked
    leaf by leaf, naming the module."""
    def spec(path, leaf):
        if tp <= 1:
            return None
        name = path[-1] if path else ""
        parent = path[-2] if len(path) >= 2 else ""
        if parent in _COL_PARENTS:
            if leaf.shape[0] % tp:
                raise ValueError(
                    f"tp={tp} does not divide {parent}.{name} out dim "
                    f"{leaf.shape[0]}")
            return 0
        if parent in _ROW_PARENTS and name == "weight":
            if leaf.shape[1] % tp:
                raise ValueError(
                    f"tp={tp} does not divide {parent}.weight in dim "
                    f"{leaf.shape[1]}")
            return 1
        return None
    return _map_with_path(spec, params)


def fused_partition_specs(fused_layers, tp: int):
    """The shard dims of :func:`fused_layer_params`' ``[in, out]``
    layout, one dict a layer: the q/k/v, gate and up planes and their
    biases on the out dim (1), the out-projection and down on the in dim
    (0), the norms and the biases added after the all_reduce (``bo``,
    ``bd``) whole (``None``)."""
    col = {"wq", "bq", "wk", "bk", "wv", "bv", "wg", "wu", "bu"}
    row = {"wo", "wd"}

    def one(blk):
        return {k: (1 if k in col else 0 if k in row else None)
                if tp > 1 else None for k in blk}
    return [one(b) for b in fused_layers]


def shard_tree(tree, dims, tp: int, rank: int):
    """Rank ``rank``'s slice of ``tree`` under ``dims`` (the tree of
    :func:`param_partition_specs`, or one layer of
    :func:`fused_partition_specs`): each sharded leaf's ``rank``-th of
    ``tp`` equal pieces along its dim, as a contiguous copy that holds
    none of the whole leaf's storage (so the whole tree can be freed);
    a ``None`` leaf is the same tensor."""
    def one(t, dim):
        if dim is None:
            return t
        n = t.shape[dim]
        if n % tp:
            raise ValueError(f"tp={tp} does not divide dim {dim} of a "
                             f"{tuple(t.shape)} leaf")
        return t.narrow(dim, rank * (n // tp), n // tp).clone(
            memory_format=torch.contiguous_format)
    if isinstance(tree, dict):
        return {k: shard_tree(v, dims[k], tp, rank) for k, v in tree.items()}
    return one(tree, dims)


def _fused_block_tail_tp(kind: str, blk, x, part, eps, group):
    """Finish one fused layer outside the kernel at tp > 1: all-reduce
    the rank-partial out-projection (the kernel's ``partial_out``
    output) at the row boundary, add ``bo`` once, then norm2 and the
    column/row MLP with its own all_reduce: the two all_reduces a layer
    the unfused rank pays.  The fused layout's fp32 vectors are cast to
    the activations' type, the type the JAX layout keeps them in."""
    dist.all_reduce(part, group=group)
    cast = (lambda n: blk[n].reshape(-1).to(x.dtype))
    if kind == "gpt":
        x2 = x + part + cast("bo")
        h2 = layer_norm(x2, cast("ln2_w"), cast("ln2_b"))
        u = gelu(torch.matmul(h2, blk["wu"]) + cast("bu"))
        y = torch.matmul(u, blk["wd"])
        dist.all_reduce(y, group=group)
        y = y + cast("bd")
    else:
        x2 = x + part
        h2 = rms_norm(x2, blk["ln2_w"].reshape(-1), eps=eps)
        u = F.silu(torch.matmul(h2, blk["wg"])) * torch.matmul(h2, blk["wu"])
        y = torch.matmul(u, blk["wd"])
        dist.all_reduce(y, group=group)
    return x2 + y


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


def _gpt_mlp(lp, h, tp: int = 1, group=None):
    return _row_linear(lp["mlp"]["dense_4h_to_h"],
                       gelu(_linear(lp["mlp"]["dense_h_to_4h"], h)), tp, group)


def _ln(p, x):
    return layer_norm(x, p["weight"], p["bias"])


def _gpt_prefill(cfg, params, tokens, length=None, cache=None, row=None,
                 start=0, tp=1, group=None):
    p = _params_subtree(params)
    b, s = tokens.shape
    dims = model_dims("gpt", cfg)
    heads, head_dim = dims["heads"] // tp, dims["head_dim"]
    suffix = cache is not None
    emb_w = p["embedding"]["word_embeddings"]["weight"]
    pos_tab = p["embedding"]["position_embeddings"]
    h = _vocab_embed(emb_w, tokens, tp, group)              # [b, s, h]
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
        x = x + _row_linear(lp["self_attention"]["dense"], ctx, tp, group)
        h = x + _gpt_mlp(lp, _ln(lp["post_attention_layernorm"], x), tp,
                         group)

    h = _ln(p["final_layernorm"], h)
    if length is not None:
        last = length - start if suffix else length   # local slab index
        logits = torch.matmul(_last_row(h, last), emb_w.T)    # [b, v]
    else:
        logits = torch.einsum("sbh,vh->sbv", h, emb_w)      # tied head
    return (_gather_logits(logits, tp, group), torch.stack(ks),
            torch.stack(vs))


def _gpt_decode(cfg, params, cache, tokens, fused=None, tp=1, group=None):
    p = _params_subtree(params)
    dims = model_dims("gpt", cfg)
    heads, head_dim = dims["heads"] // tp, dims["head_dim"]
    positions = cache.lengths                               # [slots]
    emb_w = p["embedding"]["word_embeddings"]["weight"]
    pos_tab = p["embedding"]["position_embeddings"]
    # a slot at the end of the table (its length at capacity) reads the
    # last row: its token is never appended (advance flags it), where
    # the JAX take reads a row of NaN
    rows = torch.clamp(positions.long(), max=pos_tab.shape[0] - 1)
    h = _vocab_embed(emb_w, tokens, tp, group) + pos_tab[rows]  # [slots, h]

    live = positions + 1                # incl. the token written now
    targets = kv_cache.append_targets(cache)  # same rows every layer
    for i in range(cfg.num_layers):
        if fused is not None and tp > 1:
            # the rank's shard in one kernel launch: its partial
            # out-projection (no residual, no bias); the all_reduce,
            # bo, norm2 and the MLP finish outside
            part, k_tok, v_tok = fused_block_decode(
                h, fused[i], cache.k[:, i], cache.v[:, i], cache.page_table,
                positions, kind="gpt", eps=1e-5, fuse_mlp=False,
                partial_out=True)
            cache = kv_cache.append_layer(cache, i, k_tok, v_tok, targets)
            h = _fused_block_tail_tp("gpt", fused[i], h, part, 1e-5, group)
            continue
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
        x = x + _row_linear(lp["self_attention"]["dense"],
                            ctx.reshape(ctx.shape[0], -1), tp, group)
        h = x + _gpt_mlp(lp, _ln(lp["post_attention_layernorm"], x), tp,
                         group)

    h = _ln(p["final_layernorm"], h)
    return (_gather_logits(torch.matmul(h, emb_w.T), tp, group),
            cache)                                          # [slots, v]


def _gpt_verify(cfg, params, cache, tokens, tp=1, group=None):
    """Speculative verify: logits at every position of the ``[slots,
    S]`` slab, its k/v appended at ``[lengths, lengths + S)``.  Lengths
    do not advance here.  Positions past the table read its last row,
    as in JAX."""
    p = _params_subtree(params)
    dims = model_dims("gpt", cfg)
    heads, head_dim = dims["heads"] // tp, dims["head_dim"]
    slots, s = tokens.shape
    base = cache.lengths                                    # [slots]
    pos = base.long()[:, None] + torch.arange(s, device=tokens.device)
    emb_w = p["embedding"]["word_embeddings"]["weight"]
    pos_tab = p["embedding"]["position_embeddings"]
    h = _vocab_embed(emb_w, tokens, tp, group) + pos_tab[torch.clamp(
        pos, max=pos_tab.shape[0] - 1)]                     # [b, S, hid]

    for i in range(cfg.num_layers):
        lp = p[f"layer_{i}"]
        x = h
        h1 = _ln(lp["input_layernorm"], x)
        q, k, v = _gpt_attn_proj(lp, h1, heads, head_dim)   # [b, S, n, d]
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        cache = kv_cache.append_slab(cache, i, k, v)
        ctx = _slab_attend(cache, i, q, base)               # [b, h, S, d]
        ctx = ctx.transpose(1, 2).reshape(slots, s, -1)
        x = x + _row_linear(lp["self_attention"]["dense"], ctx, tp, group)
        h = x + _gpt_mlp(lp, _ln(lp["post_attention_layernorm"], x), tp,
                         group)

    h = _ln(p["final_layernorm"], h)
    return (_gather_logits(torch.matmul(h, emb_w.T), tp, group),
            cache)                                          # [b, S, v]


# --------------------------------------------------------------------------
# LLaMA (standalone_llama mirror; GQA/MQA cached once per kv head)
# --------------------------------------------------------------------------

def _llama_prefill(cfg, params, tokens, length=None, cache=None, row=None,
                   start=0, tp=1, group=None):
    p = _params_subtree(params)
    b, s = tokens.shape
    dims = tp_dims("llama", cfg, tp)
    heads, kv_heads = dims["heads_local"], dims["kv_heads_local"]
    head_dim = dims["head_dim"]
    qpk = heads // kv_heads             # query heads a kv head serves
    suffix = cache is not None
    dev = tokens.device

    h = _vocab_embed(p["embed_tokens"]["weight"], tokens, tp, group)
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
            if qpk > 1:                 # GQA: share kv across the group
                k, v = (t[:, :, :, None, :].expand(
                    s, b, kv_heads, qpk, head_dim
                ).reshape(s, b, heads, head_dim) for t in (k, v))
            q, k, v = (t.permute(1, 2, 0, 3) for t in (q, k, v))
            ctx = flash_attention(q, k, v, causal=True)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, -1)
        x = x + _row_linear(lp["attention"]["o_proj"], ctx, tp, group)
        h1 = rms_norm(x, lp["post_attention_norm"]["weight"],
                      eps=cfg.rms_eps)
        h = x + _llama_mlp(lp, h1, tp, group)

    h = rms_norm(h, p["final_norm"]["weight"], eps=cfg.rms_eps)
    if length is not None:
        last = length - start if suffix else length   # local slab index
        logits = _linear(p["lm_head"], _last_row(h, last))    # [b, v]
    else:
        logits = _linear(p["lm_head"], h)                     # [s, b, v]
    return (_gather_logits(logits, tp, group), torch.stack(ks),
            torch.stack(vs))


def _llama_decode_layer(lp, h, cache, i, cos, sin, live, targets, dims,
                        eps, tp=1, group=None):
    """One unfused decode layer: RMSNorm, q/kv, RoPE, the pool append,
    paged attention over ``live`` tokens, o-proj, RMSNorm, the MLP (on
    the rank's shard at ``tp > 1``: ``dims`` is :func:`tp_dims`')."""
    heads, kv_heads = dims["heads_local"], dims["kv_heads_local"]
    x = h
    h1 = rms_norm(x, lp["input_norm"]["weight"], eps=eps)
    q, k_tok, v_tok = _llama_proj(lp, h1, heads, kv_heads, dims["head_dim"])
    q = fused_apply_rotary_pos_emb_cached(q, cos, sin)
    k_tok = fused_apply_rotary_pos_emb_cached(k_tok, cos, sin)
    cache = kv_cache.append_layer(cache, i, k_tok, v_tok, targets)
    # grouped-query scoring straight off the per-kv-head cache or pool
    ctx = _cache_attend(cache, i, q, live)
    x = x + _row_linear(lp["attention"]["o_proj"],
                        ctx.reshape(ctx.shape[0], -1), tp, group)
    h1 = rms_norm(x, lp["post_attention_norm"]["weight"], eps=eps)
    return x + _llama_mlp(lp, h1, tp, group), cache


def _llama_decode(cfg, params, cache, tokens, fused=None, tp=1, group=None):
    p = _params_subtree(params)
    dims = tp_dims("llama", cfg, tp)
    head_dim = dims["head_dim"]
    # a slot at the end of its window computes garbage that is never
    # appended (advance flags it); clamp so the table read stays in range
    positions = torch.clamp(cache.lengths.long(), max=cache.max_seq - 1)
    dev = cache.device

    h = _vocab_embed(p["embed_tokens"]["weight"], tokens, tp,
                     group)                                 # [slots, h]
    cos_t, sin_t = _rope_cos_sin(cache.max_seq, head_dim, cfg.rope_theta,
                                 device=dev)
    cos2 = cos_t.reshape(cache.max_seq, head_dim)[positions]  # [slots, d]
    sin2 = sin_t.reshape(cache.max_seq, head_dim)[positions]
    cos, sin = cos2[:, None, :], sin2[:, None, :]           # [slots, 1, d]

    live = cache.lengths + 1            # incl. the token written now
    targets = kv_cache.append_targets(cache)  # same rows every layer
    for i in range(cfg.num_layers):
        if fused is not None and tp > 1:
            # the rank's shard in one launch: its partial out-projection;
            # the all_reduce, norm2 and the MLP finish outside
            part, k_tok, v_tok = fused_block_decode(
                h, fused[i], cache.k[:, i], cache.v[:, i], cache.page_table,
                cache.lengths, kind="llama", eps=cfg.rms_eps, cos=cos2,
                sin=sin2, fuse_mlp=False, partial_out=True)
            cache = kv_cache.append_layer(cache, i, k_tok, v_tok, targets)
            h = _fused_block_tail_tp("llama", fused[i], h, part, cfg.rms_eps,
                                     group)
            continue
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
                                       sin, live, targets, dims, cfg.rms_eps,
                                       tp, group)

    h = rms_norm(h, p["final_norm"]["weight"], eps=cfg.rms_eps)
    logits = _linear(p["lm_head"], h)                       # [slots, v]
    return _gather_logits(logits, tp, group), cache


def _llama_verify(cfg, params, cache, tokens, tp=1, group=None):
    """LLaMA twin of :func:`_gpt_verify`: RoPE at each slab row's
    position (clamped at ``max_seq - 1``, as in JAX), GQA slab scoring
    straight off the per-kv-head cache or pool."""
    p = _params_subtree(params)
    dims = tp_dims("llama", cfg, tp)
    heads, kv_heads = dims["heads_local"], dims["kv_heads_local"]
    head_dim = dims["head_dim"]
    slots, s = tokens.shape
    dev = tokens.device
    base = cache.lengths
    pos = torch.clamp(base.long()[:, None] + torch.arange(s, device=dev),
                      max=cache.max_seq - 1)                # [b, S]

    h = _vocab_embed(p["embed_tokens"]["weight"], tokens, tp,
                     group)                                 # [b, S, hid]
    cos_t, sin_t = _rope_cos_sin(cache.max_seq, head_dim, cfg.rope_theta,
                                 device=dev)
    cos = cos_t.reshape(cache.max_seq, head_dim)[pos][:, :, None, :]
    sin = sin_t.reshape(cache.max_seq, head_dim)[pos][:, :, None, :]

    for i in range(cfg.num_layers):
        lp = p[f"layer_{i}"]
        x = h
        h1 = rms_norm(x, lp["input_norm"]["weight"], eps=cfg.rms_eps)
        q, k, v = _llama_proj(lp, h1, heads, kv_heads, head_dim)
        q = fused_apply_rotary_pos_emb_cached(q, cos, sin)
        k = fused_apply_rotary_pos_emb_cached(k, cos, sin)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # [b, n, S, d]
        cache = kv_cache.append_slab(cache, i, k, v)
        ctx = _slab_attend(cache, i, q, base)               # [b, h, S, d]
        ctx = ctx.transpose(1, 2).reshape(slots, s, -1)
        x = x + _row_linear(lp["attention"]["o_proj"], ctx, tp, group)
        h1 = rms_norm(x, lp["post_attention_norm"]["weight"],
                      eps=cfg.rms_eps)
        h = x + _llama_mlp(lp, h1, tp, group)

    h = rms_norm(h, p["final_norm"]["weight"], eps=cfg.rms_eps)
    return (_gather_logits(_linear(p["lm_head"], h), tp, group),
            cache)                                          # [b, S, v]


def prefill_forward(kind: str, cfg, params, tokens, length=None, *,
                    cache=None, row=None, prefill_from=None, tp: int = 1,
                    group=None):
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
    live length; ``prefill_from == 0`` is the cold path.

    ``tp > 1``: ``params`` is this rank's shard (:func:`shard_tree`),
    ``cache`` its pool shard, ``group`` the serving group (module
    docstring); the logits are whole on every rank, k/v the rank's kv
    heads."""
    if tokens.dim() != 2 or tokens.shape[0] != 1:
        raise ValueError(
            f"prefill takes one prompt [1, s], got {tuple(tokens.shape)}")
    check_supported(kind, cfg)
    fn = _gpt_prefill if kind == "gpt" else _llama_prefill
    if cache is None:
        return fn(cfg, params, tokens, length, tp=tp, group=group)
    if row is None or prefill_from is None or length is None:
        raise ValueError(
            "suffix prefill needs cache, row, prefill_from AND length")
    return fn(cfg, params, tokens, int(length), cache=cache, row=row,
              start=int(prefill_from), tp=tp, group=group)


def decode_forward(kind: str, cfg, params, cache, tokens, fused=None,
                   tp: int = 1, group=None):
    """One-token step for every slot: ``tokens [slots]`` -> ``(logits
    [slots, v], cache)`` with the new k/v appended (in place) at each
    slot's position, on the dense slot cache or the paged pool.
    Lengths do not advance here.

    ``fused`` is the per-layer layout of :func:`fused_layer_params`:
    with it every decoder layer is one fused-block kernel launch
    instead of the per-op sequence — the same embedding, LM head and
    pool append, logits within tolerance of the unfused path (the
    kernel keeps the residual in fp32 inside a layer, where the per-op
    path rounds it at each sublayer).  At ``tp > 1`` (``params`` and
    ``fused`` the rank's shards) a fused layer is one launch of the
    block's rank-partial instance and the layer's end outside it."""
    check_supported(kind, cfg)
    fn = _gpt_decode if kind == "gpt" else _llama_decode
    return fn(cfg, params, cache, tokens, fused=fused, tp=tp, group=group)


def verify_forward(kind: str, cfg, params, cache, tokens, tp: int = 1,
                   group=None):
    """Speculative-verify step: ``tokens [slots, S]`` (each slot's last
    confirmed token followed by ``S - 1`` drafts) -> ``(logits [slots,
    S, v], cache)`` with the slab's k/v appended (in place) at positions
    ``[lengths, lengths + S)``.  Lengths do NOT advance: the verify step
    advances by the accepted count, which is the rollback (the rejected
    rows are dead by the mask; pages were reserved at admission)."""
    if tokens.dim() != 2:
        raise ValueError(
            f"verify takes a [slots, S] slab, got {tuple(tokens.shape)}")
    check_supported(kind, cfg)
    fn = _gpt_verify if kind == "gpt" else _llama_verify
    return fn(cfg, params, cache, tokens, tp=tp, group=group)
