"""Weights into the port: the JAX ``model.init`` tree as tensors.

:func:`params_from_jax` takes the nested-dict parameter tree the JAX
package's ``llama_model_provider(cfg).init``, ``gpt_model_provider``
or ``bert_model_provider`` returns (leaves as numpy arrays, or any
array numpy can read; with or without the outer ``"params"`` key) and
returns the same tree with ``torch.Tensor`` leaves under the same key
paths, every leaf's shape checked against the config
(:func:`llama_param_shapes`, :func:`gpt_param_shapes`,
:func:`bert_param_shapes`).  Layouts are unchanged: linear weights stay
``[out, in]`` (the forwards compute ``x @ W.T``), LLaMA's packed
``kv_proj`` keeps each kv head's k and v columns side by side, GPT's
``query_key_value`` its per-head ``[q, k, v]`` interleave, BERT's
flax ``Dense`` layers their ``kernel [in, out]``.

:func:`load_jax_params` copies the same tree into the port's standalone
models (``LlamaModel``, ``GPTModel``, ``BertModel``), whose named
parameters are the tree's key paths joined by dots: one JAX tree serves
both the serving and the training path.

:func:`shard_llama_params` gives tensor rank ``rank`` of ``tp`` its
shard of a tp = 1 LLaMA tree, in the JAX layouts: the column-parallel
weights (``q_proj``, ``gate_proj``, ``up_proj``, ``lm_head``,
``embed_tokens``) by rows, the row-parallel ones (``o_proj``,
``down_proj``) by columns, ``kv_proj`` by rows in whole kv heads (each
kv head's k and v side by side) when tp divides ``kv_heads``, else
whole (replicated), the norms whole.

:func:`to_scan_layout` and :func:`to_loop_layout` move a GPT tree
between the loop layout (``layer_<i>/...``) and ``scan_layers``'s
(``layers/layer/...``, each leaf stacked along a leading ``[num_layers]``
dim), so one set of weights serves both; an MoE GPT's ``mlp/router``
and ``mlp/experts`` leaves go along.

:func:`shard_moe_params` gives expert rank ``rank`` of ``ep`` its shard
of an ep = 1 MoE GPT tree: each ``experts`` leaf's ``num_moe_experts /
ep`` experts from ``rank * E / ep`` on (dim 0, or dim 1 of a stacked
``scan_layers`` leaf), the router and every dense leaf whole.
"""
from __future__ import annotations

import numpy as np
import torch

from apex_tpu_torch.inference.models import model_dims
from apex_tpu_torch.utils import resolve_device

__all__ = ["params_from_jax", "llama_param_shapes", "gpt_param_shapes",
           "bert_param_shapes", "load_jax_params", "shard_llama_params",
           "shard_moe_params", "to_scan_layout", "to_loop_layout"]


def _to_tensor(x, device, dtype):
    if isinstance(x, torch.Tensor):    # a tensor leaf, on any device
        t = x.detach().clone(memory_format=torch.contiguous_format)
    else:
        a = np.array(x)                # a writable, contiguous copy
        if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def llama_param_shapes(cfg) -> dict:
    """``{key path: shape}`` of a LLaMA tree at tp = 1 (the bare tree,
    no ``"params"`` key)."""
    d = model_dims("llama", cfg)
    hid, hd = cfg.hidden_size, d["head_dim"]
    shapes = {("embed_tokens", "weight"): (cfg.vocab_size, hid),
              ("final_norm", "weight"): (hid,),
              ("lm_head", "weight"): (cfg.vocab_size, hid)}
    for i in range(cfg.num_layers):
        lay = f"layer_{i}"
        shapes.update({
            (lay, "input_norm", "weight"): (hid,),
            (lay, "post_attention_norm", "weight"): (hid,),
            (lay, "attention", "q_proj", "weight"): (d["heads"] * hd, hid),
            (lay, "attention", "kv_proj", "weight"):
                (2 * d["kv_heads"] * hd, hid),
            (lay, "attention", "o_proj", "weight"): (hid, d["heads"] * hd),
            (lay, "mlp", "gate_proj", "weight"): (cfg.ffn, hid),
            (lay, "mlp", "up_proj", "weight"): (cfg.ffn, hid),
            (lay, "mlp", "down_proj", "weight"): (hid, cfg.ffn),
        })
    return shapes


def _gpt_layers(cfg, shapes: dict) -> dict:
    """``shapes`` plus the GPT layers' leaves: ``layer_<i>/...``, or
    with ``cfg.scan_layers`` ``layers/layer/...`` stacked ``[num_layers,
    ...]``."""
    per = _gpt_layer_shapes(cfg)
    if getattr(cfg, "scan_layers", False):
        for path, shape in per.items():
            shapes[("layers", "layer", *path)] = (cfg.num_layers, *shape)
    else:
        for i in range(cfg.num_layers):
            for path, shape in per.items():
                shapes[(f"layer_{i}", *path)] = shape
    return shapes


def _gpt_layer_shapes(cfg) -> dict:
    """``{path within a layer: shape}`` of the transformer layer GPT and
    BERT share (an MoE GPT's ``mlp`` the router and all its experts, at
    ep = 1)."""
    hid, ffn = cfg.hidden_size, cfg.ffn_hidden_size or 4 * cfg.hidden_size
    shapes = {}
    for norm in ("input_layernorm", "post_attention_layernorm"):
        shapes[(norm, "weight")] = (hid,)
        shapes[(norm, "bias")] = (hid,)
    mods = [(("self_attention", "query_key_value"), (3 * hid, hid)),
            (("self_attention", "dense"), (hid, hid))]
    e = getattr(cfg, "num_moe_experts", None)
    if e:
        shapes.update({("mlp", "router", "weight"): (e, hid),
                       ("mlp", "experts", "w1"): (e, hid, ffn),
                       ("mlp", "experts", "b1"): (e, 1, ffn),
                       ("mlp", "experts", "w2"): (e, ffn, hid),
                       ("mlp", "experts", "b2"): (e, 1, hid)})
    else:
        mods += [(("mlp", "dense_h_to_4h"), (ffn, hid)),
                 (("mlp", "dense_4h_to_h"), (hid, ffn))]
    for mod, (n_out, n_in) in mods:
        shapes[(*mod, "weight")] = (n_out, n_in)
        shapes[(*mod, "bias")] = (n_out,)
    return shapes


def _stack(leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.stack([np.asarray(x) for x in leaves])


def _map_layer(node, fn):
    """``node`` (a layer's subtree) with ``fn`` applied to each leaf."""
    if isinstance(node, dict):
        return {k: _map_layer(v, fn) for k, v in node.items()}
    return fn(node)


def _zip_layers(trees):
    """The layers' subtrees ``trees`` (one key structure) as one subtree
    of stacked leaves."""
    if isinstance(trees[0], dict):
        return {k: _zip_layers([t[k] for t in trees]) for k in trees[0]}
    return _stack(trees)


def to_scan_layout(tree, num_layers: int):
    """A GPT tree (with or without the outer ``"params"`` key; numpy or
    tensor leaves) with its ``layer_0 .. layer_<num_layers - 1>``
    subtrees replaced by ``layers/layer/...``, each leaf the layers'
    leaves stacked along a new leading dim: the ``scan_layers`` layout.
    The other leaves are shared, not copied."""
    if isinstance(tree.get("params"), dict):
        return {**tree, "params": to_scan_layout(tree["params"], num_layers)}
    names = [f"layer_{i}" for i in range(num_layers)]
    if any(n not in tree for n in names) or f"layer_{num_layers}" in tree:
        raise ValueError(f"the tree's layers are not layer_0 .. "
                         f"layer_{num_layers - 1}")
    out = {k: v for k, v in tree.items() if k not in names}
    out["layers"] = {"layer": _zip_layers([tree[n] for n in names])}
    return out


def to_loop_layout(tree):
    """The inverse of :func:`to_scan_layout`: ``layers/layer/...``
    leaves ``[num_layers, ...]`` back into ``layer_<i>/...`` subtrees
    (slices of the stacked leaves)."""
    if isinstance(tree.get("params"), dict):
        return {**tree, "params": to_loop_layout(tree["params"])}
    body = tree["layers"]["layer"]
    first = body
    while isinstance(first, dict):
        first = next(iter(first.values()))
    out = {k: v for k, v in tree.items() if k != "layers"}
    for i in range(first.shape[0]):
        out[f"layer_{i}"] = _map_layer(body, lambda x, i=i: x[i])
    return out


def gpt_param_shapes(cfg) -> dict:
    """``{key path: shape}`` of a GPT tree at tp = 1 (the bare tree)."""
    hid = cfg.hidden_size
    return _gpt_layers(cfg, {
        ("embedding", "word_embeddings", "weight"): (cfg.vocab_size, hid),
        ("embedding", "position_embeddings"): (cfg.max_seq_length, hid),
        ("final_layernorm", "weight"): (hid,),
        ("final_layernorm", "bias"): (hid,)})


def bert_param_shapes(cfg, binary_head: bool = False) -> dict:
    """``{key path: shape}`` of a BERT tree at tp = 1 (the bare tree),
    with the token-type table and, with ``binary_head``, the pooler and
    the NSP head."""
    hid = cfg.hidden_size
    shapes = {("word_embeddings", "weight"): (cfg.vocab_size, hid),
              ("position_embeddings",): (cfg.max_seq_length, hid),
              ("tokentype_embeddings", "embedding"):
                  (cfg.num_token_types, hid),
              ("lm_head_dense", "kernel"): (hid, hid),
              ("lm_head_dense", "bias"): (hid,)}
    for norm in ("final_layernorm", "lm_head_layernorm"):
        shapes[(norm, "weight")] = (hid,)
        shapes[(norm, "bias")] = (hid,)
    if binary_head:
        shapes.update({("pooler", "kernel"): (hid, hid),
                       ("pooler", "bias"): (hid,),
                       ("binary_head", "kernel"): (hid, 2),
                       ("binary_head", "bias"): (2,)})
    return _gpt_layers(cfg, shapes)


def params_from_jax(kind: str, cfg, tree, *, device=None, dtype=None):
    """The JAX param tree as tensors on ``device`` (CUDA unless
    ``"cpu"`` is asked for), optionally cast to ``dtype`` (floating
    leaves only).  Checks every leaf's shape against ``cfg`` (for BERT
    the pooler and NSP head too, where the tree has them)."""
    if kind not in ("gpt", "llama", "bert"):
        raise ValueError(f"unknown model kind {kind!r}")
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _to_tensor(node, dev, dtype)

    out = convert(dict(tree))
    bare = out["params"] if isinstance(out.get("params"), dict) else out
    if kind == "llama":
        shapes = llama_param_shapes(cfg)
    elif kind == "gpt":
        shapes = gpt_param_shapes(cfg)
    else:
        shapes = bert_param_shapes(cfg, binary_head="pooler" in bare)
    for path, shape in shapes.items():
        node = bare
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise ValueError(f"param tree lacks {'/'.join(path)}")
            node = node[key]
        if tuple(node.shape) != shape:
            raise ValueError(f"{'/'.join(path)} has shape "
                             f"{tuple(node.shape)}, expected {shape}")
    return out


def load_jax_params(model, tree) -> None:
    """Copy a JAX parameter tree (numpy leaves, with or without the
    outer ``"params"`` key) into ``model``'s parameters in place, each
    cast to the parameter's dtype.  Every parameter must be found in the
    tree at its dotted name's key path, with its shape, and every tree
    leaf must be a parameter."""
    bare = tree["params"] if isinstance(tree.get("params"), dict) else tree
    leaves = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            leaves[path] = node

    walk(bare, ())
    named = dict(model.named_parameters())
    want = {tuple(name.split(".")) for name in named}
    if want != set(leaves):
        missing = sorted("/".join(p) for p in want - set(leaves))
        extra = sorted("/".join(p) for p in set(leaves) - want)
        raise ValueError(f"tree and model disagree: missing {missing}, "
                         f"unexpected {extra}")
    with torch.no_grad():
        for name, p in named.items():
            t = _to_tensor(leaves[tuple(name.split("."))], p.device, None)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name} has shape {tuple(t.shape)} in the "
                                 f"tree, {tuple(p.shape)} in the model")
            p.copy_(t)


def shard_moe_params(tree, ep: int, rank: int):
    """Expert rank ``rank``'s shard of an ep = 1 MoE GPT tree (numpy
    arrays or tensors, with or without the outer ``"params"`` key; loop
    or scan layout) under the same key paths: each leaf under an
    ``experts`` key keeps experts ``rank * E / ep`` to ``(rank + 1) * E /
    ep`` (a contiguous copy), every other leaf (the router's too) is
    shared whole.  Raises ``ValueError`` where ep does not divide E."""
    if isinstance(tree.get("params"), dict):
        return {**tree, "params": shard_moe_params(tree["params"], ep, rank)}

    def one(path, leaf):
        if ep == 1 or "experts" not in path:
            return leaf
        dim = 1 if path[:2] == ("layers", "layer") else 0
        n = leaf.shape[dim]
        if n % ep:
            raise ValueError(f"ep={ep} does not divide the {n} experts of "
                             f"{'/'.join(path)} {tuple(leaf.shape)}")
        lo, m = rank * (n // ep), n // ep
        if isinstance(leaf, torch.Tensor):
            return leaf.narrow(dim, lo, m).clone(
                memory_format=torch.contiguous_format)
        idx = [slice(None)] * leaf.ndim
        idx[dim] = slice(lo, lo + m)
        return np.ascontiguousarray(np.asarray(leaf)[tuple(idx)])

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return one(path, node)

    return walk(tree, ())


_LLAMA_ROWS = ("q_proj", "gate_proj", "up_proj", "lm_head", "embed_tokens")
_LLAMA_COLS = ("o_proj", "down_proj")


def shard_llama_params(tree, cfg, tp: int, rank: int):
    """Rank ``rank``'s shard of a tp = 1 LLaMA tree (numpy arrays or
    tensors, with or without the outer ``"params"`` key) under the same
    key paths (the port's parameter names), each sharded leaf a
    contiguous copy of its slice (module docstring for the layouts).
    Raises ``ValueError`` where tp does not divide a sharded dim."""
    bare = tree["params"] if isinstance(tree.get("params"), dict) else tree
    kv_dim = 0 if cfg.kv_heads % tp == 0 else None

    def dim_of(path):
        names = set(path[:-1])
        if names & set(_LLAMA_ROWS):
            return 0
        if names & set(_LLAMA_COLS):
            return 1
        if "kv_proj" in names:
            return kv_dim
        return None

    def one(path, leaf):
        dim = dim_of(path) if tp > 1 else None
        if dim is None:
            return leaf
        n = leaf.shape[dim]
        if n % tp:
            raise ValueError(f"tp={tp} does not divide dim {dim} of "
                             f"{'/'.join(path)} {tuple(leaf.shape)}")
        lo, hi = rank * (n // tp), (rank + 1) * (n // tp)
        if isinstance(leaf, torch.Tensor):
            return leaf.narrow(dim, lo, hi - lo).clone(
                memory_format=torch.contiguous_format)
        idx = [slice(None)] * leaf.ndim
        idx[dim] = slice(lo, hi)
        return np.ascontiguousarray(np.asarray(leaf)[tuple(idx)])

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return one(path, node)

    return walk(bare, ())
