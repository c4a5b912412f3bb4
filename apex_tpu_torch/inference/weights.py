"""Weights into the port: the JAX ``model.init`` tree as tensors.

:func:`params_from_jax` takes the nested-dict parameter tree the JAX
package's ``llama_model_provider(cfg).init`` returns (leaves as numpy
arrays, or any array numpy can read; with or without the outer
``"params"`` key) and returns the same tree with ``torch.Tensor``
leaves under the same key paths.  Layouts are unchanged: linear weights
stay ``[out, in]`` (the forwards compute ``x @ W.T``), the packed
``kv_proj`` keeps each kv head's k and v columns side by side.

:func:`load_jax_params` copies the same tree into the training model of
:mod:`apex_tpu_torch.transformer.testing.standalone_llama`, whose named
parameters are the tree's key paths joined by dots: one JAX tree serves
both the serving and the training path.
"""
from __future__ import annotations

import numpy as np
import torch

from apex_tpu_torch.inference.models import check_supported, model_dims
from apex_tpu_torch.utils import resolve_device

__all__ = ["params_from_jax", "llama_param_shapes", "load_jax_params"]


def _to_tensor(x, device, dtype):
    a = np.array(x)                    # a writable, contiguous copy
    if a.dtype.name == "bfloat16":     # ml_dtypes bfloat16: reinterpret
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


def params_from_jax(kind: str, cfg, tree, *, device=None, dtype=None):
    """The JAX param tree as tensors on ``device`` (CUDA unless
    ``"cpu"`` is asked for), optionally cast to ``dtype`` (floating
    leaves only).  Checks every LLaMA leaf's shape against ``cfg``."""
    check_supported(kind, cfg)
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _to_tensor(node, dev, dtype)

    out = convert(dict(tree))
    bare = out["params"] if isinstance(out.get("params"), dict) else out
    for path, shape in llama_param_shapes(cfg).items():
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
