"""Small shared helpers: integer arithmetic, the device rule, the
flat-buffer ravel of a parameter tree, and activation recompute.

Every entry point of the port runs on CUDA unless the caller asks for
the CPU: ``resolve_device(None)`` is the current CUDA device and raises
when CUDA is missing, so a machine without a card never falls back to
the plain PyTorch versions silently.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["cdiv", "round_up", "resolve_device", "tree_leaves_with_path",
           "tree_ravel", "ravel_layout", "remat"]


def cdiv(a: int, b: int) -> int:
    """Ceiling division of non-negative ints."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """``x`` rounded up to a multiple of ``m``."""
    return cdiv(x, m) * m


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA (and
    raises when CUDA is not available); ``"cpu"`` must be asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "apex_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"apex_tpu_torch runs on 'cuda' or 'cpu', got "
                         f"{dev}")
    return dev


def tree_leaves_with_path(tree) -> List[Tuple[tuple, torch.Tensor]]:
    """``(key path, tensor)`` of every leaf of ``tree`` in the order
    ``jax.tree_util.tree_leaves`` gives the matching pytree: dict keys
    sorted at every level, list and tuple items in index order (their
    path keys are the indices).  ``tree`` is an ``nn.Module`` (its named
    parameters, ``a.b.c`` read as the path ``(a, b, c)``), or nested
    dicts, lists and tuples of tensors."""
    if isinstance(tree, torch.nn.Module):
        leaves = [(tuple(name.split(".")), p)
                  for name, p in tree.named_parameters()]
        return sorted(leaves, key=lambda kv: kv[0])
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (key,))
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + (i,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def _skeleton(tree):
    """The containers of ``tree`` with ``None`` for its leaves (so an
    unravel function keeps no tensor of the tree alive); an
    ``nn.Module`` becomes the nested dict of its parameter paths."""
    if isinstance(tree, torch.nn.Module):
        out: dict = {}
        for path, _ in tree_leaves_with_path(tree):
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = None
        return out
    if isinstance(tree, dict):
        return {key: _skeleton(child) for key, child in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_skeleton(child) for child in tree)
    return None


def _rebuild(node, leaves):
    """``node``'s containers (dicts with sorted keys, lists, tuples) with
    its leaves replaced, in order, by ``next(leaves)``."""
    if isinstance(node, dict):
        return {key: _rebuild(node[key], leaves) for key in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(child, leaves) for child in node)
    return next(leaves)


def ravel_layout(tree) -> Tuple[int, torch.dtype, Callable]:
    """``(numel, dtype, unravel)`` of :func:`tree_ravel` without building
    the flat buffer: the element count, the buffer's dtype and the
    unravel function.  Reads only the leaves' shapes and dtypes."""
    leaves = tree_leaves_with_path(tree)
    dtype = leaves[0][1].dtype if leaves else torch.float32
    for _, t in leaves[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    spec = [(t.dtype, tuple(t.shape), t.numel()) for _, t in leaves]
    skeleton = _skeleton(tree)

    def unravel(buf: torch.Tensor):
        def pieces():
            off = 0
            for dt, shape, n in spec:
                yield buf[off:off + n].reshape(shape).to(dt, copy=True)
                off += n
        return _rebuild(skeleton, pieces())

    return sum(n for _, _, n in spec), dtype, unravel


def tree_ravel(tree) -> Tuple[torch.Tensor, Callable]:
    """Flatten a parameter tree into one 1-D buffer plus an unravel
    function — the counterpart of ``apex_tpu.utils.tree_ravel``
    (``jax.flatten_util.ravel_pytree``): leaves in
    :func:`tree_leaves_with_path` order, the buffer in the leaves'
    promoted dtype (fp32 when there are none), and ``unravel(flat)`` the
    tree's own containers (a nested dict for a module) holding new
    tensors, each cast back to its leaf's dtype and shape."""
    _, dtype, unravel = ravel_layout(tree)
    leaves = tree_leaves_with_path(tree)
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for _, t in leaves]) \
        if leaves else torch.zeros((0,), dtype=dtype)
    return flat, unravel


def remat(fn, *args, generator=None, **kwargs):
    """``fn(*args, **kwargs)`` with its activations recomputed in the
    backward instead of saved (flax's ``nn.remat``):
    ``torch.utils.checkpoint.checkpoint`` without reentrance.

    ``checkpoint`` replays only the default generators.  A layer that
    draws its dropout masks and attention seeds from an explicit
    ``generator`` (or a list of them) would draw others in the
    recompute, and advance the generator again.  So each generator's
    state before the call is kept, set back for the recompute, and the
    state the recompute found restored after it: the recompute draws
    what the forward drew and the generator ends where a run without
    recompute leaves it.  A generator's state lives on the host, CUDA's
    too: no device sync."""
    if generator is None:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    gens = list(generator) if isinstance(generator, (list, tuple)) \
        else [generator]
    before = [g.get_state() for g in gens]

    @contextlib.contextmanager
    def replay():
        after = [g.get_state() for g in gens]
        for g, state in zip(gens, before):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(gens, after):
                g.set_state(state)

    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), replay()),
                      **kwargs)
