"""Tensor-parallel RNG streams and activation checkpointing.

Port of ``apex_tpu/transformer/tensor_parallel/random.py`` (reference:
``apex/transformer/tensor_parallel/random.py``): named RNG streams, one
``torch.Generator`` a stream on the caller's device.  The
model-parallel stream (Megatron's ``seed + 2718``) has the tensor rank
folded into its seed, so dropout differs across tensor ranks; the
default stream is shared.  :func:`checkpoint` recomputes a function in
the backward through :func:`apex_tpu_torch.utils.remat`, which sets
every tracked generator back for the recompute: it draws the forward's
masks, and the generators end where a run without recompute leaves
them.  JAX's threefry bits cannot be reproduced; the streams' statistics
are the contract.
"""
from __future__ import annotations

import contextlib
import hashlib

import torch

from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.utils import remat, resolve_device

__all__ = [
    "RNGStatesTracker",
    "CudaRNGStatesTracker",  # parity alias
    "get_rng_tracker",
    "get_cuda_rng_tracker",  # parity alias
    "model_parallel_seed",
    "model_parallel_cuda_manual_seed",  # parity alias
    "checkpoint",
]

# Megatron's offsets: the tensor-parallel stream gets seed + 2718 with the
# tensor rank folded in, the default (data-parallel) stream gets seed.
_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"
_TP_SEED_OFFSET = 2718


def _tp_rank() -> int:
    if parallel_state.model_parallel_is_initialized():
        return parallel_state.get_tensor_model_parallel_rank()
    return 0


def _default_generator(device) -> torch.Generator:
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.init()
        return torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
    return torch.default_generator


def fold_generator(generator, *ranks, device=None) -> torch.Generator:
    """A stream of ``ranks``' own, the counterpart of JAX's
    ``fold_in(key, rank)``: a generator on ``device`` (``generator``'s
    where None) seeded from ``generator``'s current state with ``ranks``
    folded in.  ``generator`` is ``device``'s default one where None
    (CUDA's where both are); its state is read on the host, CUDA's too
    (no device sync), and it then advances by one draw on every rank
    alike (kept on its device, never read), so the next fold differs and
    draws after it stay equal across ranks."""
    if generator is None:
        generator = _default_generator(device)
    device = generator.device if device is None else torch.device(device)
    state = generator.get_state().numpy().tobytes()
    raw = state + b"".join(int(r).to_bytes(4, "little") for r in ranks)
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(hashlib.blake2b(raw, digest_size=8)
                                 .digest(), "little") & (2 ** 63 - 1))
    torch.empty(1, device=generator.device).uniform_(generator=generator)
    return g


class RNGStatesTracker:
    """Named RNG streams (reference: ``CudaRNGStatesTracker``).

    ``add(name, seed)`` registers a stream: a ``torch.Generator`` on
    ``device`` (CUDA unless ``"cpu"`` is asked for) seeded with ``seed``,
    or with the tensor rank folded in when ``per_tp_rank``.
    ``fork(name)`` yields the stream's generator: draws made with it
    (``generator=``) advance the stream."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.states_ = {}       # name -> torch.Generator
        self.seeds_ = set()

    def get_states(self):
        """``{name: generator state}`` (host byte tensors)."""
        return {k: g.get_state() for k, g in self.states_.items()}

    def set_states(self, states):
        for name, state in states.items():
            self.states_[name].set_state(state)

    def add(self, name: str, seed: int, *, per_tp_rank: bool = False,
            device=None):
        if seed in self.seeds_:
            raise RuntimeError(f"seed {seed} already exists")
        self.seeds_.add(seed)
        if name in self.states_:
            raise RuntimeError(f"rng state {name} already exists")
        g = torch.Generator(device=resolve_device(device))
        g.manual_seed(seed * 65537 + _tp_rank() if per_tp_rank else seed)
        self.states_[name] = g

    def generators(self):
        return list(self.states_.values())

    @contextlib.contextmanager
    def fork(self, name: str = _MODEL_PARALLEL_RNG_TRACKER_NAME):
        """Yield the named stream's generator."""
        if name not in self.states_:
            raise RuntimeError(f"rng state {name} is not added")
        yield self.states_[name]


# parity alias: Megatron-style code calls this name
CudaRNGStatesTracker = RNGStatesTracker

_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_tracker() -> RNGStatesTracker:
    return _RNG_STATE_TRACKER


get_cuda_rng_tracker = get_rng_tracker


def model_parallel_seed(seed: int, device=None) -> None:
    """Set up the default and the model-parallel streams (reference:
    ``model_parallel_cuda_manual_seed``): the default stream ``seed``,
    shared across tensor ranks; the model-parallel stream ``seed +
    2718`` with the tensor rank folded in."""
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add("default", seed, device=device)
    _RNG_STATE_TRACKER.add(_MODEL_PARALLEL_RNG_TRACKER_NAME,
                           seed + _TP_SEED_OFFSET, per_tp_rank=True,
                           device=device)


model_parallel_cuda_manual_seed = model_parallel_seed


def checkpoint(function, distribute_saved_activations: bool = False, *args):
    """Activation checkpointing (reference: ``CheckpointFunction.apply``):
    ``function(*args)`` recomputed in the backward with every tracked
    stream replayed (:func:`apex_tpu_torch.utils.remat`).
    ``distribute_saved_activations`` is accepted for parity; the saved
    input is not sharded over the tensor ranks."""
    return remat(function, *args,
                 generator=_RNG_STATE_TRACKER.generators() or None)
