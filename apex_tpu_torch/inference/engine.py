"""Prefill/decode inference engine over the dense slot cache or the
paged KV pool, in PyTorch.

Port of ``apex_tpu/inference/engine.py`` at tp = 1: GPT and LLaMA
served through :meth:`InferenceEngine.generate` and the copied
:class:`~apex_tpu_torch.inference.scheduler.SlotScheduler`, and BERT's
encode-only path (:meth:`InferenceEngine.encode`).

* **Cache layouts.**  As in JAX, the dense slot cache
  (:class:`~apex_tpu_torch.inference.kv_cache.KVCache`, ``max_seq``
  rows for every slot) is the default; any paged kwarg
  (``paged=True``, ``page_size=``, ``num_pages=``) selects the paged
  pool instead.
* **Prefill** — one prompt (or, paged, its uncached tail) padded to a
  power-of-two bucket, one causal forward through the flash kernel (or
  the prefix-window attention on a warm start), its k/v parked in the
  slot's rows (dense) or scattered into its pages (paged), the first
  token sampled from the last real row.
* **Decode** — one token for every slot: per layer the norm, q/k/v (and
  RoPE for LLaMA), the cache append, attention over the slot's live
  length (dense: ``decode_attention``, the plain grouped chain up to
  4096 cached positions and the masked flash kernel beyond; paged: the
  paged decode kernel), the MLP; then the LM head, sampling and the
  length advance.  Under fused-block decode (paged only;
  ``decode_fusion="1"``, or ``"auto"`` with a window of at least
  ``fusion_min_pages`` pages) each layer is one launch of the
  fused-block kernel followed by the pool append.
* **Verify** (``spec_k > 0``; ``APEX_TPU_SPEC_K``) — speculative
  decoding, greedy only: one batched forward scores each slot's slab of
  its last token and ``spec_k`` drafts (``models.verify_forward``: the
  slab's k/v appended, then per layer the paged decode kernel over the
  folded slab, or the dense cache's plain slab chain), accepts the
  longest draft prefix that matches the target's own greedy tokens and
  advances the lengths by the accepted count plus one
  (``kv_cache.advance_by``): rejection is a length rollback.  The
  scheduler drives it with a drafter
  (:mod:`~apex_tpu_torch.inference.speculative`).
* **Encode** (BERT) — one bidirectional forward of the port's
  ``BertModel`` over the engine's parameter tree: ``(lm_logits [s, b,
  vocab], None)``.

The step bodies are the pure step factories, as in JAX:
:func:`make_prefill_fn`, :func:`make_decode_fn` and
:func:`make_verify_fn` build ``(cache, params, ..., key, step) ->
(cache, ...)`` functions, and :meth:`InferenceEngine.prefill`,
:meth:`~InferenceEngine.decode` and :meth:`~InferenceEngine.verify`
run them.  PyTorch runs eagerly, so where the JAX engine compiles each
into one donated executable, this engine runs the same ops in order
and updates the cache in place.  Sampled tokens, ``n_emit`` and the
``truncated`` flags come back as CPU tensors: the scheduler reads them
between steps, which is the continuous-batching control loop's one
host read per step.

A trained model enters through :meth:`InferenceEngine.from_train_state`
or :meth:`InferenceEngine.from_state_dict`.

* **Tensor-parallel serving** (``tp=N`` or ``APEX_TPU_SERVE_TP``; paged
  GPT and LLaMA) runs one process a rank, as PyTorch serves: every rank
  calls ``torch.distributed.init_process_group`` (and, on CUDA,
  ``torch.cuda.set_device``), then builds ``InferenceEngine(kind, cfg,
  params, tp=N)`` from the same full weights and calls the same entry
  points.  The engine keeps the rank's shard (the column/row slices of
  :func:`~apex_tpu_torch.inference.models.param_partition_specs`, GQA/MQA
  kv heads replicated below tp, the fused layout's slices) and a pool of
  ``kv_heads_pool / tp`` heads a page, and runs the JAX ``shard_map``
  body with ``torch.distributed`` collectives on ``group`` (default: the
  world group; its size must be ``tp``, and without an initialised
  ``torch.distributed`` the engine raises ``RuntimeError``: it never
  serves one rank's shard alone).  The caller picks the backend: NCCL
  takes one card a rank; gloo also serves ranks that share a card.  The
  scheduler runs on every rank unchanged: it reads no clock or random
  source, and every rank samples the same token from the same gathered
  logits, so all ranks admit, page and copy alike.

* **The host page tier** (``host_tier_bytes=`` or
  ``APEX_TPU_HOST_KV_TIER_BYTES``; paged only): the scheduler's prefix
  cache offloads evicted full prefix pages to host memory
  (:meth:`InferenceEngine.swap_out_pages`, deferred) and uploads them
  on a later hit (:meth:`InferenceEngine.swap_in_pages`) before the
  suffix's first prefill chunk, in batches of ``swap_batch_pages``
  (``APEX_TPU_SWAP_BATCH_PAGES``).  The host slabs are numpy arrays, a
  bf16 pool's as ``uint16`` bits (numpy has no bfloat16 of its own), so
  the copied :class:`~apex_tpu_torch.inference.kv_cache.HostPageStore`
  and scheduler keep them unchanged.

Where the JAX package raises ``ValueError`` (BERT with a paged, fused or
speculative kwarg or ``tp > 1``; the dense cache with ``tp > 1`` or
``host_tier_bytes``; a ``tp`` that splits a head), so does this engine.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import observability as obs
from apex_tpu_torch.inference import kv_cache, models
from apex_tpu_torch.inference.sampling import (SamplingConfig, greedy,
                                               sample_token)
from apex_tpu_torch.inference.speculative import default_spec_k
from apex_tpu_torch.ops.paged_attention import (
    check_kernel_page_size, decode_fusion as resolve_fusion_mode,
    resolve_decode_fusion)
from apex_tpu_torch.transformer.parallel_state import serving_group
from apex_tpu_torch.utils import resolve_device, tree_leaves_with_path

__all__ = ["InferenceEngine", "make_prefill_fn", "make_decode_fn",
           "make_verify_fn", "prefill_bucket", "serve_tp",
           "host_kv_tier_bytes"]

_HOST_TIER_ENV = "APEX_TPU_HOST_KV_TIER_BYTES"


def _env_int(name: str) -> int:
    raw = os.environ.get(name, "0").strip() or "0"
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}")


def serve_tp() -> int:
    """Effective serving tensor-parallel width from ``APEX_TPU_SERVE_TP``:
    unset or ``0`` means one rank; an explicit ``InferenceEngine(tp=)``
    always wins."""
    v = _env_int("APEX_TPU_SERVE_TP")
    if v < 0:
        raise ValueError(f"APEX_TPU_SERVE_TP must be >= 0, got {v}")
    return v or 1


def host_kv_tier_bytes() -> int:
    """Host-memory KV page tier byte budget from
    ``APEX_TPU_HOST_KV_TIER_BYTES``: unset or ``0`` disables the tier
    (LRU eviction discards); an explicit
    ``InferenceEngine(host_tier_bytes=)`` always wins."""
    v = _env_int(_HOST_TIER_ENV)
    if v < 0:
        raise ValueError(f"{_HOST_TIER_ENV} must be >= 0, got {v}")
    return v


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy array over the same memory; bf16 as its
    ``uint16`` bits, since numpy has no bfloat16 without ``ml_dtypes``."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _host_tensor(a, dtype) -> torch.Tensor:
    """A host slab as a CPU tensor of ``dtype``: ``uint16`` is read as
    bf16 bits, then cast like any floating slab, as JAX's ``astype``
    casts."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            dtype)
    return torch.from_numpy(a).to(dtype)


def _tp_group(tp, group):
    """The step factories' and the engine's ``tp`` and ``group``: no
    group at tp = 1; at tp > 1 ``group`` (default: the world group),
    checked by :func:`~apex_tpu_torch.transformer.parallel_state.
    serving_group` (``RuntimeError`` without ``torch.distributed`` or
    for a group of another size)."""
    if int(tp) < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if int(tp) == 1:
        return None
    return serving_group(int(tp), dist.group.WORLD if group is None
                         else group)


def make_prefill_fn(kind: str, cfg, sampling: SamplingConfig,
                    paged: bool = False, tp: int = 1, group=None):
    """Pure prefill step, JAX's signature.  Dense: ``(cache, params,
    tokens [s], slot, length, key, step) -> (cache, next_token,
    last_logits)``; paged takes the slot's page-table ``row`` and
    ``prefill_from`` after ``length``.

    ``tokens`` is the bucket-padded prompt (paged: its uncached tail) as
    an int32 tensor on the cache's device; ``length`` the slot's total
    live length after the step; ``slot``, ``length`` and
    ``prefill_from`` are host ints and ``row`` host ints
    (:func:`~apex_tpu_torch.inference.kv_cache.page_row`).  ``key`` is
    the ``torch.Generator`` sampling draws from; ``step`` keeps JAX's
    signature and is not read (the generator carries its own state).
    The cache is updated in place and returned; ``next_token`` is an
    int32 scalar and ``last_logits`` the fp32 ``[vocab]`` row, both on
    the device.  At ``tp > 1`` the step is one rank's (``params`` and
    ``cache`` its shards, ``group`` the serving group, default the world
    group); ``next_token`` and ``last_logits`` are the same on every
    rank."""
    group = _tp_group(tp, group)

    def sample(logits, key):
        last = logits[0].float()                            # [vocab]
        return sample_token(last, key, sampling), last

    @torch.no_grad()
    def prefill_fn(cache, params, tokens, slot, length, key, step):
        logits, ks, vs = models.prefill_forward(kind, cfg, params,
                                                tokens[None], length, tp=tp,
                                                group=group)
        cache = kv_cache.insert(cache, int(slot), ks, vs, length)
        return (cache,) + sample(logits, key)

    @torch.no_grad()
    def prefill_paged_fn(cache, params, tokens, slot, length, row,
                         prefill_from, key, step):
        logits, ks, vs = models.prefill_forward(
            kind, cfg, params, tokens[None], length, cache=cache, row=row,
            prefill_from=prefill_from, tp=tp, group=group)
        cache = kv_cache.insert_tokens(cache, int(slot), ks, vs, length,
                                       row, prefill_from)
        return (cache,) + sample(logits, key)

    return prefill_paged_fn if paged else prefill_fn


def make_decode_fn(kind: str, cfg, sampling: SamplingConfig,
                   fused: bool = False, tp: int = 1, group=None):
    """Pure decode step, JAX's signature: ``(cache, params, tokens
    [slots], active [slots], key, step) -> (cache, next_tokens, logits,
    truncated)``, all on the device.  Every slot computes; only active
    slots advance, and ``truncated`` flags active slots already at
    capacity, whose token was not appended (the caller retires them).
    ``fused``: ``params`` is the pair ``(tree, fused_layers)`` and every
    layer runs as one fused-block launch (at ``tp > 1`` the block's
    rank-partial instance).  ``key``, ``step``, ``tp`` and ``group`` as
    in :func:`make_prefill_fn`."""
    group = _tp_group(tp, group)

    @torch.no_grad()
    def decode_fn(cache, params, tokens, active, key, step):
        tree, fused_layers = params if fused else (params, None)
        logits, cache = models.decode_forward(kind, cfg, tree, cache, tokens,
                                              fused=fused_layers, tp=tp,
                                              group=group)
        logits = logits.float()
        toks = sample_token(logits, key, sampling)
        cache, truncated = kv_cache.advance(cache, active)
        return cache, toks, logits, truncated

    return decode_fn


def make_verify_fn(kind: str, cfg, sampling: SamplingConfig, k: int,
                   tp: int = 1, group=None):
    """Pure speculative-verify step, JAX's signature: ``(cache, params,
    slab [slots, k+1], active [slots], key, step) -> (cache, tokens
    [slots, k+1], n_emit [slots], truncated)``, all on the device.

    ``slab`` column 0 is each slot's last confirmed token, columns
    ``1..k`` the drafts.  One batched forward scores every slab position
    (:func:`~apex_tpu_torch.inference.models.verify_forward`); the
    longest draft prefix matching the target's own greedy tokens is
    accepted and ``tokens[:, :n_emit]`` is the emitted stream, the
    accepted drafts and the target's next token: always the target's
    greedy stream, ``n_emit`` in ``[1, k+1]``.  Lengths advance by
    ``n_emit`` (:func:`~apex_tpu_torch.inference.kv_cache.advance_by`),
    so the rejected rows are dead by the mask.  Greedy only, as in JAX:
    rejection sampling would need the drafts' distribution.  ``tp`` and
    ``group`` as in :func:`make_prefill_fn`."""
    if k < 1:
        raise ValueError(f"speculative verify needs k >= 1, got {k}")
    if not sampling.is_greedy:
        raise ValueError(
            "speculative verify is greedy-only (acceptance compares "
            "drafts against argmax; rejection sampling for "
            "temperature > 0 needs draft probabilities the drafter "
            "protocol does not carry)")
    group = _tp_group(tp, group)

    @torch.no_grad()
    def verify_fn(cache, params, slab, active, key, step):
        logits, cache = models.verify_forward(kind, cfg, params, cache, slab,
                                              tp=tp, group=group)
        toks = greedy(logits.float())                      # [slots, k+1]
        match = (toks[:, :-1] == slab[:, 1:]).to(torch.int32)
        # the leading-match count: cumprod zeroes all after a mismatch
        n_emit = (torch.cumprod(match, dim=1).sum(dim=1) + 1).to(
            torch.int32)
        cache, truncated = kv_cache.advance_by(cache, active, n_emit)
        return cache, toks, n_emit, truncated

    return verify_fn


def prefill_bucket(n: int, max_seq: int, min_bucket: int = 64) -> int:
    """Smallest power-of-two bucket >= n (clamped to max_seq): prompts
    pad up to it, as in the JAX engine (whose executable count this
    bounds; here it keeps the kernels' shapes and the padding badput
    accounting identical)."""
    if n < 1 or n > max_seq:
        raise ValueError(f"prompt length {n} outside [1, {max_seq}]")
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, max_seq)


class PendingSwapOut:
    """An in-flight device→host page copy (a deferred
    :meth:`InferenceEngine.swap_out_pages`): the copies are queued,
    ``resolve()`` waits for them (once; idempotent) and returns the
    ``(k, v)`` numpy slabs ``[n, layers, kv_heads, page_size,
    head_dim]``, a bf16 pool's as ``uint16`` bits.

    Where JAX's deferred gather writes a fresh device buffer, the port's
    cache is written in place, so ordering keeps the copy safe: the
    gathers and the copies into this object's pinned host buffers were
    queued on the current stream when the swap-out was called, so any
    cache write queued after it (a prefill into a freed page that was
    acquired again) runs after the read.  The event recorded behind the
    copies is what ``resolve()`` waits on.  The host buffers belong to
    this object alone: the returned arrays are views of them."""
    __slots__ = ("_host", "_event", "_resolved")

    def __init__(self, k_host: torch.Tensor, v_host: torch.Tensor,
                 event=None):
        self._host = (k_host, v_host)
        self._event = event            # a torch.cuda.Event, or None (CPU)
        self._resolved = None

    @property
    def done(self) -> bool:
        """True once :meth:`resolve` has run (the wave-boundary drain or
        a racing hit already waited for the copies)."""
        return self._resolved is not None

    def resolve(self):
        if self._resolved is None:
            if self._event is not None:
                self._event.synchronize()
            self._resolved = tuple(_host_numpy(t) for t in self._host)
            self._host = self._event = None
        return self._resolved


class InferenceEngine:
    """Serving engine over a GPT/LLaMA/BERT param tree.

    ``slots`` concurrent sequences with a ``max_seq``-token window each,
    on the dense slot cache (the default) or, with a paged kwarg, on a
    pool of ``num_pages`` pages of ``page_size`` tokens (default: the
    dense-equivalent ``slots * max_seq / page_size``).  ``params`` is
    the tree of tensors :func:`~apex_tpu_torch.inference.weights.
    params_from_jax` returns (or any tree with its key paths); it is
    cast to ``dtype`` when given and moved to the engine's device.
    ``device=None`` is CUDA and raises without a card; ``device="cpu"``
    runs the kernels' plain versions.  ``paged_attn_max_pages`` (a
    paged engine's; None on the dense cache) goes onto the cache and
    into every paged attention call as its ``xla_max_pages``, as in
    JAX.

    ``decode_fusion`` ("0", "1" or "auto"; default
    ``APEX_TPU_DECODE_FUSION``, else "0") and ``fusion_min_pages`` are
    resolved once here (:func:`~apex_tpu_torch.ops.paged_attention.
    resolve_decode_fusion`; "1" on the dense cache is a ``ValueError``,
    as in JAX); a fused engine keeps a second copy of the layer weights
    in the fused layout (:func:`~apex_tpu_torch.inference.models.
    fused_layer_params`) beside the tree that prefill reads.
    ``kind="bert"`` builds the encode-only engine.

    ``tp`` (default ``APEX_TPU_SERVE_TP``, else 1) and ``group``: at
    ``tp > 1`` this process is one rank of a paged GPT or LLaMA engine
    (module docstring); ``params`` is the full tree (the same on every
    rank), of which the engine keeps the rank's shard, ``params`` the
    shard; ``cache_hbm_bytes`` counts the rank's pool.

    ``host_tier_bytes`` (default ``APEX_TPU_HOST_KV_TIER_BYTES``, else
    0: off) and ``swap_batch_pages`` (default
    ``APEX_TPU_SWAP_BATCH_PAGES``, else 8) arm a paged engine's host
    page tier (module docstring); the dense cache with a tier is a
    ``ValueError``, as in JAX."""

    def __init__(self, kind: str, cfg, params, *, slots: int = 4,
                 max_seq: Optional[int] = None, dtype=None,
                 cache_dtype=torch.bfloat16,
                 sampling: SamplingConfig = SamplingConfig(),
                 seed: int = 0, paged: bool = False,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 paged_attn_max_pages: Optional[int] = None,
                 decode_fusion=None, fusion_min_pages=None,
                 spec_k: Optional[int] = None,
                 tp: Optional[int] = None,
                 host_tier_bytes: Optional[int] = None,
                 swap_batch_pages: Optional[int] = None, device=None,
                 group=None):
        if kind not in ("gpt", "llama", "bert"):
            raise ValueError(f"unknown model kind {kind!r}")
        if kind != "bert":
            models.check_supported(kind, cfg)
        self.kind, self.cfg = kind, cfg
        self.device = resolve_device(device)
        self.slots = int(slots)
        self.max_seq = min(int(max_seq or cfg.max_seq_length),
                           cfg.max_seq_length)
        self.cache_dtype = cache_dtype
        self.sampling = sampling
        # any paged kwarg opts in; the dense slot cache is the default
        self.paged = bool(paged or page_size is not None
                          or num_pages is not None)
        if kind == "bert" and self.paged:
            raise ValueError("BERT is the encode-only path (no KV "
                             "cache); paged kwargs do not apply")
        self.tp = int(tp) if tp is not None else serve_tp()
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.tp > 1:
            if kind == "bert":
                raise ValueError(
                    "tensor-parallel serving is a generative-path "
                    "feature; BERT is the encode-only path")
            if not self.paged:
                raise ValueError(
                    "tensor-parallel serving shards the PAGED kv pool "
                    "over kv heads — pass page_size=/num_pages= (the "
                    "dense slot cache does not shard)")
            # the geometry first (tp | heads; tp | kv_heads or kv_heads |
            # tp), as the JAX engine checks it, then the process group
            models.tp_dims(kind, cfg, self.tp)
        self.group = _tp_group(self.tp, group)
        self.rank = dist.get_rank(self.group) if self.group is not None \
            else 0
        if self.paged:
            self._init_paged(page_size, num_pages, host_tier_bytes,
                             swap_batch_pages)
            self.paged_attn_max_pages = paged_attn_max_pages
        else:
            self.paged_attn_max_pages = None
            if host_tier_bytes:
                raise ValueError(
                    "host_tier_bytes is the paged-mode host page tier; "
                    "this engine runs the dense slot cache")
            self.page_size = self.num_pages = None
            self.max_pages_per_slot = None
            self.host_tier_bytes = 0
            self.swap_batch_pages = None
        if kind == "bert":
            if spec_k or (decode_fusion is not None
                          and resolve_fusion_mode(decode_fusion) == "1"):
                raise ValueError("speculative decoding / fused-block "
                                 "decode are generative-path features; "
                                 "BERT is the encode-only path")
            self.spec_k = 0
            self.decode_fused = False
        else:
            self.spec_k = int(spec_k if spec_k is not None
                              else default_spec_k())
            self.decode_fused = resolve_decode_fusion(
                decode_fusion, paged=self.paged,
                max_pages=self.max_pages_per_slot,
                min_pages=fusion_min_pages)
            # a pool no paged kernel takes fails here, not at the first
            # decode step
            if self.paged and self.device.type == "cuda" \
                    and not self.decode_fused:
                dims = models.tp_dims(kind, cfg, self.tp)
                check_kernel_page_size(
                    self.page_size,
                    group=dims["heads_local"] // dims["kv_heads_local"],
                    head_dim=dims["head_dim"], dtype=self.cache_dtype)
        self.params = self._place(params, dtype)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._step = 0
        self._tel_registry = None
        self._refresh_dispatch_counters()
        if kind == "bert":
            self._fused_layers = None
            self._bert, self._bert_state = self._bert_encoder()
            return
        self.dims = models.model_dims(kind, cfg)
        self.tp_dims = models.tp_dims(kind, cfg, self.tp)
        if self.tp > 1:
            self._shard()
        else:
            self._fused_layers = (
                models.fused_layer_params(kind, cfg, self.params)
                if self.decode_fused else None)
        # the step bodies, one copy each: the pure factories' functions
        tp_kw = dict(tp=self.tp, group=self.group)
        self._prefill_raw = make_prefill_fn(kind, cfg, sampling,
                                            paged=self.paged, **tp_kw)
        self._decode_raw = make_decode_fn(kind, cfg, sampling,
                                          fused=self.decode_fused, **tp_kw)
        self._verify_raw = (make_verify_fn(kind, cfg, sampling, self.spec_k,
                                           **tp_kw)
                            if self.spec_k else None)

    def _shard(self) -> None:
        """Keep the rank's shard of the weights: the kv heads expanded
        below tp, the tree's column/row slices
        (:func:`~apex_tpu_torch.inference.models.param_partition_specs`)
        and, fused, each layer's fused layout built from the expanded
        tree and sliced as it is built (the JAX engine's
        ``fused_partition_specs``), so the whole layout is never alive
        at once.  The engine holds no reference to the whole tree."""
        kind, cfg, tp, rank = self.kind, self.cfg, self.tp, self.rank
        full = models.expand_kv_for_tp(kind, cfg, self.params, tp)
        self.params = models.shard_tree(
            full, models.param_partition_specs(kind, cfg, full, tp), tp,
            rank)
        self._fused_layers = [
            models.shard_tree(blk, models.fused_partition_specs([blk], tp)[0],
                              tp, rank)
            for blk in models._fused_layers(kind, cfg, full)] \
            if self.decode_fused else None

    def _init_paged(self, page_size, num_pages, host_tier_bytes,
                    swap_batch_pages):
        self.page_size = int(page_size if page_size is not None
                             else kv_cache.default_page_size())
        if self.page_size < 1 or (self.page_size & (self.page_size - 1)):
            raise ValueError(
                f"page_size must be a positive power of two (so prefill "
                f"buckets tile into whole pages), got {self.page_size}")
        if self.max_seq % self.page_size:
            raise ValueError(
                f"max_seq ({self.max_seq}) must be a multiple of "
                f"page_size ({self.page_size})")
        self.max_pages_per_slot = self.max_seq // self.page_size
        self.num_pages = int(num_pages if num_pages is not None
                             else self.slots * self.max_pages_per_slot)
        if self.num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got "
                             f"{self.num_pages}")
        # the host page tier: explicit kwargs win, else the env knobs;
        # 0 bytes is the tier off (eviction discards)
        self.host_tier_bytes = int(host_tier_bytes if host_tier_bytes
                                   is not None else host_kv_tier_bytes())
        if self.host_tier_bytes < 0:
            raise ValueError(f"host_tier_bytes must be >= 0, got "
                             f"{self.host_tier_bytes}")
        self.swap_batch_pages = int(
            swap_batch_pages if swap_batch_pages is not None
            else kv_cache.default_swap_batch_pages())
        if self.swap_batch_pages < 1:
            raise ValueError(f"swap_batch_pages must be >= 1, got "
                             f"{self.swap_batch_pages}")

    def _bert_encoder(self):
        """The port's ``BertModel`` with no storage of its own (built on
        the meta device) and the engine's tree as its parameters, by
        dotted name, for ``torch.func.functional_call``."""
        from apex_tpu_torch.transformer.testing.standalone_bert import (
            bert_model_provider)
        model = bert_model_provider(self.cfg, add_binary_head=False,
                                    device="meta")
        state = {".".join(map(str, path)): t for path, t in
                 tree_leaves_with_path(models._params_subtree(self.params))}
        want = {name for name, _ in model.named_parameters()}
        if not want <= set(state):
            raise ValueError(f"the BERT tree lacks "
                             f"{sorted(want - set(state))}")
        # a tree with the pooler and NSP head serves too (unread, as in
        # the JAX engine's add_binary_head=False apply)
        return model, {name: state[name] for name in want}

    def _place(self, tree, dtype):
        if isinstance(tree, dict):
            return {k: self._place(v, dtype) for k, v in tree.items()}
        t = torch.as_tensor(tree)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(self.device)

    def _refresh_dispatch_counters(self) -> None:
        reg = obs.global_registry()
        if reg is not self._tel_registry:
            self._tel_registry = reg
            self._prefill_dispatches = reg.declared(
                "infer_prefill_dispatch_total")
            self._decode_dispatches = reg.declared(
                "infer_decode_dispatch_total")
            self._cow_dispatches = reg.declared("infer_cow_dispatch_total")
            self._fused_decode_dispatches = reg.declared(
                "infer_decode_fused_dispatch_total")
            self._verify_dispatches = reg.declared(
                "infer_verify_dispatch_total")
            self._swap_out_dispatches = reg.declared(
                "infer_swap_out_dispatch_total")
            self._swap_in_dispatches = reg.declared(
                "infer_swap_in_dispatch_total")

    def _generative(self, what: str) -> None:
        if self.kind == "bert":
            raise ValueError(f"BERT is the encode-only path (no KV cache); "
                             f"use encode(), not {what}()")

    # -- cache ---------------------------------------------------------------
    def init_cache(self):
        """An empty cache: the dense slot cache, or the paged pool."""
        self._generative("init_cache")
        d = self.dims
        if not self.paged:
            return kv_cache.init_cache(
                self.slots, d["layers"], d["kv_heads"], self.max_seq,
                d["head_dim"], dtype=self.cache_dtype, device=self.device)
        # at tp > 1 the rank's shard of the pool: kv_heads_pool / tp heads
        # of every page (GQA/MQA heads replicated below tp)
        return kv_cache.init_paged_cache(
            self.num_pages, d["layers"], self._pool_heads(), self.page_size,
            d["head_dim"], slots=self.slots,
            max_pages_per_slot=self.max_pages_per_slot,
            dtype=self.cache_dtype,
            attn_max_pages=self.paged_attn_max_pages, device=self.device)

    def _pool_heads(self) -> int:
        """The kv heads of every page of this rank's pool."""
        return self.tp_dims["kv_heads_pool"] // self.tp

    def new_allocator(self) -> kv_cache.PageAllocator:
        """Fresh host-side page allocator matching the pool geometry."""
        if not self.paged:
            raise ValueError("new_allocator() is the paged-mode page "
                             "bookkeeping; this engine runs the dense "
                             "slot cache")
        return kv_cache.PageAllocator(self.num_pages, self.page_size,
                                      self.max_pages_per_slot)

    def cache_hbm_bytes(self) -> int:
        """Bytes the KV cache pins in device memory: the pool's pages
        (incl. the trash page), or slots x max_seq (dense).  At ``tp >
        1`` the rank's bytes: its ``kv_heads_pool / tp`` heads of every
        page (1/tp of a pool that tp divides; an MQA pool replicated
        below tp keeps its one kv head on every rank)."""
        d = self.dims
        itemsize = torch.empty((), dtype=self.cache_dtype).element_size()
        if self.paged:
            per_tok = 2 * d["layers"] * self._pool_heads() * d["head_dim"] \
                * itemsize
            return (self.num_pages + 1) * self.page_size * per_tok
        per_tok = 2 * d["layers"] * d["kv_heads"] * d["head_dim"] * itemsize
        return self.slots * self.max_seq * per_tok

    # -- generative path -----------------------------------------------------
    def _next_step(self) -> int:
        s = self._step
        self._step += 1
        return s

    def bucket_for(self, n: int) -> int:
        """The prefill bucket an ``n``-token prompt pads up to."""
        min_bucket = max(64, self.page_size) if self.paged else 64
        return prefill_bucket(n, self.max_seq, min_bucket=min_bucket)

    def prefill(self, cache, tokens, slot, pages=None, prefill_from=0):
        """Admit one prompt into ``slot``: returns ``(cache, next_token,
        last_logits)``; ``next_token`` is a CPU int32 scalar tensor,
        ``last_logits`` the fp32 ``[vocab]`` row on the device.

        ``tokens`` is the UNPADDED prompt.  Paged: ``pages`` is the FULL
        ordered page-ID list backing prompt + decode headroom (shared
        prefix pages first on a prefix-cache hit) and ``prefill_from``
        how many leading prompt tokens are already cached in those pages
        — only ``tokens[prefill_from:]`` runs the forward, padded to its
        own bucket.  Dense: no pages, and ``prefill_from`` must be 0."""
        self._generative("prefill")
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = tokens.shape[0]
        start = int(prefill_from)
        if start < 0 or start >= n:
            raise ValueError(
                f"prefill_from ({start}) must be in [0, prompt length "
                f"{n}) — at least the last prompt token is always "
                f"prefilled (its logits seed the first sampled token)")
        if start and not self.paged:
            raise ValueError(
                "prefill_from needs the paged cache (prefix sharing is "
                "a page-table edit); this engine runs the dense slot "
                "cache")
        row = None
        if self.paged:
            if pages is None:
                raise ValueError(
                    "paged prefill needs the slot's reserved page IDs "
                    "(engine.new_allocator().acquire(...)); the scheduler "
                    "threads them automatically")
            if len(pages) * self.page_size < n:
                raise ValueError(
                    f"reservation of {len(pages)} page(s) x "
                    f"{self.page_size} covers {len(pages) * self.page_size}"
                    f" tokens < the {n}-token prompt — reserve ceil((prompt "
                    f"+ max_new_tokens) / page_size) pages")
            row = kv_cache.page_row(pages, self.max_pages_per_slot,
                                    self.num_pages)
        suffix = tokens[start:]
        padded = np.zeros((self.bucket_for(suffix.shape[0]),), np.int32)
        padded[:suffix.shape[0]] = suffix
        self._refresh_dispatch_counters()
        self._prefill_dispatches.inc()
        toks = torch.from_numpy(padded).to(self.device)
        tail = (row, start) if self.paged else ()
        with torch.profiler.record_function(
                "apex_tpu_torch.inference.prefill"):
            cache, tok, last = self._prefill_raw(
                cache, self.params, toks, int(slot), n, *tail, self._gen,
                self._next_step())
        return cache, tok.cpu(), last

    def cow_page(self, cache, src, dst):
        """Copy-on-write page duplication: copy physical page ``src``
        into ``dst`` (the scheduler's write barrier before a slot writes
        into a page it still shares); at ``tp > 1`` each rank copies its
        own heads of the page, as the page IDs are the same on every
        rank."""
        if not self.paged:
            raise ValueError("cow_page is the paged-mode write barrier; "
                             "this engine runs the dense slot cache")
        self._refresh_dispatch_counters()
        self._cow_dispatches.inc()
        return kv_cache.cow_page(cache, int(src), int(dst))

    def evict_slot(self, cache, slot: int):
        """Metadata evict of one slot: zero its length (paged: also
        re-park its page-table row on the trash page)."""
        return kv_cache.evict(cache, int(slot))

    def page_host_bytes(self) -> int:
        """Host bytes ONE page's k+v slabs occupy in the host tier: the
        whole page (every kv head of the pool) even at ``tp > 1``, as
        JAX counts it, so every rank's host store and prefix cache book
        and choose alike (a rank's own slabs hold only its heads)."""
        if not self.paged:
            raise ValueError("page_host_bytes is the paged-mode host "
                             "tier ledger; this engine runs the dense "
                             "slot cache")
        d = self.dims
        itemsize = torch.empty((), dtype=self.cache_dtype).element_size()
        return (2 * d["layers"] * self.tp_dims["kv_heads_pool"]
                * self.page_size * d["head_dim"] * itemsize)

    def swap_out_pages(self, cache, page_ids, defer: bool = False):
        """Copy physical pages ``page_ids`` device→host (eviction
        offload): returns the ``(k, v)`` numpy slabs ``[n, layers,
        kv_heads, page_size, head_dim]`` (bf16 as ``uint16`` bits).  A
        pure read: the cache stays valid.  Each batch of
        ``swap_batch_pages`` is one gather into a fresh device slab
        (:func:`~apex_tpu_torch.inference.kv_cache.extract_pages`) and
        one copy a buffer into the call's host buffers (pinned on CUDA,
        ``non_blocking``), all queued before any is waited for.

        ``defer=True`` returns a :class:`PendingSwapOut` instead: the
        copies are queued now, in stream order ahead of any later cache
        write, and only its ``resolve()`` waits for them (the scheduler
        drains it at the next wave boundary).  At ``tp > 1`` a rank's
        slabs hold its own ``kv_heads_pool / tp`` heads (JAX's single
        controller gathers every head): the ranks' slabs side by side on
        the kv-head axis, in rank order, are the whole page."""
        if not self.paged:
            raise ValueError("swap_out_pages is the paged-mode host "
                             "tier; this engine runs the dense slot "
                             "cache")
        ids = np.asarray(page_ids, np.int64).reshape(-1)
        n, B = ids.shape[0], self.swap_batch_pages
        if n == 0:
            raise ValueError("swap_out_pages needs at least one page")
        self._refresh_dispatch_counters()
        pin = cache.device.type == "cuda"
        shape = (n,) + tuple(cache.k.shape[1:])
        k_host = torch.empty(shape, dtype=cache.k.dtype, pin_memory=pin)
        v_host = torch.empty(shape, dtype=cache.v.dtype, pin_memory=pin)
        event = None
        with torch.profiler.record_function(
                "apex_tpu_torch.inference.swap_out"):
            for i in range(0, n, B):
                self._swap_out_dispatches.inc()
                k_s, v_s = kv_cache.extract_pages(cache, ids[i:i + B])
                k_host[i:i + B].copy_(k_s, non_blocking=pin)
                v_host[i:i + B].copy_(v_s, non_blocking=pin)
            if pin:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(cache.device))
        pending = PendingSwapOut(k_host, v_host, event)
        return pending if defer else pending.resolve()

    def swap_in_pages(self, cache, page_ids, k_slabs, v_slabs):
        """Upload host-tier page slabs into freshly acquired physical
        pages ``page_ids`` (a hit after eviction): returns the cache,
        written in place.  The inverse of :meth:`swap_out_pages`, a
        batch of ``swap_batch_pages`` at a time: ``uint16`` slabs are
        read as bf16 bits, floating ones cast to the pool's dtype.  On
        CUDA each batch is staged through a pinned buffer (one host
        copy) and uploaded ``non_blocking``, so the host does not wait
        for the card; the scheduler calls this before the suffix's first
        prefill chunk, which the uploads precede in stream order.  At
        ``tp > 1`` the slabs are the rank's own heads."""
        if not self.paged:
            raise ValueError("swap_in_pages is the paged-mode host "
                             "tier; this engine runs the dense slot "
                             "cache")
        ids = np.asarray(page_ids, np.int64).reshape(-1)
        n, B = ids.shape[0], self.swap_batch_pages
        k_slabs = np.asarray(k_slabs)
        v_slabs = np.asarray(v_slabs)
        if n == 0:
            raise ValueError("swap_in_pages needs at least one page")
        if k_slabs.shape[0] != n or v_slabs.shape[0] != n:
            raise ValueError(
                f"swap-in slabs must carry one entry per page id "
                f"({n}), got k {k_slabs.shape[0]} v {v_slabs.shape[0]}")
        self._refresh_dispatch_counters()
        pin = cache.device.type == "cuda"

        def upload(slab):
            t = _host_tensor(slab, cache.k.dtype)
            if not pin:
                return t
            staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            staged.copy_(t)
            return staged.to(cache.device, non_blocking=True)

        with torch.profiler.record_function(
                "apex_tpu_torch.inference.swap_in"):
            for i in range(0, n, B):
                self._swap_in_dispatches.inc()
                cache = kv_cache.restore_pages(
                    cache, ids[i:i + B], upload(k_slabs[i:i + B]),
                    upload(v_slabs[i:i + B]))
        return cache

    def decode(self, cache, last_tokens, active=None):
        """One token for every slot: returns ``(cache, next_tokens,
        logits, truncated)``; only ``active`` slots advance.
        ``next_tokens`` and ``truncated`` are CPU tensors, ``logits``
        the fp32 ``[slots, vocab]`` on the device.  A slot already at
        its capacity is flagged in ``truncated`` (its token could not be
        appended) and must be retired by the caller."""
        self._generative("decode")
        if active is None:
            active = np.ones((self.slots,), bool)
        self._refresh_dispatch_counters()
        self._decode_dispatches.inc()
        if self.decode_fused:
            self._fused_decode_dispatches.inc()
        toks_in = torch.from_numpy(
            np.asarray(last_tokens, np.int32).reshape(-1)).to(self.device)
        act = torch.from_numpy(np.asarray(active, bool)).to(self.device)
        params = ((self.params, self._fused_layers) if self.decode_fused
                  else self.params)
        with torch.profiler.record_function(
                "apex_tpu_torch.inference.decode"):
            cache, toks, logits, truncated = self._decode_raw(
                cache, params, toks_in, act, self._gen, self._next_step())
        return cache, toks.cpu(), logits, truncated.cpu()

    def verify(self, cache, slab, active=None):
        """One speculative-verify step: ``slab [slots, spec_k + 1]``
        (column 0 each slot's last confirmed token, the rest drafts) ->
        ``(cache, tokens [slots, spec_k + 1], n_emit [slots],
        truncated)``, the last three CPU tensors.  ``tokens[:, :n_emit]``
        per slot is the emitted stream, the target's own greedy
        continuation; lengths advance by ``n_emit``.  The same capacity
        contract as :meth:`decode`: the caller clamps the emitted tokens
        to the slot's remaining capacity and retires truncated slots."""
        self._generative("verify")
        if not self.spec_k:
            raise ValueError(
                "speculative decoding is off for this engine; build it "
                "with spec_k > 0 (or APEX_TPU_SPEC_K)")
        slab = np.asarray(slab, np.int32)
        if slab.shape != (self.slots, self.spec_k + 1):
            raise ValueError(
                f"verify slab must be [{self.slots}, "
                f"{self.spec_k + 1}] (last token + {self.spec_k} "
                f"drafts), got {tuple(slab.shape)}")
        if active is None:
            active = np.ones((self.slots,), bool)
        self._refresh_dispatch_counters()
        self._verify_dispatches.inc()
        act = torch.from_numpy(np.asarray(active, bool)).to(self.device)
        with torch.profiler.record_function(
                "apex_tpu_torch.inference.verify"):
            cache, toks, n_emit, truncated = self._verify_raw(
                cache, self.params, torch.from_numpy(slab).to(self.device),
                act, self._gen, self._next_step())
        return cache, toks.cpu(), n_emit.cpu(), truncated.cpu()

    def generate(self, prompts, max_new_tokens: int = 16,
                 eos_id: Optional[int] = None):
        """Continuous-batching run over the scheduler: ``prompts`` (list
        of token lists) -> list of generated token lists, in submission
        order."""
        from apex_tpu_torch.inference import scheduler
        return scheduler.generate(self, prompts,
                                  max_new_tokens=max_new_tokens,
                                  eos_id=eos_id)

    # -- encode-only path (BERT) --------------------------------------------
    def encode(self, tokens, token_types=None):
        """BERT path: one bidirectional forward of ``tokens [b, s]`` (no
        padding mask, as in JAX) -> ``(lm_logits [s, b, vocab], None)``;
        ``token_types`` default to zeros."""
        if self.kind != "bert":
            raise ValueError("encode() is the BERT path; use "
                             "prefill()/decode() for generative models")
        tokens = torch.as_tensor(tokens).to(self.device, torch.int32)
        if token_types is None:
            token_types = torch.zeros_like(tokens)
        else:
            token_types = torch.as_tensor(token_types).to(self.device,
                                                          torch.int32)
        with torch.no_grad(), torch.profiler.record_function(
                "apex_tpu_torch.inference.encode"):
            return torch.func.functional_call(
                self._bert, self._bert_state, (tokens, token_types))

    # -- checkpoint boundaries ----------------------------------------------
    @classmethod
    def from_train_state(cls, kind: str, cfg, state, *,
                         dtype=torch.bfloat16, **kwargs):
        """Build from a :class:`~apex_tpu_torch.train_step.TrainState`
        (or a bare ``FlatState``): the weights exported in ``dtype``
        (bf16, the serving default) by ``FlatState.params(dtype=...)``;
        every other keyword goes to ``__init__``."""
        opt = getattr(state, "opt", state)
        return cls(kind, cfg, opt.params(dtype=dtype), **kwargs)

    @classmethod
    def from_state_dict(cls, kind: str, cfg, sd, params_template, *,
                        dtype=torch.bfloat16, **kwargs):
        """Build from a state dict whose ``"master"`` is the full flat fp32
        master, plus the param template (the model, or its tree) that
        defines the leaf layout
        (:func:`~apex_tpu_torch.optimizers.functional.export_params`)."""
        from apex_tpu_torch.optimizers.functional import export_params
        params = export_params(sd["master"], params_template, dtype=dtype)
        return cls(kind, cfg, params, **kwargs)
