"""Prefill/decode inference engine over the paged KV pool, in PyTorch.

Port of ``apex_tpu/inference/engine.py`` for this slice: LLaMA at
tp = 1 with the paged cache (``page_size=`` / ``num_pages=``), served
through :meth:`InferenceEngine.generate` and the copied
:class:`~apex_tpu_torch.inference.scheduler.SlotScheduler`.

* **Prefill** — one prompt (or its uncached tail) padded to a
  power-of-two bucket, one causal forward through the flash kernel (or
  the prefix-window attention on a warm start), its k/v scattered into
  the slot's pages, the first token sampled from the last real row.
* **Decode** — one token for every slot: per layer RMSNorm, qkv + RoPE,
  the pool append, paged decode attention, the MLP; then the LM head,
  sampling and the length advance.  Under fused-block decode
  (``decode_fusion="1"``, or ``"auto"`` with a window of at least
  ``fusion_min_pages`` pages) each layer is one launch of the
  fused-block kernel followed by the pool append.

PyTorch runs eagerly, so where the JAX engine compiles one donated
executable per step, this engine runs the same ops in order and updates
the pool in place.  Sampled tokens and the ``truncated`` flags come
back as CPU tensors: the scheduler reads them between steps, which is
the continuous-batching control loop's one host read per step.

A trained model enters through :meth:`InferenceEngine.from_train_state`
or :meth:`InferenceEngine.from_state_dict`.

Not in this slice (each raises ``NotImplementedError`` naming its
ROADMAP item): GPT and BERT, the dense slot cache, tensor-parallel
serving, speculative decoding and the host-DRAM page tier.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from apex_tpu_torch import observability as obs
from apex_tpu_torch.inference import kv_cache, models
from apex_tpu_torch.inference.sampling import SamplingConfig, sample_token
from apex_tpu_torch.inference.speculative import default_spec_k
from apex_tpu_torch.ops.paged_attention import (
    check_kernel_page_size, resolve_decode_fusion)
from apex_tpu_torch.utils import resolve_device

__all__ = ["InferenceEngine", "prefill_bucket"]

_TP_ENV = "APEX_TPU_SERVE_TP"
_HOST_TIER_ENV = "APEX_TPU_HOST_KV_TIER_BYTES"


def _later_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP queue 1, {item!r}")


def _env_int(name: str) -> int:
    raw = os.environ.get(name, "0").strip() or "0"
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}")


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


class InferenceEngine:
    """Serving engine over a LLaMA param tree on the paged KV pool.

    ``slots`` concurrent sequences with a ``max_seq``-token virtual
    window each; ``num_pages`` pages of ``page_size`` tokens in the pool
    (default: the dense-equivalent ``slots * max_seq / page_size``).
    ``params`` is the tree of tensors :func:`~apex_tpu_torch.inference.
    weights.params_from_jax` returns (or any tree with its key paths);
    it is cast to ``dtype`` when given and moved to the engine's
    device.  ``device=None`` is CUDA and raises without a card;
    ``device="cpu"`` runs the kernels' plain versions.

    ``decode_fusion`` ("0", "1" or "auto"; default
    ``APEX_TPU_DECODE_FUSION``, else "0") and ``fusion_min_pages`` are
    resolved once here (:func:`~apex_tpu_torch.ops.paged_attention.
    resolve_decode_fusion`); a fused engine keeps a second copy of the
    layer weights in the fused layout (:func:`~apex_tpu_torch.inference.
    models.fused_layer_params`) beside the tree that prefill reads."""

    def __init__(self, kind: str, cfg, params, *, slots: int = 4,
                 max_seq: Optional[int] = None, dtype=None,
                 cache_dtype=torch.bfloat16,
                 sampling: SamplingConfig = SamplingConfig(),
                 seed: int = 0, paged: bool = False,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 decode_fusion=None, fusion_min_pages=None,
                 spec_k: Optional[int] = None,
                 tp: Optional[int] = None,
                 host_tier_bytes: Optional[int] = None, device=None):
        models.check_supported(kind, cfg)
        if not (paged or page_size is not None or num_pages is not None):
            raise _later_slice("the dense slot cache",
                               "the dense cache and GPT serving")
        self.tp = int(tp) if tp is not None else (_env_int(_TP_ENV) or 1)
        if self.tp != 1:
            raise _later_slice(f"tensor-parallel serving (tp={self.tp})",
                               "tp and spec")
        self.spec_k = int(spec_k if spec_k is not None
                          else default_spec_k())
        if self.spec_k:
            raise _later_slice(f"speculative decoding (spec_k="
                               f"{self.spec_k})", "tp and spec")
        self.host_tier_bytes = int(host_tier_bytes if host_tier_bytes
                                   is not None else _env_int(_HOST_TIER_ENV))
        if self.host_tier_bytes:
            raise _later_slice("the host-DRAM KV page tier",
                               "host page tier")
        self.kind, self.cfg = kind, cfg
        self.device = resolve_device(device)
        self.slots = int(slots)
        self.max_seq = min(int(max_seq or cfg.max_seq_length),
                           cfg.max_seq_length)
        self.cache_dtype = cache_dtype
        self.sampling = sampling
        self.paged = True
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
        self.decode_fused = resolve_decode_fusion(
            decode_fusion, paged=True, max_pages=self.max_pages_per_slot,
            min_pages=fusion_min_pages)
        if self.device.type == "cuda" and not self.decode_fused:
            check_kernel_page_size(self.page_size)
        self.dims = models.model_dims(kind, cfg)
        self.tp_dims = models.tp_dims(kind, cfg, 1)
        self.params = self._place(params, dtype)
        self._fused_layers = (
            models.fused_layer_params(kind, cfg, self.params)
            if self.decode_fused else None)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._tel_registry = None
        self._refresh_dispatch_counters()

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

    # -- cache ---------------------------------------------------------------
    def init_cache(self) -> kv_cache.PagedKVCache:
        d = self.dims
        return kv_cache.init_paged_cache(
            self.num_pages, d["layers"], d["kv_heads"], self.page_size,
            d["head_dim"], slots=self.slots,
            max_pages_per_slot=self.max_pages_per_slot,
            dtype=self.cache_dtype, device=self.device)

    def new_allocator(self) -> kv_cache.PageAllocator:
        """Fresh host-side page allocator matching the pool geometry."""
        return kv_cache.PageAllocator(self.num_pages, self.page_size,
                                      self.max_pages_per_slot)

    def cache_hbm_bytes(self) -> int:
        """Bytes the KV pool pins in device memory (incl. the trash
        page)."""
        d = self.dims
        itemsize = torch.empty((), dtype=self.cache_dtype).element_size()
        per_tok = 2 * d["layers"] * d["kv_heads"] * d["head_dim"] * itemsize
        return (self.num_pages + 1) * self.page_size * per_tok

    # -- generative path -----------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """The prefill bucket an ``n``-token prompt pads up to."""
        return prefill_bucket(n, self.max_seq,
                              min_bucket=max(64, self.page_size))

    def prefill(self, cache, tokens, slot, pages=None, prefill_from=0):
        """Admit one prompt into ``slot``: returns ``(cache, next_token,
        last_logits)``; ``next_token`` is a CPU int32 scalar tensor,
        ``last_logits`` the fp32 ``[vocab]`` row on the device.

        ``tokens`` is the UNPADDED prompt; ``pages`` the FULL ordered
        page-ID list backing prompt + decode headroom (shared prefix
        pages first on a prefix-cache hit); ``prefill_from`` how many
        leading prompt tokens are already cached in those pages — only
        ``tokens[prefill_from:]`` runs the forward, padded to its own
        bucket."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = tokens.shape[0]
        start = int(prefill_from)
        if start < 0 or start >= n:
            raise ValueError(
                f"prefill_from ({start}) must be in [0, prompt length "
                f"{n}) — at least the last prompt token is always "
                f"prefilled (its logits seed the first sampled token)")
        if pages is None:
            raise ValueError(
                "paged prefill needs the slot's reserved page IDs "
                "(engine.new_allocator().acquire(...)); the scheduler "
                "threads them automatically")
        if len(pages) * self.page_size < n:
            raise ValueError(
                f"reservation of {len(pages)} page(s) x {self.page_size} "
                f"covers {len(pages) * self.page_size} tokens < the "
                f"{n}-token prompt — reserve ceil((prompt + "
                f"max_new_tokens) / page_size) pages")
        suffix = tokens[start:]
        padded = np.zeros((self.bucket_for(suffix.shape[0]),), np.int32)
        padded[:suffix.shape[0]] = suffix
        row = kv_cache.page_row(pages, self.max_pages_per_slot,
                                self.num_pages)
        self._refresh_dispatch_counters()
        self._prefill_dispatches.inc()
        toks = torch.from_numpy(padded).to(self.device)[None]
        with torch.no_grad(), torch.profiler.record_function(
                "apex_tpu_torch.inference.prefill"):
            logits, ks, vs = models.prefill_forward(
                self.kind, self.cfg, self.params, toks, n, cache=cache,
                row=row, prefill_from=start)
            cache = kv_cache.insert_tokens(cache, int(slot), ks, vs, n,
                                           row, start)
            last = logits[0].float()                        # [vocab]
            tok = sample_token(last, self._gen, self.sampling)
        return cache, tok.cpu(), last

    def cow_page(self, cache, src, dst):
        """Copy-on-write page duplication: copy physical page ``src``
        into ``dst`` (the scheduler's write barrier before a slot writes
        into a page it still shares)."""
        self._refresh_dispatch_counters()
        self._cow_dispatches.inc()
        return kv_cache.cow_page(cache, int(src), int(dst))

    def evict_slot(self, cache, slot: int):
        """Metadata evict of one slot: zero its length and re-park its
        page-table row on the trash page."""
        return kv_cache.evict(cache, int(slot))

    def decode(self, cache, last_tokens, active=None):
        """One token for every slot: returns ``(cache, next_tokens,
        logits, truncated)``; only ``active`` slots advance.
        ``next_tokens`` and ``truncated`` are CPU tensors, ``logits``
        the fp32 ``[slots, vocab]`` on the device.  A slot already at
        its capacity is flagged in ``truncated`` (its token could not be
        appended) and must be retired by the caller."""
        if active is None:
            active = np.ones((self.slots,), bool)
        self._refresh_dispatch_counters()
        self._decode_dispatches.inc()
        if self.decode_fused:
            self._fused_decode_dispatches.inc()
        toks_in = torch.from_numpy(
            np.asarray(last_tokens, np.int32).reshape(-1)).to(self.device)
        act = torch.from_numpy(np.asarray(active, bool)).to(self.device)
        with torch.no_grad(), torch.profiler.record_function(
                "apex_tpu_torch.inference.decode"):
            logits, cache = models.decode_forward(
                self.kind, self.cfg, self.params, cache, toks_in,
                fused=self._fused_layers)
            logits = logits.float()
            toks = sample_token(logits, self._gen, self.sampling)
            cache, truncated = kv_cache.advance(cache, act)
        return cache, toks.cpu(), logits, truncated.cpu()

    def generate(self, prompts, max_new_tokens: int = 16,
                 eos_id: Optional[int] = None):
        """Continuous-batching run over the scheduler: ``prompts`` (list
        of token lists) -> list of generated token lists, in submission
        order."""
        from apex_tpu_torch.inference import scheduler
        return scheduler.generate(self, prompts,
                                  max_new_tokens=max_new_tokens,
                                  eos_id=eos_id)

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
