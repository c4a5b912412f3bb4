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
* **Encode** (BERT) — one bidirectional forward of the port's
  ``BertModel`` over the engine's parameter tree: ``(lm_logits [s, b,
  vocab], None)``.

PyTorch runs eagerly, so where the JAX engine compiles one donated
executable per step, this engine runs the same ops in order and updates
the cache in place.  Sampled tokens and the ``truncated`` flags come
back as CPU tensors: the scheduler reads them between steps, which is
the continuous-batching control loop's one host read per step.

A trained model enters through :meth:`InferenceEngine.from_train_state`
or :meth:`InferenceEngine.from_state_dict`.

Not in this slice (each raises ``NotImplementedError`` naming its
ROADMAP item): tensor-parallel serving, speculative decoding and the
host-DRAM page tier.  Where the JAX package raises ``ValueError``
(BERT with a paged, fused or speculative kwarg; the dense cache with
``tp > 1`` or ``host_tier_bytes``), so does this engine.
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
    check_kernel_page_size, decode_fusion as resolve_fusion_mode,
    resolve_decode_fusion)
from apex_tpu_torch.utils import resolve_device, tree_leaves_with_path

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
    ``kind="bert"`` builds the encode-only engine."""

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
                 host_tier_bytes: Optional[int] = None, device=None):
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
        self.tp = int(tp) if tp is not None else (_env_int(_TP_ENV) or 1)
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
            raise _later_slice(f"tensor-parallel serving (tp={self.tp})",
                               "tp and spec")
        if self.paged:
            self._init_paged(page_size, num_pages, host_tier_bytes)
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
            if self.spec_k:
                raise _later_slice(f"speculative decoding (spec_k="
                                   f"{self.spec_k})", "tp and spec")
            self.decode_fused = resolve_decode_fusion(
                decode_fusion, paged=self.paged,
                max_pages=self.max_pages_per_slot,
                min_pages=fusion_min_pages)
            # a page size the kernel has no instance for fails here, not
            # at the first decode step
            if self.paged and self.device.type == "cuda" \
                    and not self.decode_fused:
                check_kernel_page_size(self.page_size)
        self.params = self._place(params, dtype)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._tel_registry = None
        self._refresh_dispatch_counters()
        if kind == "bert":
            self._fused_layers = None
            self._bert, self._bert_state = self._bert_encoder()
            return
        self.dims = models.model_dims(kind, cfg)
        self.tp_dims = models.tp_dims(kind, cfg, 1)
        self._fused_layers = (
            models.fused_layer_params(kind, cfg, self.params)
            if self.decode_fused else None)

    def _init_paged(self, page_size, num_pages, host_tier_bytes):
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
        self.host_tier_bytes = int(host_tier_bytes if host_tier_bytes
                                   is not None else _env_int(_HOST_TIER_ENV))
        if self.host_tier_bytes:
            raise _later_slice("the host-DRAM KV page tier",
                               "host page tier")

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
        return kv_cache.init_paged_cache(
            self.num_pages, d["layers"], d["kv_heads"], self.page_size,
            d["head_dim"], slots=self.slots,
            max_pages_per_slot=self.max_pages_per_slot,
            dtype=self.cache_dtype,
            attn_max_pages=self.paged_attn_max_pages, device=self.device)

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
        (incl. the trash page), or slots x max_seq (dense)."""
        d = self.dims
        itemsize = torch.empty((), dtype=self.cache_dtype).element_size()
        per_tok = 2 * d["layers"] * d["kv_heads"] * d["head_dim"] * itemsize
        if self.paged:
            return (self.num_pages + 1) * self.page_size * per_tok
        return self.slots * self.max_seq * per_tok

    # -- generative path -----------------------------------------------------
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
        toks = torch.from_numpy(padded).to(self.device)[None]
        with torch.no_grad(), torch.profiler.record_function(
                "apex_tpu_torch.inference.prefill"):
            if self.paged:
                logits, ks, vs = models.prefill_forward(
                    self.kind, self.cfg, self.params, toks, n, cache=cache,
                    row=row, prefill_from=start)
                cache = kv_cache.insert_tokens(cache, int(slot), ks, vs, n,
                                               row, start)
            else:
                logits, ks, vs = models.prefill_forward(
                    self.kind, self.cfg, self.params, toks, n)
                cache = kv_cache.insert(cache, int(slot), ks, vs, n)
            last = logits[0].float()                        # [vocab]
            tok = sample_token(last, self._gen, self.sampling)
        return cache, tok.cpu(), last

    def cow_page(self, cache, src, dst):
        """Copy-on-write page duplication: copy physical page ``src``
        into ``dst`` (the scheduler's write barrier before a slot writes
        into a page it still shares)."""
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
