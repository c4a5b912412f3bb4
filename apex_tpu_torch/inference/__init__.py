"""Serving on the port: the GPT / LLaMA / BERT engine and its control
plane.

    engine        InferenceEngine (dense slot cache or paged pool,
                  prefill / decode / verify / generate; BERT encode;
                  tensor-parallel ranks over torch.distributed) and the
                  pure step factories make_prefill_fn, make_decode_fn,
                  make_verify_fn; serve_tp — ported
    models        GPT and LLaMA prefill / decode / verify forwards —
                  ported
    kv_cache      the dense slot cache and the paged pool (in-place
                  updates), PageAllocator, HostPageStore — ported /
                  copied
    weights       params_from_jax: the JAX param tree as tensors
    sampling      greedy / temperature / top-k over a torch.Generator
    scheduler     SlotScheduler — copied (only imports changed)
    prefix_cache  PrefixCache — copied
    speculative   the drafters: NGramDrafter and ReplayDrafter copied,
                  EngineDrafter ported (its rollback the in-place
                  set_lengths)
"""
from apex_tpu_torch.inference.engine import (InferenceEngine,
                                             make_decode_fn,
                                             make_prefill_fn,
                                             make_verify_fn, prefill_bucket)
from apex_tpu_torch.inference.kv_cache import (KVCache, PageAllocator,
                                               PagedKVCache,
                                               default_page_size, init_cache,
                                               init_paged_cache)
from apex_tpu_torch.inference.prefix_cache import PrefixCache
from apex_tpu_torch.inference.sampling import (SamplingConfig, greedy,
                                               sample_token)
from apex_tpu_torch.inference.scheduler import (Request, SlotScheduler,
                                                generate)
from apex_tpu_torch.inference.speculative import (Drafter, EngineDrafter,
                                                  NGramDrafter,
                                                  ReplayDrafter)
from apex_tpu_torch.inference.weights import params_from_jax

__all__ = ["Drafter", "EngineDrafter", "NGramDrafter", "ReplayDrafter",
           "InferenceEngine", "KVCache", "init_cache", "PagedKVCache",
           "init_paged_cache", "PageAllocator", "PrefixCache",
           "default_page_size", "SamplingConfig", "greedy", "sample_token",
           "Request", "SlotScheduler", "generate", "make_prefill_fn",
           "make_decode_fn", "make_verify_fn", "prefill_bucket",
           "params_from_jax"]
