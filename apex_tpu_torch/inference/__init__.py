"""Serving on the port: the GPT / LLaMA / BERT engine and its control
plane.

    engine        InferenceEngine (dense slot cache or paged pool,
                  prefill / decode / generate; BERT encode) — ported
    models        GPT and LLaMA prefill / decode forwards — ported
    kv_cache      the dense slot cache and the paged pool (in-place
                  updates), PageAllocator, HostPageStore — ported /
                  copied
    weights       params_from_jax: the JAX param tree as tensors
    sampling      greedy / temperature / top-k over a torch.Generator
    scheduler     SlotScheduler — copied (only imports changed)
    prefix_cache  PrefixCache — copied
    speculative   drafters — copied (EngineDrafter waits for its slice)
"""
from apex_tpu_torch.inference.engine import InferenceEngine, prefill_bucket
from apex_tpu_torch.inference.kv_cache import (KVCache, PageAllocator,
                                               PagedKVCache, init_cache,
                                               init_paged_cache)
from apex_tpu_torch.inference.sampling import (SamplingConfig, greedy,
                                               sample_token)
from apex_tpu_torch.inference.scheduler import SlotScheduler, generate
from apex_tpu_torch.inference.weights import params_from_jax

__all__ = ["InferenceEngine", "prefill_bucket", "KVCache", "init_cache",
           "PageAllocator", "PagedKVCache", "init_paged_cache", "SamplingConfig", "greedy",
           "sample_token", "SlotScheduler", "generate", "params_from_jax"]
