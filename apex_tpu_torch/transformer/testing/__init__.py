"""The standalone test models of the port (LLaMA)."""
from apex_tpu_torch.transformer.testing.standalone_llama import (
    LlamaConfig,
    LlamaModel,
    llama_model_provider,
)

__all__ = ["LlamaConfig", "LlamaModel", "llama_model_provider"]
