"""apex_tpu_torch.models — the flagship model zoo of the port.

Port of ``apex_tpu/models/__init__.py``: re-exports the standalone
Megatron-style models built on the port's transformer toolkit (the
reference keeps them under ``transformer/testing`` because Apex is a
library; here they double as the flagship models, so they get a stable
top-level home too).  The names are the same objects as
``apex_tpu_torch.transformer.testing``'s.
"""
from apex_tpu_torch.transformer.testing.standalone_bert import (
    BertConfig,
    BertModel,
    bert_model_provider,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import (
    GPTConfig,
    GPTModel,
    gpt_model_provider,
)
from apex_tpu_torch.transformer.testing.standalone_llama import (
    LlamaConfig,
    LlamaModel,
    llama_model_provider,
)

__all__ = [
    "BertConfig",
    "BertModel",
    "bert_model_provider",
    "GPTConfig",
    "GPTModel",
    "gpt_model_provider",
    "LlamaConfig",
    "LlamaModel",
    "llama_model_provider",
]
