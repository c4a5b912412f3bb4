"""The standalone test models of the port (LLaMA, GPT, BERT)."""
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

__all__ = ["LlamaConfig", "LlamaModel", "llama_model_provider",
           "GPTConfig", "GPTModel", "gpt_model_provider", "BertConfig",
           "BertModel", "bert_model_provider"]
