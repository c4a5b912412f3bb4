"""The standalone test models of the port (LLaMA, GPT, BERT), the
shared test helpers and the pretraining batch samplers."""
from apex_tpu_torch.transformer.testing.batch_sampler import (
    MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler,
)
from apex_tpu_torch.transformer.testing.commons import (
    IdentityLayer,
    initialize_distributed,
    set_random_seed,
)
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
           "BertModel", "bert_model_provider", "IdentityLayer",
           "initialize_distributed", "set_random_seed",
           "MegatronPretrainingSampler", "MegatronPretrainingRandomSampler"]
