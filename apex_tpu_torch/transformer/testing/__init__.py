from apex_tpu_torch.transformer.testing.standalone_llama import LlamaConfig

__all__ = ["LlamaConfig"]
