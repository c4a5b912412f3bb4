"""Transformer building blocks of the port: RoPE, the tensor-parallel
layers and cross entropy, the pipeline schedules, the model-parallel
grad scaler, and the LLaMA, GPT and BERT test models."""
from apex_tpu_torch.transformer import amp, pipeline_parallel

__all__ = ["amp", "pipeline_parallel"]
