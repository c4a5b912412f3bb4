"""Transformer building blocks of the port: RoPE, the tp = 1
tensor-parallel layers and cross entropy, and the LLaMA model."""
