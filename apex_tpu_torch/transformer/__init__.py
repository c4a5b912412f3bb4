"""Transformer building blocks of the port (serving slice: RoPE and the
LLaMA config)."""
