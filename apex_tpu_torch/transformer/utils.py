"""Shape and partition arithmetic of tensor parallelism.

Port of ``apex_tpu/transformer/utils.py`` (reference:
``apex/transformer/utils.py``, ``tensor_parallel/utils.py ::
VocabUtility``).
"""
from __future__ import annotations

import torch

__all__ = [
    "ensure_divisibility",
    "divide",
    "split_tensor_along_last_dim",
    "VocabUtility",
]


def ensure_divisibility(numerator: int, denominator: int) -> None:
    assert numerator % denominator == 0, (
        f"{numerator} is not divisible by {denominator}")


def divide(numerator: int, denominator: int) -> int:
    ensure_divisibility(numerator, denominator)
    return numerator // denominator


def split_tensor_along_last_dim(tensor, num_partitions: int,
                                contiguous_split_chunks: bool = False):
    """Split a tensor along its last dimension into ``num_partitions``
    equal chunks (views; contiguous copies with
    ``contiguous_split_chunks``)."""
    last_dim_size = divide(tensor.shape[-1], num_partitions)
    chunks = torch.split(tensor, last_dim_size, dim=-1)
    if contiguous_split_chunks:
        return tuple(c.contiguous() for c in chunks)
    return chunks


class VocabUtility:
    """Vocab-range math for vocab-sharded embeddings and logits: rank
    ``rank`` of ``world_size`` holds ids ``[first, last)``."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size: int, rank, world_size: int):
        index_f = rank * per_partition_vocab_size
        index_l = index_f + per_partition_vocab_size
        return index_f, index_l

    @staticmethod
    def vocab_range_from_global_vocab_size(global_vocab_size: int, rank,
                                           world_size: int):
        per_partition_vocab_size = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size, rank, world_size)
