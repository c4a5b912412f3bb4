"""Tensor parallelism of the port (reference:
``apex/transformer/tensor_parallel``; port of
``apex_tpu/transformer/tensor_parallel``): the mappings collectives,
the parallel layers, the vocab-parallel cross entropy, the data
broadcast, the memory buffer and the RNG streams, one process a rank
over ``torch.distributed``."""
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    scatter_to_tensor_model_parallel_region,
    gather_from_tensor_model_parallel_region,
    scatter_to_sequence_parallel_region,
    gather_from_sequence_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    linear_with_grad_accumulation_and_async_allreduce,
    set_tensor_model_parallel_attributes,
    set_defaults_if_not_set_tensor_model_parallel_attributes,
    copy_tensor_model_parallel_attributes,
    param_is_not_tensor_parallel_duplicate,
)
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.data import broadcast_data
from apex_tpu_torch.transformer.tensor_parallel.memory import MemoryBuffer
from apex_tpu_torch.transformer.tensor_parallel.random import (
    RNGStatesTracker,
    CudaRNGStatesTracker,
    get_rng_tracker,
    get_cuda_rng_tracker,
    model_parallel_seed,
    model_parallel_cuda_manual_seed,
    checkpoint,
)
from apex_tpu_torch.transformer.utils import (
    split_tensor_along_last_dim,
    VocabUtility,
)

__all__ = [
    "copy_to_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "scatter_to_sequence_parallel_region",
    "gather_from_sequence_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "ColumnParallelLinear",
    "RowParallelLinear",
    "VocabParallelEmbedding",
    "linear_with_grad_accumulation_and_async_allreduce",
    "set_tensor_model_parallel_attributes",
    "set_defaults_if_not_set_tensor_model_parallel_attributes",
    "copy_tensor_model_parallel_attributes",
    "param_is_not_tensor_parallel_duplicate",
    "vocab_parallel_cross_entropy",
    "broadcast_data",
    "MemoryBuffer",
    "RNGStatesTracker",
    "CudaRNGStatesTracker",
    "get_rng_tracker",
    "get_cuda_rng_tracker",
    "model_parallel_seed",
    "model_parallel_cuda_manual_seed",
    "checkpoint",
    "split_tensor_along_last_dim",
    "VocabUtility",
]
