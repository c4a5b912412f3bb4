"""Pipeline parallelism (reference: ``apex/transformer/pipeline_parallel``):
the executors, the pipe-ring p2p layer, the schedules' building blocks
and the microbatch calculator."""
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    get_forward_backward_func,
    forward_backward_no_pipelining,
    forward_backward_pipelining_without_interleaving,
    forward_backward_pipelining_with_interleaving,
    embedding_grads_all_reduce,
    interleaved_phase_ticks,
)
from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication
from apex_tpu_torch.transformer.pipeline_parallel.common import (
    build_model,
    forward_step,
    backward_step,
)
from apex_tpu_torch.transformer.pipeline_parallel.utils import (
    setup_microbatch_calculator,
    get_num_microbatches,
    get_current_global_batch_size,
    update_num_microbatches,
    listify_model,
    get_kth_microbatch,
)

__all__ = [
    "get_forward_backward_func",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_pipelining_with_interleaving",
    "embedding_grads_all_reduce",
    "interleaved_phase_ticks",
    "p2p_communication",
    "build_model",
    "forward_step",
    "backward_step",
    "setup_microbatch_calculator",
    "get_num_microbatches",
    "get_current_global_batch_size",
    "update_num_microbatches",
    "listify_model",
    "get_kth_microbatch",
]
