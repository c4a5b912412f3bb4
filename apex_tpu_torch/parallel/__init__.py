"""apex_tpu_torch.parallel — data parallelism (reference:
``apex/parallel``), port of ``apex_tpu/parallel``.

* :class:`DistributedDataParallel` — bucketed grad all-reduce over the
  data-parallel process group.
* :class:`SyncBatchNorm` + :func:`convert_syncbn_model` — batch norm
  with statistics over the group.
* :class:`LARC` — layer-wise adaptive rate clipping.
"""
from apex_tpu_torch.parallel.distributed import (
    DistributedDataParallel, flat_allreduce)
from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm, convert_syncbn_model)
from apex_tpu_torch.parallel.LARC import LARC

__all__ = ["DistributedDataParallel", "flat_allreduce", "SyncBatchNorm",
           "convert_syncbn_model", "LARC"]
