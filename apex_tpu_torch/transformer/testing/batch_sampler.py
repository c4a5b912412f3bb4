"""Megatron-style pretraining batch samplers (reference:
``apex/transformer/testing`` batch samplers exercised by
``tests/L0/run_transformer/test_batch_sampler.py`` — sequential and
random samplers that shard each global batch across data-parallel
ranks).

Framework-agnostic: they yield lists of integer dataset indices, so they
drive a torch ``DataLoader`` (via ``batch_sampler=``) or a jax input
pipeline equally.  Megatron semantics are kept: iteration resumes from
``consumed_samples``, each rank takes a contiguous ``micro_batch_size``
slice of the global batch, and the random variant reshuffles per epoch
with the epoch folded into the seed.
"""
from __future__ import annotations

__all__ = ["MegatronPretrainingSampler", "MegatronPretrainingRandomSampler"]


class _Base:
    def __init__(self, total_samples: int, consumed_samples: int,
                 micro_batch_size: int, data_parallel_rank: int,
                 data_parallel_size: int, drop_last: bool = True):
        if total_samples <= 0:
            raise RuntimeError(
                f"no sample to consume: {total_samples}")
        if micro_batch_size <= 0:
            raise RuntimeError(
                f"micro_batch_size size must be greater than 0, but "
                f"{micro_batch_size}")
        if data_parallel_size <= 0:
            raise RuntimeError(
                f"data parallel size must be greater than 0, but "
                f"{data_parallel_size}")
        if data_parallel_rank >= data_parallel_size:
            raise RuntimeError(
                f"data_parallel_rank should be smaller than data parallel "
                f"size: {data_parallel_rank} >= {data_parallel_size}")
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size)
        self.drop_last = drop_last

    def __len__(self):
        return self.total_samples


class MegatronPretrainingSampler(_Base):
    """Sequential sharded sampler: global batch ``[i, i+mbs*dp)``, this
    rank takes slice ``[rank*mbs, (rank+1)*mbs)`` of it.  Single-epoch:
    ``consumed_samples`` must leave something to consume (the random
    variant instead wraps into a reshuffled next epoch)."""

    def __init__(self, total_samples, consumed_samples, *args, **kwargs):
        if consumed_samples >= total_samples:
            raise RuntimeError(
                f"no samples left to consume: {consumed_samples} >= "
                f"{total_samples}")
        super().__init__(total_samples, consumed_samples, *args, **kwargs)

    def get_start_end_idx(self):
        start = self.data_parallel_rank * self.micro_batch_size
        return start, start + self.micro_batch_size

    def __iter__(self):
        batch = []
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.micro_batch_times_data_parallel_size:
                s, e = self.get_start_end_idx()
                yield batch[s:e]
                batch = []
        if batch and not self.drop_last:
            # split the remainder PROPORTIONALLY so no rank gets an empty
            # micro-batch (an empty batch crashes collate and desyncs the
            # data-parallel step count)
            n, r, dp = len(batch), self.data_parallel_rank, \
                self.data_parallel_size
            yield batch[r * n // dp:(r + 1) * n // dp]


class MegatronPretrainingRandomSampler(_Base):
    """Per-epoch shuffled variant: the epoch index is folded into the
    seed so every rank draws the SAME permutation, then each rank strides
    off its own micro-batches (always drops the last partial batch)."""

    def __init__(self, *args, seed: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.seed = seed
        self.last_batch_size = (
            self.total_samples % self.micro_batch_times_data_parallel_size)
        if self.total_samples < self.micro_batch_times_data_parallel_size:
            raise RuntimeError(
                f"random sampler needs at least one full global batch: "
                f"{self.total_samples} < "
                f"{self.micro_batch_times_data_parallel_size}")

    def __iter__(self):
        import numpy as np

        active_total_samples = self.total_samples - self.last_batch_size
        self.epoch = self.consumed_samples // active_total_samples
        current_epoch_samples = self.consumed_samples % active_total_samples
        assert current_epoch_samples % \
            self.micro_batch_times_data_parallel_size == 0

        g = np.random.RandomState(self.seed + self.epoch)
        # shuffle whole-bucket order like Megatron: the permutation covers
        # this rank's bucket of the active samples
        bucket_size = (active_total_samples //
                       self.micro_batch_times_data_parallel_size) \
            * self.micro_batch_size
        bucket_offset = current_epoch_samples // self.data_parallel_size
        start_idx = self.data_parallel_rank * bucket_size
        random_idx = g.permutation(bucket_size).tolist()
        idx_range = [start_idx + x for x in random_idx[bucket_offset:]]

        batch = []
        for idx in idx_range:
            batch.append(idx)
            if len(batch) == self.micro_batch_size:
                self.consumed_samples += (
                    self.micro_batch_times_data_parallel_size)
                yield batch
                batch = []
