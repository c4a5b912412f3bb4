"""Microbatch calculators (reference: ``apex/transformer/microbatches.py``).

Host-side bookkeeping: number of microbatches per global batch, with
optional batch-size ramp-up.  Identical semantics; no device code.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional

__all__ = [
    "build_num_microbatches_calculator",
    "ConstantNumMicroBatches",
    "RampupBatchsizeNumMicroBatches",
]


def build_num_microbatches_calculator(
        rank: int,
        rampup_batch_size: Optional[list],
        global_batch_size: int,
        micro_batch_size: int,
        data_parallel_size: int):
    if rampup_batch_size is None:
        calculator = ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size)
        if rank == 0:
            print(f"setting number of micro-batches to constant "
                  f"{calculator.get()}", flush=True)
    else:
        assert len(rampup_batch_size) == 3, (
            "expected the following format: --rampup-batch-size <start batch "
            "size> <batch size increment> <ramp-up samples>")
        start, incr, ramp_samples = map(int, rampup_batch_size)
        if rank == 0:
            print(f"will use batch size rampup starting from global batch "
                  f"size {start} to global batch size {global_batch_size} "
                  f"with batch size increments {incr} over {ramp_samples} "
                  f"samples.", flush=True)
        calculator = RampupBatchsizeNumMicroBatches(
            start, incr, ramp_samples, global_batch_size, micro_batch_size,
            data_parallel_size)
    return calculator


class NumMicroBatchesCalculator(ABC):
    def __init__(self):
        self.num_micro_batches = None
        self.current_global_batch_size = None

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    @abstractmethod
    def update(self, consumed_samples, consistency_check):
        ...


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    def __init__(self, global_batch_size, micro_batch_size,
                 data_parallel_size):
        super().__init__()
        micro_batch_times_dp = micro_batch_size * data_parallel_size
        assert global_batch_size % micro_batch_times_dp == 0, (
            f"global batch size ({global_batch_size}) is not divisible by "
            f"micro batch size ({micro_batch_size}) times data parallel "
            f"size ({data_parallel_size})")
        self.num_micro_batches = global_batch_size // micro_batch_times_dp
        assert self.num_micro_batches >= 1
        self.current_global_batch_size = global_batch_size

    def update(self, consumed_samples, consistency_check):
        pass


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    def __init__(self, start_batch_size, batch_size_increment, ramup_samples,
                 global_batch_size, micro_batch_size, data_parallel_size):
        super().__init__()
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size)
        assert self.micro_batch_times_data_parallel_size > 0
        assert start_batch_size > 0
        self.start_batch_size = start_batch_size
        assert global_batch_size > 0
        self.global_batch_size = global_batch_size
        diff_batch_size = global_batch_size - start_batch_size
        assert diff_batch_size >= 0
        assert batch_size_increment > 0
        self.batch_size_increment = batch_size_increment
        assert diff_batch_size % batch_size_increment == 0, (
            f"expected gap between global batch size ({global_batch_size}) "
            f"and start batch size ({start_batch_size}) to be divisible by "
            f"batch size increment ({batch_size_increment})")
        num_increments = diff_batch_size // batch_size_increment
        assert num_increments > 0, (
            f"batch-size rampup requires global batch size "
            f"({global_batch_size}) > start batch size "
            f"({start_batch_size}); use ConstantNumMicroBatches otherwise")
        self.ramup_samples = ramup_samples
        assert self.ramup_samples >= 0
        self.rampup_samples_per_increment = (
            self.ramup_samples / num_increments)
        self.update(0, False)

    def update(self, consumed_samples, consistency_check):
        if consumed_samples > self.ramup_samples:
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples / self.rampup_samples_per_increment)
            self.current_global_batch_size = (
                self.start_batch_size + steps * self.batch_size_increment)
            assert self.current_global_batch_size <= self.global_batch_size
        if consistency_check:
            assert self.current_global_batch_size % \
                self.micro_batch_times_data_parallel_size == 0, (
                    "current global batch size is not divisible by "
                    "micro-batch-size times data-parallel-size")
        self.num_micro_batches = (
            self.current_global_batch_size //
            self.micro_batch_times_data_parallel_size)
