"""The H100's peak rates and the CUDA-event timers that ``chip_smoke.py``
and ``tools/bench_block1_bwd_parts.py`` share.

A bound is the larger of the bytes a function must move over
:data:`HBM_BYTES_PER_S` and its operations over the peak of their type.
"""

from __future__ import annotations

import statistics

import torch

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; float32 operations/s
#: outside the tensor cores (K1's compares and adds, conv1_1's FMA); dense
#: bf16 tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
SIMT_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989.4e12


def cuda_ms(fn, reps: int, warmup: int) -> float:
    """Median milliseconds of one ``fn()`` call over ``reps`` calls, each
    between its own pair of CUDA events, after ``warmup`` calls. Host work
    inside ``fn`` counts whenever the device waits for it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_per_launch(fn, launches: int, reps: int, warmup: int) -> float:
    """Milliseconds per call of ``launches`` back-to-back ``fn()`` calls
    between one pair of CUDA events (median of ``reps`` such runs): the
    host queues ahead of the device, so its work per call is hidden."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)
