"""The E-step calibration and the training trace: the counterparts of
``em_adapt_tpu/utils/profiling.py``'s ``measure_estep_us_per_image`` and
``trace_context``.

:func:`measure_estep_us_per_image` times the deployed E-step
(``ops/estep.py::estep_labels``, K1 on a CUDA card) once at train start
at the run's score-map shape; the ``train`` command stamps the result into
every train record as ``estep_us_per_image_calib``. :func:`trace_steps` is
``train --profile-dir``: a torch.profiler trace of the first steps.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings

import torch

from em_adapt_torch.config import EStepConfig, ModelConfig
from em_adapt_torch.ops.estep import estep_labels, make_class_orders
from em_adapt_torch.utils.timing import cuda_ms_per_launch


def measure_estep_us_per_image(model_cfg: ModelConfig, estep_cfg: EStepConfig, batch_size: int,
                               device, *, iters: int = 100, reps: int = 5,
                               warmup: int = 2) -> float:
    """µs per image of ``estep_labels`` on random scores [B, ceil(H/8),
    ceil(W/8), C] and labels (seed 0) on ``device``: on a CUDA card the
    median over ``reps`` runs of ``iters`` back-to-back calls between CUDA
    events (``utils/timing.py::cuda_ms_per_launch``), on the CPU the host
    clock over ``iters`` calls. Its K1 launches are counted as any are."""
    device = torch.device(device)
    h, w = (-(-s // 8) for s in model_cfg.input_size)
    c = model_cfg.num_classes
    g = torch.Generator().manual_seed(0)
    scores = torch.randn(batch_size, h, w, c, generator=g).to(device)
    label = torch.randint(0, c, (batch_size, h, w), generator=g).to(torch.float32).to(device)
    orders = make_class_orders(g, estep_cfg.num_iter, c).to(device)

    def run():
        return estep_labels(scores, label, orders, estep_cfg)

    if device.type == "cuda":
        ms = cuda_ms_per_launch(run, launches=iters, reps=reps, warmup=warmup)
    else:
        for _ in range(warmup):
            run()
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        ms = (time.perf_counter() - t0) * 1e3 / iters
    return ms * 1e3 / batch_size


#: Steps that ``train --profile-dir`` traces, from the first.
TRACE_STEPS = 5


@contextlib.contextmanager
def trace_steps(logdir: str | None, device):
    """A torch.profiler trace of the first :data:`TRACE_STEPS` training steps,
    written to ``logdir`` as a Chrome trace (``*.pt.trace.json``,
    TensorBoard's profile plugin and Perfetto read it) when they are done
    or the region ends, whichever is first. Yields the hook that
    ``Trainer.fit(step_hook=...)`` calls after each step, or None when
    ``logdir`` is None (no profiler). Host activity is traced, and the
    card's when ``device`` is a CUDA device. The JAX package traces the
    whole ``fit``; a torch.profiler trace of a long run would not fit in
    memory."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with warnings.catch_warnings():  # "won't be using warmup": step 0 is wanted in the trace
        warnings.filterwarnings("ignore", message="Profiler won't be using warmup")
        prof = profile(activities=activities,
                       schedule=schedule(wait=0, warmup=0, active=TRACE_STEPS, repeat=1),
                       on_trace_ready=tensorboard_trace_handler(logdir))
    with prof:
        yield prof.step
