"""The training window of DeepLab-v2 ResNet-101: ``drivers/train.py``'s.

This file loads ``drivers/train.py`` as a module of its own and puts the
network's pieces in its place: the weights (``weights_r101.py``: every
conv from N(0, 0.01), and frozen BN statistics that the reference's
``calibrate`` sets from the pool's first batch), the work
(``work_r101.py``) and the plain reference (``reference/deeplab_v2.py``).
The window, its hooks, the traced span, the comparison and its readings
are ``drivers/train.py``'s own code, so this cell is timed and checked as
``train-321-fold30`` is. Two things are added around it:

* the trace's reduction also keeps, for each range of :data:`RANGES`, the
  device time of the work launched inside it (``trace_ranges.py``), and
  the run's readings give the stage event pairs' sum against the traced
  span's busy time, and res4's pair against its own kernels;
* a run whose training goes non-finite (``Trainer.fit``'s loss check)
  reads as not correct, every compared number infinite, instead of
  ending in the error.

A checkout whose port has no ``deeplab_v2_resnet101`` fails at once,
before any weight is made.
"""

from __future__ import annotations

import math
import types

import harness
import spans
import trace_ranges
import weights_r101
import work_r101
from reference import deeplab_v2

#: The host ranges (the model's stage spans) whose kernels the trace's
#: reduction keeps.
RANGES = ("resnet.res4",)
#: The training step's stage spans, whose event pairs the readings sum.
STEP_STAGES = ("step.forward", "step.estep", "step.loss", "step.backward", "step.optim")

base = harness.load_module("drivers/train.py")
base.weights_mod, base.work, base.ref = weights_r101, work_r101, deeplab_v2
_inputs = base.inputs


def inputs(ctx):
    """``drivers/train.py``'s inputs, the frozen statistics calibrated on
    the pool's first batch."""
    cfg, widths, params, pool, n_check = _inputs(ctx)
    weights_r101.calibrate(params, pool[0]["image"])
    return cfg, widths, params, pool, n_check


def read_trace(prof, window: str) -> dict:
    """``harness.read_trace``, and the device seconds of each range of
    :data:`RANGES` (``range_device_s``) over the span."""
    with trace_ranges.Saved(prof) as saved:
        out = harness.read_trace(saved, window)
        if out:
            out["range_device_s"] = {
                name: trace_ranges.range_device_s(saved.events, name, window) for name in RANGES}
    return out


base.inputs = inputs
base.harness = types.SimpleNamespace(**{**vars(harness), "read_trace": read_trace})


def pair_readings(records: dict) -> dict:
    """The traced span's stage event pairs against its device work: the
    step stages' pairs summed over the busy time, and res4's pair over
    its own kernels (a ratio above 1 is the card's idle inside the
    stage)."""
    trace, k = records.get("trace"), records.get("trace_steps")
    traced = spans.train_traced(records)
    if not trace or not k or traced is None:
        return {}
    out = {}
    stages = [spans.device_ms(traced, name) for name in STEP_STAGES]
    if None not in stages:
        out["stage_pairs_over_busy"] = sum(stages) * k / 1e3 / trace["busy_s"]
    res4_pair = spans.device_ms(traced, "resnet.res4")
    res4_own = trace.get("range_device_s", {}).get("resnet.res4")
    if res4_pair is not None and res4_own:
        out["res4_pair_ms"], out["res4_kernels_ms"] = res4_pair, 1e3 * res4_own / k
        out["res4_pair_over_kernels"] = res4_pair * k / 1e3 / res4_own
    return out


def diverged(ctx, reason: str) -> dict:
    """The result of a run whose training went non-finite: every compared
    number infinite, so the run reads as not correct."""
    import torch

    ctx.log(f"training went non-finite: {reason}")
    checks = [(name, math.inf, limit) for name, limit in ctx.limits.items()]
    cuda = ctx.device.type == "cuda"
    return {"e2e": {}, "attempted": 1, "failed": 1, "records": {"kind": "train", "trace": None},
            "checks": checks, "readings": {"diverged": reason, **{n: v for n, v, _ in checks}},
            "memory_peak_bytes": torch.cuda.max_memory_allocated(ctx.device) if cuda else 0}


def run(ctx) -> dict:
    from em_adapt_torch.models.registry import get_model

    name = ctx.config["model"]["name"]
    get_model(name)  # KeyError on a port without the network
    try:
        out = base.run(ctx)
    except RuntimeError as e:
        if "training unhealthy" not in str(e):
            raise
        return diverged(ctx, str(e))
    out["records"].update(model=name, width=ctx.experiment_config().model.width_multiplier)
    pairs = pair_readings(out["records"])
    if pairs:
        ctx.log("traced span: " + ", ".join(f"{k} {v:.4f}" for k, v in pairs.items()))
    out["readings"].update(pairs)
    return out


control_readings = base.control_readings
