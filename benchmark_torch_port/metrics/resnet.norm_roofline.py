"""The frozen-BN, ReLU and residual-add path against its roofline, in %:
the least bytes it moves in a step (``work_r101.norm``: each tensor read
or written once, forward and backward, bf16) over the device time of the
kernels ``resnet.norm_device_ms`` reads, a step."""

import harness
import work
import work_r101

_norm = harness.load_module("metrics/resnet.norm_device_ms.py")


def read(r: dict):
    found = _norm.kernels(r)
    if found is None:
        return None
    h, w = r["input_size"]
    bound = work_r101.norm(h, w, r["batch"], num_classes=r["num_classes"],
                           width=r.get("width", 1.0))["bound_s"]
    return work.roofline_percent(bound, found[0] / r["trace_steps"])
