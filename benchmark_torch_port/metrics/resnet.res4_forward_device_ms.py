"""The card's ms a step of res4's forward kernels: the device work launched
inside the ``resnet.res4`` span (``em_adapt_torch/models/resnet.py``:
res4's 23 bottlenecks, 57% of the forward's FLOP), matched to the span by
the trace's correlation ids (``trace_ranges.range_device_s``), over the
traced span's steps. Unlike the span's CUDA event pair it leaves out the
card's idle inside the stage. None where the trace holds no such span: a
network without it, or a checkout without it."""


def read(r: dict):
    trace = r.get("trace") or {}
    seconds = trace.get("range_device_s", {}).get("resnet.res4")
    return 1e3 * seconds / r["trace_steps"] if seconds and r.get("trace_steps") else None
