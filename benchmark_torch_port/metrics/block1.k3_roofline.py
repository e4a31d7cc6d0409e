"""Block 1's backward against its roofline, in %: the work of
``work.block1_bwd`` (no recompute) at the step's batch over the device
time of K3 (``block1_bwd_kernel`` and its ``block1_bwd_reduce``) per
launch in the traced span."""

import harness
import work


def read(r: dict):
    trace = r.get("trace")
    if r.get("kind") != "train" or not trace:
        return None
    _, launches = harness.kernel_time(trace, ("block1_bwd_kernel",))
    seconds, _ = harness.kernel_time(trace, ("block1_bwd_kernel", "block1_bwd_reduce"))
    if not launches:
        return None
    h, w = r["input_size"]
    return work.roofline_percent(work.block1_bwd(h, w, r["batch"])["bound_s"], seconds / launches)
