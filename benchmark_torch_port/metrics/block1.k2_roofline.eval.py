"""Block 1's forward at inference against its roofline, in %: the work of
``work.block1_fwd`` at the eval batch over the mean device time of a
launch of K2 (``block1_fwd_kernel``) in the traced span."""

import harness
import work


def read(r: dict):
    trace = r.get("trace")
    if r.get("kind") != "eval" or not trace:
        return None
    seconds, launches = harness.kernel_time(trace, ("block1_fwd_kernel",))
    if not launches:
        return None
    h, w = r["input_size"]
    return work.roofline_percent(work.block1_fwd(h, w, r["batch"])["bound_s"], seconds / launches)
