"""The E-step against its roofline, in %: K1's bytes (``work.estep``) at
the step's batch and score map over the mean device time of a launch of
K1 (``estep_kernel``) in the traced span."""

import harness
import work


def read(r: dict):
    trace = r.get("trace")
    if r.get("kind") != "train" or not trace:
        return None
    seconds, launches = harness.kernel_time(trace, ("estep_kernel",))
    if not launches:
        return None
    sh, sw = work.score_map_size(*r["input_size"])
    bound = work.estep(r["batch"], sh * sw, r["num_classes"])["bound_s"]
    return work.roofline_percent(bound, seconds / launches)
