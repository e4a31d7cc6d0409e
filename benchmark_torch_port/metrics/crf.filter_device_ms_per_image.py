"""The card's ms an image in the CRF's separable filter: the device time of
the traced pass's K4 kernels (``crf_filter`` in their names,
``em_adapt_torch/csrc/crf_filter.cu``) over the traced pass's images, as
``crf.refine_device_ms_per_image`` counts them. None where the pass ran
no such kernel."""

import harness
import spans


def read(r: dict):
    trace = r.get("trace")
    if r.get("kind") != "eval" or not trace:
        return None
    seconds, launches = harness.kernel_time(trace, ("crf_filter",))
    entries = spans.eval_traced(r)
    images = sum(e["images"] for e in entries or ())
    if not launches or not images:
        return None
    return 1e3 * seconds / images
