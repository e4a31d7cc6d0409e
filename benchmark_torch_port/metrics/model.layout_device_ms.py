"""Device ms a step in cuDNN's layout conversions (``nchwToNhwc`` and
``nhwcToNchw`` kernels), from the traced span."""

import harness


def read(r: dict):
    trace = r.get("trace")
    if r.get("kind") != "train" or not trace:
        return None
    seconds, launches = harness.kernel_time(trace, ("nchwToNhwc", "nhwcToNchw"))
    return 1e3 * seconds / r["trace_steps"] if launches else None
