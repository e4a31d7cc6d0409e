"""Device ms a step in the convolutions' GEMM kernels (cuDNN's forward,
data- and weight-gradient kernels), from the traced span; the fused block
1's kernels and the layout conversions are not counted."""

import harness

PATTERNS = ("xmma", "implicit_gemm", "fprop", "dgrad", "wgrad", "gemm", "cutlass", "conv2d",
            "convolve", "Conv")
EXCLUDE = ("block1_", "estep_", "nchwToNhwc", "nhwcToNchw", "elementwise", "reduce_kernel")


def read(r: dict):
    trace = r.get("trace")
    if r.get("kind") != "train" or not trace:
        return None
    seconds, launches = harness.kernel_time(trace, PATTERNS, EXCLUDE)
    return 1e3 * seconds / r["trace_steps"] if launches else None
