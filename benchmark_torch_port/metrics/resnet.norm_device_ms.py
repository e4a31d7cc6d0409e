"""Device ms a step, forward and backward, in the elementwise kernels of
DeepLab-v2 ResNet-101's training step (PyTorch's ``elementwise_kernel``
family, from the traced span): the frozen BN's shift, the ReLUs, the
residual adds and their gradients. The GEMMs, cuDNN's layout conversions,
K1 and the reductions are left out. The step's other elementwise kernels
(the uint8 input's normalize, the folded weights' scaling and casts, the
loss's, the weight decay's) are in it: about 2.4 GB a step, 7% of the
path's least bytes at 321x321 and batch 30 (``work_r101.py``).
Read in the ResNet cell only (``model`` in the records)."""

import harness

NAME = "deeplab_v2_resnet101"
PATTERNS = ("elementwise_kernel",)
EXCLUDE = ("nchwToNhwc", "nhwcToNchw", "estep_", "block1_", "gemm", "xmma", "reduce_kernel")


def kernels(r: dict) -> tuple[float, int] | None:
    """(seconds, launches) of those kernels over the traced span; None
    where there is nothing to read."""
    trace = r.get("trace")
    if r.get("kind") != "train" or r.get("model") != NAME or not trace:
        return None
    seconds, launches = harness.kernel_time(trace, PATTERNS, EXCLUDE)
    return (seconds, launches) if launches else None


def read(r: dict):
    found = kernels(r)
    return None if found is None else 1e3 * found[0] / r["trace_steps"]
