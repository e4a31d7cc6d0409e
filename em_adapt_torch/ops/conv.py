"""Convolution with TF-SAME semantics, NCHW activations and OIHW weights.

The reference uses ``tf.nn.conv2d(padding="SAME")`` and, for the conv5
block (rate 2) and fc6 (4x4 kernel, rate 4), ``tf.nn.atrous_conv2d``
(reference deeplab.py:58, :65, :92, :95). TF pads SAME for the effective
(dilated) kernel extent with the extra element on the high side; that is
what :func:`same_padding` computes. The product itself is PyTorch's
convolution (cuDNN on the card), as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def same_padding(k: int, rate: int = 1) -> tuple[int, int]:
    """(low, high) padding of a stride-1 TF SAME conv of kernel ``k``."""
    total = (k - 1) * rate
    return total // 2, total - total // 2


def conv2d_same(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    rate: int = 1,
    compute_dtype: torch.dtype | None = None,
    h_pad: tuple[int, int] | None = None,
    stride: int = 1,
) -> torch.Tensor:
    """Stride-1 SAME conv. x [B,Cin,H,W], w [Cout,Cin,kh,kw], atrous ``rate``.

    Symmetric padding goes to the convolution itself (no padded copy of
    the activation); an asymmetric one (an even kernel at an odd effective
    extent) is an explicit ``F.pad`` with the extra element high.

    ``compute_dtype`` (e.g. ``torch.bfloat16``) follows the JAX package's
    bf16 semantics (``em_adapt_tpu/ops/conv.py:45-68``): x and w are cast,
    the conv output is rounded to x's incoming dtype, then the bias,
    rounded to that dtype, is added in it. The bias stays out of
    ``F.conv2d``, where cuDNN would add it in f32 before the rounding.

    ``h_pad`` (top, bottom) replaces the SAME padding of H: a row strip
    whose halo rows are already in ``x`` (``parallel/spatial.py``) pads
    only at the image's true edges.

    ``stride`` > 1 keeps the stride-1 padding and strides the product:
    Caffe's symmetric pad of (k-1)/2 for an odd kernel, ceil(H/stride)
    outputs (DeepLab-v2 ResNet's conv1 and res3a, ``models/resnet.py``),
    not TF's SAME rule for strided convolutions.
    """
    if compute_dtype is not None:
        orig = x.dtype
        y = conv2d_same(x.to(compute_dtype), w.to(compute_dtype), rate=rate,
                        h_pad=h_pad, stride=stride).to(orig)
        return y if b is None else y + b.to(orig)[:, None, None]
    (top, bottom), (left, right) = (same_padding(k, rate) for k in w.shape[2:])
    if h_pad is not None:
        top, bottom = h_pad
    if top == bottom and left == right:
        return F.conv2d(x, w, b, stride=stride, padding=(top, left), dilation=rate)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b, stride=stride, dilation=rate)
