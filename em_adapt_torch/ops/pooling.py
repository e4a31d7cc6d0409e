"""TF-SAME max pooling, NCHW.

3x3 SAME windows, stride 2 after blocks 1-3 (ceil mode: 321 -> 161 -> 81
-> 41) and stride 1 after blocks 4-5 (reference deeplab.py:73-83). TF's
SAME rule: out = ceil(in / stride), pad_total = max((out-1)*stride + k -
in, 0), the extra element on the high side, padding at -inf.

Gradient on tied windows: PyTorch's max-pool backward routes each window's
gradient to the first row-major maximum it finds, the same element XLA's
SelectAndScatter picks (ops/block1_pallas.py:46-53).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _same_pool_padding(n: int, window: int, stride: int) -> tuple[int, int]:
    out = -(-n // stride)
    total = max((out - 1) * stride + window - n, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor, window: int = 3, stride: int = 1,
                  h_pad: tuple[int, int] | None = None) -> torch.Tensor:
    """[B,C,H,W] max pool, ``window`` x ``window`` SAME, like tf.nn.max_pool.
    ``h_pad`` (top, bottom) replaces the SAME padding of H (a row strip
    with its halo, ``parallel/spatial.py``)."""
    top, bottom = h_pad if h_pad is not None else _same_pool_padding(x.shape[-2], window, stride)
    left, right = _same_pool_padding(x.shape[-1], window, stride)
    if top == bottom and left == right and max(top, left) <= window // 2:
        # The pool's own padding is -inf and needs no padded copy.
        return F.max_pool2d(x, window, stride, padding=(top, left))
    x = F.pad(x, (left, right, top, bottom), value=-float("inf"))
    return F.max_pool2d(x, window, stride)
