"""TF1-legacy image resizes (align_corners=False, no half-pixel centers), NHWC.

TF1 maps output index i to source coordinate ``i * (in/out)`` computed in
float32. The grids are built in numpy float32 (an on-device division
could round differently), so the nearest resize, which feeds the E-step's
tags, is bit-exact (reference deeplab.py:110, network.py:40).
"""

from __future__ import annotations

import numpy as np
import torch


def _src_coords(out_size: int, in_size: int) -> np.ndarray:
    scale = np.float32(in_size) / np.float32(out_size)
    return np.arange(out_size, dtype=np.float32) * scale


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(idx.astype(np.int64), device=device)


def resize_nearest_tf(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """TF1 resize_nearest_neighbor for NHWC or HWC:
    out[i] = in[min(floor(i * in/out), in-1)] per spatial axis."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    _, in_h, in_w, _ = x.shape
    out_h, out_w = size
    ys = np.minimum(np.floor(_src_coords(out_h, in_h)).astype(np.int64), in_h - 1)
    xs = np.minimum(np.floor(_src_coords(out_w, in_w)).astype(np.int64), in_w - 1)
    out = x.index_select(1, _index(ys, x.device)).index_select(2, _index(xs, x.device))
    return out[0] if squeeze else out


def resize_bilinear_tf(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """TF1 resize_bilinear for NHWC or HWC, float32 out: per axis src = i *
    (in/out), lo = floor(src), hi = min(lo+1, in-1), weight = src - lo;
    lerp x first, then y (TF's kernel order)."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    _, in_h, in_w, _ = x.shape
    out_h, out_w = size
    x = x.to(torch.float32)

    def axis(out_size, in_size):
        src = _src_coords(out_size, in_size)
        lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
        hi = np.minimum(lo + 1, in_size - 1)
        t = (src - lo.astype(np.float32)).astype(np.float32)
        return _index(lo, x.device), _index(hi, x.device), torch.as_tensor(t, device=x.device)

    y_lo, y_hi, ty = axis(out_h, in_h)
    x_lo, x_hi, tx = axis(out_w, in_w)
    top_rows, bot_rows = x.index_select(1, y_lo), x.index_select(1, y_hi)
    tl, tr = top_rows.index_select(2, x_lo), top_rows.index_select(2, x_hi)
    bl, br = bot_rows.index_select(2, x_lo), bot_rows.index_select(2, x_hi)
    tx_ = tx[None, None, :, None]
    ty_ = ty[None, :, None, None]
    top = tl + (tr - tl) * tx_
    bot = bl + (br - bl) * tx_
    out = top + (bot - top) * ty_
    return out[0] if squeeze else out
