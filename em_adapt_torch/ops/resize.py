"""TF1-legacy image resizes (align_corners=False, no half-pixel centers), NHWC.

TF1 maps output index i to source coordinate ``i * (in/out)`` computed in
float32. The grids are built in numpy float32 (an on-device division
could round differently), so the nearest resize, which feeds the E-step's
tags, is bit-exact (reference deeplab.py:110, network.py:40). A grid is
copied to its device once per (sizes, device), from pinned memory without
waiting, and kept: a copy from pageable memory each call would make every
training step wait for the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _src_coords(out_size: int, in_size: int) -> np.ndarray:
    scale = np.float32(in_size) / np.float32(out_size)
    return np.arange(out_size, dtype=np.float32) * scale


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _index(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    return _to_device(idx.astype(np.int64), device)


@functools.lru_cache(maxsize=64)
def _nearest_grid(out_size: int, in_size: int, device: torch.device) -> torch.Tensor:
    return _index(np.minimum(np.floor(_src_coords(out_size, in_size)), in_size - 1), device)


def bilinear_grid_np(out_size: int, in_size: int):
    """(lo, hi, weight) of one axis in numpy: lo = floor(src), hi =
    min(lo+1, in-1), weight = src - lo (float32)."""
    src = _src_coords(out_size, in_size)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo.astype(np.float32)).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _bilinear_grid(out_size: int, in_size: int, device: torch.device):
    lo, hi, t = bilinear_grid_np(out_size, in_size)
    return _index(lo, device), _index(hi, device), _to_device(t, device)


def resize_nearest_tf(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """TF1 resize_nearest_neighbor for NHWC or HWC:
    out[i] = in[min(floor(i * in/out), in-1)] per spatial axis."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    _, in_h, in_w, _ = x.shape
    out_h, out_w = size
    out = x.index_select(1, _nearest_grid(out_h, in_h, x.device))
    out = out.index_select(2, _nearest_grid(out_w, in_w, x.device))
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
    y_lo, y_hi, ty = _bilinear_grid(out_h, in_h, x.device)
    x_lo, x_hi, tx = _bilinear_grid(out_w, in_w, x.device)
    top_rows, bot_rows = x.index_select(1, y_lo), x.index_select(1, y_hi)
    tl, tr = top_rows.index_select(2, x_lo), top_rows.index_select(2, x_hi)
    bl, br = bot_rows.index_select(2, x_lo), bot_rows.index_select(2, x_hi)
    tx_ = tx[None, None, :, None]
    ty_ = ty[None, :, None, None]
    top = tl + (tr - tl) * tx_
    bot = bl + (br - bl) * tx_
    out = top + (bot - top) * ty_
    return out[0] if squeeze else out


def resize_bilinear_tf_padded(x: torch.Tensor, sizes, bucket: tuple[int, int]) -> torch.Tensor:
    """TF1 bilinear upsample of each image of x [B,H,W,C] to its own size
    ``sizes[b]`` = (oh, ow), padded into one ``bucket`` (BH, BW): the
    result [B,BH,BW,C] f32 holds image b's resize in its top-left
    (oh, ow) and garbage beyond, to be masked. Each grid is computed in
    numpy (the host resize's, ``data/augment.py::resize_bilinear_np``, to
    the bit); the corner gather and the x-then-y lerp are TF's."""
    n, in_h, in_w, _ = x.shape
    bh, bw = bucket
    y_lo, y_hi, x_lo, x_hi = (np.zeros((n, m), np.int64) for m in (bh, bh, bw, bw))
    ty, tx = np.zeros((n, bh), np.float32), np.zeros((n, bw), np.float32)
    for i, (oh, ow) in enumerate(sizes):
        if oh > bh or ow > bw:
            raise ValueError(f"size {oh}x{ow} exceeds the bucket {bh}x{bw}")
        y_lo[i, :oh], y_hi[i, :oh], ty[i, :oh] = bilinear_grid_np(oh, in_h)
        x_lo[i, :ow], x_hi[i, :ow], tx[i, :ow] = bilinear_grid_np(ow, in_w)
    y_lo, y_hi, x_lo, x_hi, ty, tx = (_to_device(a, x.device)
                                      for a in (y_lo, y_hi, x_lo, x_hi, ty, tx))
    x = x.to(torch.float32)
    b = torch.arange(n, device=x.device)[:, None, None]
    tl, tr = x[b, y_lo[:, :, None], x_lo[:, None, :]], x[b, y_lo[:, :, None], x_hi[:, None, :]]
    bl, br = x[b, y_hi[:, :, None], x_lo[:, None, :]], x[b, y_hi[:, :, None], x_hi[:, None, :]]
    tx_, ty_ = tx[:, None, :, None], ty[:, :, None, None]
    top = tl + (tr - tl) * tx_
    bot = bl + (br - bl) * tx_
    return top + (bot - top) * ty_
