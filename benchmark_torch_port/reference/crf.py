"""The plain reference of the VOC protocol's post-process, in PyTorch.

Each image alone at its own size: TF1 bilinear resizes (align_corners
False, float32 source coordinates ``i * in/out``, the x lerp then the y
lerp), softmax, and the dense CRF's mean field (Krähenbühl & Koltun,
arXiv:1210.5644; the reference's hyperparameters, network.py:63:
bilateral sxy 121, srgb 5, compat 10; spatial sxy 3, compat 3; 10
iterations) with its bilateral kernel on a grid of one cell per kernel
std, blurred by a Gaussian of one cell (truncate 2) on its five axes,
and its spatial kernel a normalized separable Gaussian (truncate 4):

    Q <- softmax(log P + g_compat * (k_xy * Q) + bi_compat * (k_bi * Q))

Float32. It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

#: The Caffe mean, BGR.
BGR_MEAN = np.array([104.00698793, 116.66876762, 122.67891434], np.float32)


def _axis(out_size: int, in_size: int):
    src = np.arange(out_size, dtype=np.float32) * (np.float32(in_size) / np.float32(out_size))
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo.astype(np.float32)).astype(np.float32)


def resize_bilinear_np(x: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """TF1 bilinear resize of an HWC array, float32."""
    x = x.astype(np.float32)
    y_lo, y_hi, ty = _axis(size[0], x.shape[0])
    x_lo, x_hi, tx = _axis(size[1], x.shape[1])
    top = x[y_lo][:, x_lo] + (x[y_lo][:, x_hi] - x[y_lo][:, x_lo]) * tx[None, :, None]
    bot = x[y_hi][:, x_lo] + (x[y_hi][:, x_hi] - x[y_hi][:, x_lo]) * tx[None, :, None]
    return top + (bot - top) * ty[:, None, None]


def network_input(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """An RGB uint8 image as the network reads it in evaluation: resized to
    ``size``, BGR, minus the mean (HWC float32)."""
    return resize_bilinear_np(img, size)[..., ::-1] - BGR_MEAN


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """TF1 bilinear resize of an HWC tensor, float32."""
    x = x.to(torch.float32)
    y_lo, y_hi, ty = (torch.from_numpy(a).to(x.device) for a in _axis(size[0], x.shape[0]))
    x_lo, x_hi, tx = (torch.from_numpy(a).to(x.device) for a in _axis(size[1], x.shape[1]))
    t, b = x[y_lo], x[y_hi]
    top = t[:, x_lo] + (t[:, x_hi] - t[:, x_lo]) * tx[None, :, None]
    bot = b[:, x_lo] + (b[:, x_hi] - b[:, x_lo]) * tx[None, :, None]
    return top + (bot - top) * ty[:, None, None]


def gauss_taps(sigma: float, truncate: float) -> torch.Tensor:
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * x * x / float(sigma) ** 2)
    return torch.from_numpy((k / k.sum()).astype(np.float32))


def blur(x: torch.Tensor, taps: torch.Tensor, axis: int) -> torch.Tensor:
    """Zero-padded correlation of x with ``taps`` along ``axis`` (a 1-D
    convolution, which PyTorch computes as a correlation)."""
    r = (taps.numel() - 1) // 2
    moved = x.movedim(axis, -1)
    shape = moved.shape
    flat = moved.reshape(-1, 1, shape[-1])
    out = torch.nn.functional.conv1d(flat, taps.to(x.device)[None, None], padding=r)
    return out.reshape(shape).movedim(-1, axis)


def dense_crf(probs: torch.Tensor, rgb: torch.Tensor, *, bi_sxy: float = 121.0,
              bi_srgb: float = 5.0, bi_compat: float = 10.0, g_sxy: float = 3.0,
              g_compat: float = 3.0, iterations: int = 10,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Mean-field CRF of probs [H,W,C] guided by rgb [H,W,3] uint8; the
    refined [H,W,C] float32, computed in ``dtype`` (bfloat16 for the
    control of the post-process)."""
    h, w, c = probs.shape
    dev = probs.device
    probs = probs.to(dtype)
    sp = gauss_taps(g_sxy, 4.0).to(dtype)
    bl = gauss_taps(1.0, 2.0).to(dtype)
    ones = torch.ones(h, w, 1, device=dev, dtype=dtype)
    sp_den = blur(blur(ones, sp, 0), sp, 1)
    rnd = lambda v: torch.round(v).to(torch.int64)  # noqa: E731 (half to even, as numpy)
    iy = rnd(torch.arange(h, dtype=torch.float32, device=dev) / bi_sxy)
    ix = rnd(torch.arange(w, dtype=torch.float32, device=dev) / bi_sxy)
    col = rnd(rgb.to(torch.float32) / bi_srgb)
    gc = int(np.round(np.float32(255.0) / np.float32(bi_srgb))) + 1
    dims = (int(iy.max()) + 1, int(ix.max()) + 1, gc, gc, gc)
    cell = ((((iy[:, None] * dims[1] + ix[None, :]) * gc + col[..., 0]) * gc + col[..., 1]) * gc
            + col[..., 2]).reshape(-1)
    cells = int(np.prod(dims))
    log_unary = probs.clamp_min(1e-8).log()
    q = probs
    for _ in range(iterations):
        spatial = blur(blur(q, sp, 0), sp, 1) / sp_den.clamp_min(1e-8)
        grid = torch.zeros(cells, c + 1, device=dev, dtype=dtype)
        grid.index_add_(0, cell, torch.cat([q, ones], -1).reshape(-1, c + 1))
        grid = grid.view(*dims, c + 1)
        for axis in range(5):
            grid = blur(grid, bl, axis)
        sliced = grid.reshape(cells, c + 1)[cell].reshape(h, w, c + 1)
        bilateral = sliced[..., :c] / sliced[..., c:].clamp_min(1e-8)
        q = torch.softmax(log_unary + g_compat * spatial + bi_compat * bilateral, -1)
    return q.float()
