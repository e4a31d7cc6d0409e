"""Fully connected CRF post-processing (mean-field inference) on the host.

The port's copy of ``em_adapt_tpu/eval/crf.py``. The reference's
hyperparameters (reference network.py:63): bilateral sxy=121, srgb=5,
compat=10; spatial sxy=3, compat=3; 10 iterations. Krähenbühl & Koltun
mean-field with a Potts compatibility:

    Q_l <- softmax( log U_l + sum_m compat_m * (k_m * Q)_l )

A positive coefficient on each label's own filtered mass: the Potts
penalty on the other labels' mass, compat * (S - (k*Q)_l), has a
label-independent S that cancels in the softmax. k_m*Q is Gaussian
filtering in (x, y) for the spatial kernel and in (x, y, r, g, b) for the
bilateral one: exactly (``exact``), on the native permutohedral lattice
(``permutohedral``), or on a bilateral grid sampled at one cell per
kernel std (``grid``). ``method="tpu"`` runs the grid algorithm on a
device (``eval/crf_device.py``).
"""

from __future__ import annotations

import numpy as np

from em_adapt_torch.config import EvalConfig

METHODS = ("auto", "permutohedral", "grid", "exact", "tpu")


def _gaussian_filter_xy(q: np.ndarray, sxy: float) -> np.ndarray:
    """Per-channel spatial Gaussian of q [H,W,C], normalized so that the
    kernel sums to 1 at the borders too (normalized convolution)."""
    from scipy import ndimage  # imported where it runs, as Pillow is

    num = ndimage.gaussian_filter(q, sigma=(sxy, sxy, 0), mode="constant")
    den = ndimage.gaussian_filter(
        np.ones(q.shape[:2] + (1,), np.float32), sigma=(sxy, sxy, 0), mode="constant")
    return num / np.maximum(den, 1e-8)


def _bilateral_grid_filter(q: np.ndarray, rgb: np.ndarray, sxy: float, srgb: float) -> np.ndarray:
    """Bilateral filtering of q [H,W,C] guided by rgb [H,W,3] uint8: splat
    into a 5-D grid (one cell per std on each axis), blur with a Gaussian
    of one cell (truncate 2), slice at the nearest cell, normalize by a
    homogeneous channel."""
    from scipy import ndimage

    h, w, c = q.shape
    rgb = rgb.astype(np.float32)
    ys = np.arange(h, dtype=np.float32) / sxy
    xs = np.arange(w, dtype=np.float32) / sxy
    yy = np.broadcast_to(ys[:, None], (h, w))
    xx = np.broadcast_to(xs[None, :], (h, w))
    col = rgb / srgb
    coords = [yy, xx, col[..., 0], col[..., 1], col[..., 2]]
    idx = [np.round(v).astype(np.int64) for v in coords]
    dims = [int(i.max()) + 1 for i in idx]
    flat = np.ravel_multi_index([i.reshape(-1) for i in idx], dims)
    size = int(np.prod(dims))
    grid = np.zeros((size, c + 1), np.float32)
    np.add.at(grid, flat, np.concatenate([q.reshape(-1, c), np.ones((h * w, 1), np.float32)], 1))
    grid = grid.reshape(*dims, c + 1)
    grid = ndimage.gaussian_filter(grid, sigma=(1, 1, 1, 1, 1, 0), mode="constant", truncate=2.0)
    sliced = grid.reshape(size, c + 1)[flat].reshape(h, w, c + 1)
    return sliced[..., :-1] / np.maximum(sliced[..., -1:], 1e-8)


def _exact_kernel_filter(q: np.ndarray, feats: np.ndarray, block: int = 1024) -> np.ndarray:
    """Brute-force O((HW)^2) normalized Gaussian filtering, the oracle:
    ``feats`` [H,W,D] already divided by their std, kernel
    exp(-0.5 ||f_i - f_j||^2), rows in blocks of ``block``."""
    h, w, c = q.shape
    n = h * w
    f = feats.reshape(n, -1).astype(np.float64)
    v = q.reshape(n, c).astype(np.float64)
    sq = (f * f).sum(-1)
    num = np.empty((n, c), np.float64)
    den = np.empty((n, 1), np.float64)
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        d2 = sq[i0:i1, None] + sq[None, :] - 2.0 * (f[i0:i1] @ f.T)
        ker = np.exp(-0.5 * np.maximum(d2, 0.0))
        num[i0:i1] = ker @ v
        den[i0:i1] = ker.sum(1, keepdims=True)
    return (num / den).reshape(h, w, c).astype(np.float32)


def _spatial_feats(h: int, w: int, sxy: float) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([yy / sxy, xx / sxy], axis=-1)


def _bilateral_feats(rgb: np.ndarray, sxy: float, srgb: float) -> np.ndarray:
    h, w = rgb.shape[:2]
    return np.concatenate([_spatial_feats(h, w, sxy), rgb.astype(np.float32) / srgb], axis=-1)


def dense_crf(
    probs: np.ndarray,
    rgb: np.ndarray,
    cfg: EvalConfig | None = None,
    *,
    num_iterations: int | None = None,
    method: str = "auto",
    device=None,
) -> np.ndarray:
    """Refine class probabilities [H,W,C] (softmax output; the unary is
    -log of it) guided by the uint8 image rgb [H,W,3] with mean-field
    dense-CRF inference. ``method``: "auto" (the lattice when it builds,
    else the grid), "permutohedral", "grid", "exact" (tiny images only),
    or "tpu": the grid algorithm on ``device`` (default: the card) through
    :func:`~em_adapt_torch.eval.crf_device.dense_crf_device`. Returns the
    refined [H,W,C] probabilities."""
    cfg = cfg or EvalConfig()
    if method not in METHODS:
        raise ValueError(f"method={method!r}: expected 'auto', 'permutohedral', 'grid', "
                         "'tpu' or 'exact'")
    if method == "tpu":
        from em_adapt_torch.eval.crf_device import dense_crf_device

        return dense_crf_device(probs, rgb, cfg, num_iterations=num_iterations, device=device)
    if method == "auto":
        from em_adapt_torch.eval.permutohedral import available

        method = "permutohedral" if available() else "grid"
    iters = cfg.crf_iterations if num_iterations is None else num_iterations
    probs = np.asarray(probs, np.float32)
    h, w, c = probs.shape
    log_unary = np.log(np.maximum(probs, 1e-8))
    q = probs
    if method == "exact":
        sp_feats = _spatial_feats(h, w, cfg.crf_g_sxy)
        bi_feats = _bilateral_feats(rgb, cfg.crf_bi_sxy, cfg.crf_bi_srgb)
    elif method == "permutohedral":
        from em_adapt_torch.eval.permutohedral import PermutohedralLattice

        # One lattice for every iteration: the features are fixed.
        lattice = PermutohedralLattice(
            _bilateral_feats(rgb, cfg.crf_bi_sxy, cfg.crf_bi_srgb).reshape(h * w, -1))
    try:
        for _ in range(iters):
            if method == "exact":
                sp = _exact_kernel_filter(q, sp_feats)
                bi = _exact_kernel_filter(q, bi_feats)
            elif method == "permutohedral":
                sp = _gaussian_filter_xy(q, cfg.crf_g_sxy)
                bi = lattice.filter(q.reshape(h * w, c)).reshape(h, w, c)
            else:
                sp = _gaussian_filter_xy(q, cfg.crf_g_sxy)
                bi = _bilateral_grid_filter(q, rgb, cfg.crf_bi_sxy, cfg.crf_bi_srgb)
            energy = log_unary + cfg.crf_g_compat * sp + cfg.crf_bi_compat * bi
            energy -= energy.max(-1, keepdims=True)
            e = np.exp(energy)
            q = e / e.sum(-1, keepdims=True)
    finally:
        if method == "permutohedral":  # a raising iteration must not leak the lattice
            lattice.close()
    return q
