"""Dense-CRF mean-field inference on a device, batched.

The counterpart of ``em_adapt_tpu/eval/crf_tpu.py``: the algorithm of the
host grid path (``eval/crf.py::dense_crf(method="grid")``) in stock
PyTorch on the tensors' device, the card in evaluation:

* spatial kernel: separable Gaussian filtering with zero padding (scipy's
  taps, truncate 4), normalized by the filtered validity mask, so that
  image borders and bucket padding behave like ``mode="constant"``
  filtering of the unpadded image;
* bilateral kernel: splat into a dense 5-D grid, one cell per kernel std,
  blur with a Gaussian of one cell (truncate 2) on each of the five
  axes, slice at the nearest cell, normalize by the homogeneous channel.
  The splat is ``index_put_(accumulate=True)``, which sums each cell's
  pixels in pixel order on the card too (it sorts the indices there):
  ``index_add_``'s atomic sums change a rerun's last bits there, and ten
  iterations grow that (3.0e-5 on the fault fixture, NVIDIA H100 80GB
  HBM3).

The taps, the grid geometry and the coordinate rounding are the host
path's, computed in numpy when called. The colour axes cover the whole
uint8 range, so one geometry serves every image of a bucket: cells beyond
an image's colours stay empty and, the blur being linear with zero
padding, change nothing. A masked pixel splats zero mass and adds nothing
to a valid pixel's update; its own output is garbage, to be cropped.

The images of a batch are refined together (the grid has a batch axis);
each image's output is the one it gets alone. The JAX package refines one
at a time only to avoid a TPU runtime fault (crf_tpu.py:226-233).

The separable filter (:func:`_filter1d`) is, on a CUDA tensor, one launch
of the hand-written kernel K4 (``csrc/crf_filter.cu``, built and loaded
at its first use) an axis, which reads each element once and writes it
once; on a CPU tensor it is :func:`_filter1d_plain`, the same sums in the
same order in stock PyTorch. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from em_adapt_torch.config import EvalConfig


def _gauss_taps(sigma: float, truncate: float) -> np.ndarray:
    """scipy.ndimage.gaussian_filter1d's kernel: radius int(truncate *
    sigma + 0.5), taps exp(-x^2 / (2 sigma^2)) normalized, float32."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * x * x / (float(sigma) ** 2))
    return (k / k.sum()).astype(np.float32)


#: K4 launches made by :func:`_filter1d` (plain runs not counted).
launches = 0


def _filter1d_plain(x: torch.Tensor, taps: np.ndarray, axis: int,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Zero-padded 1-D correlation of ``x`` with ``taps`` along ``axis``
    (``mode="constant"``), accumulated in place (into ``out`` where given):
    two tensors of x's size live at once, not a padded copy besides."""
    r = (taps.size - 1) // 2
    n = x.shape[axis]
    out = x * float(taps[r]) if out is None else torch.mul(x, float(taps[r]), out=out)
    for d in range(1, min(r, n - 1) + 1):
        # out[i] += taps[r - d] x[i - d] and taps[r + d] x[i + d]
        out.narrow(axis, d, n - d).add_(x.narrow(axis, 0, n - d), alpha=float(taps[r - d]))
        out.narrow(axis, 0, n - d).add_(x.narrow(axis, d, n - d), alpha=float(taps[r + d]))
    return out


def _lib() -> ctypes.CDLL:
    from em_adapt_torch.utils.build import load

    lib = load("crf_filter")
    if not getattr(lib, "_em_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.em_crf_filter_launch.argtypes = [p, p, ll, i, ll, p, i, p]
        lib.em_crf_filter_launch.restype = i
        lib.em_cuda_error_string.argtypes = [i]
        lib.em_cuda_error_string.restype = ctypes.c_char_p
        lib._em_typed = True
    return lib


@functools.lru_cache(maxsize=32)
def _taps_on(taps: bytes, device: torch.device) -> torch.Tensor:
    """The f32 taps as a tensor on ``device``, copied there once."""
    return torch.frombuffer(bytearray(taps), dtype=torch.float32).to(device)


def filter1d_kernel(x: torch.Tensor, taps: np.ndarray, axis: int,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`_filter1d_plain` of a contiguous f32 CUDA tensor in one launch
    of K4, into ``out`` (contiguous, x's shape, not x) where given."""
    if x.device.type != "cuda":
        raise ValueError(f"filter1d_kernel: unsupported device {x.device}")
    taps = np.ascontiguousarray(taps, np.float32)
    r = (taps.size - 1) // 2
    if taps.ndim != 1 or taps.size != 2 * r + 1:
        raise ValueError(f"filter1d_kernel: taps must be odd in number, got {taps.shape}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"filter1d_kernel: x must be contiguous float32, got {x.dtype} "
                         f"with strides {x.stride()}")
    if out is None:
        out = torch.empty_like(x)
    elif (out.device != x.device or out.dtype != x.dtype or out.shape != x.shape
          or not out.is_contiguous() or out.data_ptr() == x.data_ptr()):
        raise ValueError("filter1d_kernel: out must be a contiguous float32 tensor of x's "
                         "shape on its device, other than x")
    lib = _lib()
    axis = axis % x.dim()
    shape = x.shape
    outer, inner = math.prod(shape[:axis]), math.prod(shape[axis + 1:])
    dev_taps = _taps_on(taps.tobytes(), x.device)
    with torch.cuda.device(x.device):
        err = lib.em_crf_filter_launch(x.data_ptr(), out.data_ptr(), outer, shape[axis], inner,
                                       dev_taps.data_ptr(), r,
                                       torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"crf filter kernel launch failed: "
                           f"{lib.em_cuda_error_string(err).decode()} ({err})")
    global launches
    launches += 1
    return out


def _filter1d(x: torch.Tensor, taps: np.ndarray, axis: int,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """Zero-padded 1-D correlation of ``x`` with ``taps`` along ``axis``
    (``mode="constant"``), into ``out`` where given: K4 on a CUDA tensor,
    the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return _filter1d_plain(x, taps, axis, out)
    return filter1d_kernel(x, taps, axis, out)


def _spatial_filter(q: torch.Tensor, mask: torch.Tensor, taps: np.ndarray,
                    den: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized spatial Gaussian of q [B,H,W,C] restricted to mask
    [B,H,W,1]: with mask 1 everywhere ``crf.py::_gaussian_filter_xy``, and
    with bucket padding the filtering of the unpadded image. ``den`` (the
    filtered mask) may be computed once by the caller."""
    num = _filter1d(_filter1d(q * mask, taps, 1), taps, 2)
    if den is None:
        den = _filter1d(_filter1d(mask, taps, 1), taps, 2)
    return num / den.clamp_min(1e-8)


@functools.lru_cache(maxsize=None)
def _grid_geometry(h: int, w: int, sxy: float, srgb: float):
    """(gy, gx, gc, spatial flat index [H*W] int64) of an HxW image's
    bilateral grid: the host path's float32 divide and round-half-even, the
    colour axes over the whole uint8 range. Raises where the grid would
    need more than int32 indices, as the JAX package does."""
    iy = np.round(np.arange(h, dtype=np.float32) / np.float32(sxy)).astype(np.int64)
    ix = np.round(np.arange(w, dtype=np.float32) / np.float32(sxy)).astype(np.int64)
    gy, gx = int(iy.max()) + 1, int(ix.max()) + 1
    gc = int(np.round(np.float32(255.0) / np.float32(srgb))) + 1
    size = gy * gx * gc ** 3
    if size >= 2 ** 31:
        raise ValueError(
            f"bilateral grid has {size} cells (image {h}x{w}, sxy={sxy}, srgb={srgb}) — "
            "exceeds int32 indexing; raise srgb/sxy or use the host CRF")
    # flat index = ((((iy * gx + ix) * gc + ir) * gc + ig) * gc + ib
    spatial = (iy[:, None] * gx + ix[None, :]) * gc ** 3
    return gy, gx, gc, spatial.reshape(-1)


def grid_cells(h: int, w: int, cfg: EvalConfig | None = None) -> int:
    """Cells of the bilateral grid of an HxW image (or bucket)."""
    cfg = cfg or EvalConfig()
    gy, gx, gc, _ = _grid_geometry(h, w, float(cfg.crf_bi_sxy), float(cfg.crf_bi_srgb))
    return gy * gx * gc ** 3


def _bilateral_flat_index(rgb: torch.Tensor, *, sxy: float, srgb: float):
    """Each pixel's cell [B*H*W] int64 in a grid with a batch axis (image b
    owns cells b*size .. (b+1)*size-1) from the uint8 guide rgb [B,H,W,3],
    and the grid's shape (B, gy, gx, gc, gc, gc). Iteration-invariant: the
    loop computes it once."""
    b, h, w = rgb.shape[:3]
    gy, gx, gc, spatial = _grid_geometry(h, w, float(sxy), float(srgb))
    size = gy * gx * gc ** 3
    ci = torch.round(rgb.to(torch.float32) / float(srgb)).to(torch.int64)
    color = ((ci[..., 0] * gc + ci[..., 1]) * gc + ci[..., 2]).reshape(b, h * w)
    base = torch.from_numpy(spatial).to(rgb.device)[None, :]
    batch = torch.arange(b, device=rgb.device, dtype=torch.int64)[:, None] * size
    return (b, gy, gx, gc, gc, gc), (color + base + batch).reshape(-1)


def _splat_blur_slice(q: torch.Tensor, mask: torch.Tensor, flat: torch.Tensor,
                      grid_shape: tuple[int, ...], taps: np.ndarray) -> torch.Tensor:
    """Bilateral filtering of q [B,H,W,C] weighted by mask [B,H,W,1] on the
    grid of :func:`_bilateral_flat_index`: splat, blur, slice, normalize."""
    b, h, w, c = q.shape
    cells = int(np.prod(grid_shape))
    vals = torch.cat([q * mask, mask], dim=-1).reshape(-1, c + 1)
    grid = torch.zeros(cells, c + 1, dtype=torch.float32, device=q.device)
    grid.index_put_((flat,), vals, accumulate=True)
    grid = grid.view(*grid_shape, c + 1)
    spare = torch.empty_like(grid)  # the two buffers take turns over the five axes
    for axis in range(1, 6):
        grid, spare = _filter1d(grid, taps, axis, out=spare), grid
    del spare  # one grid, not two, while the slice allocates
    sliced = grid.reshape(cells, c + 1).index_select(0, flat).reshape(b, h, w, c + 1)
    return sliced[..., :c] / sliced[..., c:].clamp_min(1e-8)


def crf_refine(probs: torch.Tensor, rgb: torch.Tensor, mask: torch.Tensor, *, bi_sxy: float,
               bi_srgb: float, bi_compat: float, g_sxy: float, g_compat: float,
               iterations: int) -> torch.Tensor:
    """Mean-field dense-CRF of probs [B,H,W,C] guided by rgb [B,H,W,3]
    uint8 on mask [B,H,W] (1 on valid pixels), on their device: the update
    of ``crf.py::dense_crf``. Returns the refined [B,H,W,C] f32."""
    probs = probs.to(torch.float32)
    mask = mask.to(torch.float32)[..., None]
    sp_taps = _gauss_taps(g_sxy, truncate=4.0)  # scipy's default truncate
    bl_taps = _gauss_taps(1.0, truncate=2.0)  # the grid blur: one cell
    log_unary = probs.clamp_min(1e-8).log()
    grid_shape, flat = _bilateral_flat_index(rgb, sxy=bi_sxy, srgb=bi_srgb)
    sp_den = _filter1d(_filter1d(mask, sp_taps, 1), sp_taps, 2)
    q = probs
    for _ in range(iterations):
        sp = _spatial_filter(q, mask, sp_taps, den=sp_den)
        bi = _splat_blur_slice(q, mask, flat, grid_shape, bl_taps)
        energy = log_unary + g_compat * sp + bi_compat * bi
        energy = energy - energy.amax(-1, keepdim=True)
        e = energy.exp()
        q = e / e.sum(-1, keepdim=True)
    return q


def make_crf_device(cfg: EvalConfig | None = None, *, num_iterations: int | None = None,
                    device=None):
    """The batched CRF ``fn(probs [B,H,W,C] f32, rgb [B,H,W,3] uint8,
    mask [B,H,W]) -> refined [B,H,W,C]`` on ``device`` (default: the
    card; arrays and tensors are moved there). Pad images to one bucket
    and mask the padding; crop the outputs."""
    from em_adapt_torch.device import resolve_device

    cfg = cfg or EvalConfig()
    dev = resolve_device(device)
    kw = dict(bi_sxy=float(cfg.crf_bi_sxy), bi_srgb=float(cfg.crf_bi_srgb),
              bi_compat=float(cfg.crf_bi_compat), g_sxy=float(cfg.crf_g_sxy),
              g_compat=float(cfg.crf_g_compat),
              iterations=int(cfg.crf_iterations if num_iterations is None else num_iterations))

    def fn(probs, rgb, mask) -> torch.Tensor:
        probs, rgb, mask = (torch.as_tensor(a).to(dev) for a in (probs, rgb, mask))
        return crf_refine(probs, rgb, mask, **kw)

    return fn


@torch.no_grad()
def dense_crf_device(probs: np.ndarray, rgb: np.ndarray, cfg: EvalConfig | None = None, *,
                     num_iterations: int | None = None, mask: np.ndarray | None = None,
                     device=None) -> np.ndarray:
    """One image through :func:`make_crf_device`: probs [H,W,C], rgb
    [H,W,3] uint8, optional mask [H,W]; the refined [H,W,C] as numpy."""
    probs = np.asarray(probs, np.float32)
    if mask is None:
        mask = np.ones(probs.shape[:2], np.float32)
    fn = make_crf_device(cfg, num_iterations=num_iterations, device=device)
    out = fn(probs[None], np.asarray(rgb, np.uint8)[None], np.asarray(mask, np.float32)[None])
    return out[0].cpu().numpy()
