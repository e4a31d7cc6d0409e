"""Host-side train augmentation and eval preprocessing, TF1-exact grids.

A numpy copy of ``em_adapt_tpu/data/augment.py`` (reference
dataset.py:147-199): random scale U(0.75, 1.25) with TF1's truncating
int32 cast, an unconditional resize to the input size, a shared-coin
left-right flip, then BGR + Caffe-mean (or the uint8 wire format, whose
normalization runs on the device: :func:`normalize_uint8`).
"""

from __future__ import annotations

import numpy as np

#: Caffe BGR channel means (reference dataset.py:15-18).
BGR_MEAN = np.array([104.00698793, 116.66876762, 122.67891434], np.float32)


def _finalize_wire(img, lab, wire_dtype: str):
    """``"uint8"``: clip(round(img)) raw-RGB uint8 + uint8 labels;
    ``"float32"``: BGR mean-subtracted f32 + f32 labels."""
    if wire_dtype == "uint8":
        out = np.ascontiguousarray(np.clip(np.round(img), 0, 255), np.uint8)
        return out, None if lab is None else np.ascontiguousarray(lab, np.uint8)
    out = np.ascontiguousarray(_bgr_mean_sub(img), np.float32)
    return out, None if lab is None else np.ascontiguousarray(lab, np.float32)


def normalize_uint8(x):
    """Device-side uint8 wire contract: raw RGB NHWC -> BGR minus the Caffe
    mean, float32 (reference dataset.py:175-177). Other dtypes pass."""
    import torch

    if x.dtype != torch.uint8:
        return x
    mean = torch.as_tensor(BGR_MEAN, device=x.device)
    return x.to(torch.float32).flip(-1) - mean


def _coords(out_size: int, in_size: int) -> np.ndarray:
    scale = np.float32(in_size) / np.float32(out_size)
    return np.arange(out_size, dtype=np.float32) * scale


def resize_nearest_np(x: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """TF1 resize_nearest_neighbor (align_corners=False), HWC or HW."""
    in_h, in_w = x.shape[:2]
    out_h, out_w = size
    ys = np.minimum(np.floor(_coords(out_h, in_h)).astype(np.int64), in_h - 1)
    xs = np.minimum(np.floor(_coords(out_w, in_w)).astype(np.int64), in_w - 1)
    return x[ys][:, xs]


def resize_bilinear_np(x: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """TF1 resize_bilinear (align_corners=False), HWC, float32 output,
    TF's corner gather and x-then-y lerp order."""
    in_h, in_w = x.shape[:2]
    out_h, out_w = size
    x = x.astype(np.float32)

    def axis(out_size, in_size):
        src = _coords(out_size, in_size)
        lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
        hi = np.minimum(lo + 1, in_size - 1)
        return lo, hi, (src - lo.astype(np.float32)).astype(np.float32)

    y_lo, y_hi, ty = axis(out_h, in_h)
    x_lo, x_hi, tx = axis(out_w, in_w)
    tl = x[y_lo][:, x_lo]
    tr = x[y_lo][:, x_hi]
    bl = x[y_hi][:, x_lo]
    br = x[y_hi][:, x_hi]
    tx_ = tx[None, :, None]
    ty_ = ty[:, None, None]
    top = tl + (tr - tl) * tx_
    bot = bl + (br - bl) * tx_
    return top + (bot - top) * ty_


def _bgr_mean_sub(img: np.ndarray) -> np.ndarray:
    """RGB float image -> BGR minus Caffe mean (reference dataset.py:175-177)."""
    return img[:, :, ::-1].astype(np.float32) - BGR_MEAN


def augment_train(
    img: np.ndarray,
    label: np.ndarray,
    rng: np.random.Generator,
    *,
    input_size: tuple[int, int] = (321, 321),
    scale_range: tuple[float, float] = (0.75, 1.25),
    random_scale: bool = True,
    flip: bool = True,
    wire_dtype: str = "float32",
) -> tuple[np.ndarray, np.ndarray]:
    """Train-time preprocessing of one (uint8 RGB HWC, uint8 HW) pair.

    Returns (image f32 [H,W,3] BGR mean-subtracted, label f32 [H,W,1]), or
    with ``wire_dtype="uint8"`` (image uint8 RGB, label uint8).
    """
    h, w = input_size
    lab = label[:, :, None] if label.ndim == 2 else label

    if random_scale:
        s = np.float32(rng.uniform(*scale_range))
        # TF computes int32(float(shape) * scale): truncation
        # (reference dataset.py:153-154).
        new_h = int(np.int32(np.float32(img.shape[0]) * s))
        new_w = int(np.int32(np.float32(img.shape[1]) * s))
        img = resize_bilinear_np(img, (new_h, new_w))
        lab = resize_nearest_np(lab, (new_h, new_w))

    img = resize_bilinear_np(img, (h, w))
    lab = resize_nearest_np(lab, (h, w))

    if flip and rng.uniform() < 0.5:
        # one shared draw flips both (reference dataset.py:187-192)
        img = img[:, ::-1]
        lab = lab[:, ::-1]

    return _finalize_wire(img, lab, wire_dtype)


def preprocess_eval(
    img: np.ndarray,
    label: np.ndarray,
    *,
    input_size: tuple[int, int] = (321, 321),
    wire_dtype: str = "float32",
) -> tuple[np.ndarray, np.ndarray]:
    """Eval-time preprocessing: fixed resize + BGR + mean, no augmentation
    (reference dataset.py:130). ``wire_dtype="uint8"`` defers the BGR+mean
    to the device (see :func:`augment_train`). ``label`` None gives a None
    label (the VOC protocol keeps the original)."""
    if label is None:
        return _finalize_wire(resize_bilinear_np(img, input_size), None, wire_dtype)
    lab = label[:, :, None] if label.ndim == 2 else label
    return _finalize_wire(resize_bilinear_np(img, input_size),
                          resize_nearest_np(lab, input_size), wire_dtype)
