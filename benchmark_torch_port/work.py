"""Operations and bytes from shapes, independent of the program.

The yardstick of every share the benchmark reports (MFU, rooflines). It
holds its own copy of DeepLab-LargeFOV's layer table (the network of
xtudbxk/em-adapt-tensorflow ``deeplab.py:35-107``) and of the H100's
published peaks, and counts the work a layer needs, not the work one
implementation of it does: no recompute (remat, K3's own recompute of
block 1's forward), each input byte read once and each output byte
written once.
"""

from __future__ import annotations

import math

#: H100 SXM (NVIDIA data sheet, dense rates at the 700 W limit).
PEAK_BF16_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12

#: (name, kh, kw, cin, cout, stride of the pool after it or 0): the
#: reference's layers at full width (65,140,565 parameters with 21 classes).
LAYERS = (
    ("conv1_1", 3, 3, 3, 64, 0),
    ("conv1_2", 3, 3, 64, 64, 2),
    ("conv2_1", 3, 3, 64, 128, 0),
    ("conv2_2", 3, 3, 128, 128, 2),
    ("conv3_1", 3, 3, 128, 256, 0),
    ("conv3_2", 3, 3, 256, 256, 0),
    ("conv3_3", 3, 3, 256, 256, 2),
    ("conv4_1", 3, 3, 256, 512, 0),
    ("conv4_2", 3, 3, 512, 512, 0),
    ("conv4_3", 3, 3, 512, 512, 1),
    ("conv5_1", 3, 3, 512, 512, 0),
    ("conv5_2", 3, 3, 512, 512, 0),
    ("conv5_3", 3, 3, 512, 512, 1),
    ("fc6", 4, 4, 512, 4096, 0),
    ("fc7", 1, 1, 4096, 4096, 0),
    ("fc8", 1, 1, 4096, 21, 0),
)


def layers(num_classes: int = 21, fc6_channels: int = 4096, width: float = 1.0):
    """The layer table with the widths of a configuration: the head's, and
    the trunk's scaled by ``width`` (at least 8 channels; small widths
    serve the CPU tests only)."""
    out = []
    for name, kh, kw, cin, cout, pool in LAYERS:
        if width != 1.0 and not name.startswith("fc"):
            cin = cin if name == "conv1_1" else max(8, int(round(cin * width)))
            cout = max(8, int(round(cout * width)))
        if name == "fc6":
            cin = max(8, int(round(512 * width))) if width != 1.0 else cin
            cout = fc6_channels
        elif name == "fc7":
            cin = cout = fc6_channels
        elif name == "fc8":
            cin, cout = fc6_channels, num_classes
        out.append((name, kh, kw, cin, cout, pool))
    return tuple(out)


def num_params(**widths) -> int:
    return sum(kh * kw * cin * cout + cout for _, kh, kw, cin, cout, _ in layers(**widths))


def layer_resolutions(h: int, w: int, **widths):
    """(name, kh, kw, cin, cout, h, w) of each layer at an h x w input:
    SAME convolutions, 3x3 SAME pools of stride 2 after blocks 1-3."""
    out = []
    for name, kh, kw, cin, cout, pool in layers(**widths):
        out.append((name, kh, kw, cin, cout, h, w))
        if pool == 2:
            h, w = -(-h // 2), -(-w // 2)
    return out


def score_map_size(h: int, w: int) -> tuple[int, int]:
    for _ in range(3):
        h, w = -(-h // 2), -(-w // 2)
    return h, w


def forward_flops(h: int, w: int, batch: int, **widths) -> int:
    """Multiply-adds (x2) of the network's forward pass."""
    return sum(2 * kh * kw * cin * cout * lh * lw * batch
               for _, kh, kw, cin, cout, lh, lw in layer_resolutions(h, w, **widths))


def train_flops(h: int, w: int, batch: int, **widths) -> int:
    """Multiply-adds (x2) of one training step's convolutions: the forward,
    the input gradient (none for conv1_1, whose input needs none) and the
    weight gradient. No recompute. At 321x321 and a batch of 6 this is
    4,532,042,506,752."""
    total = 0
    for name, kh, kw, cin, cout, lh, lw in layer_resolutions(h, w, **widths):
        fwd = 2 * kh * kw * cin * cout * lh * lw * batch
        total += fwd * (2 if name == "conv1_1" else 3)
    return total


def _bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def block1_fwd(h: int, w: int, batch: int) -> dict:
    """Block 1's forward (conv1_1, ReLU, conv1_2, ReLU, 3x3 pool of stride
    2), the work of K2: bf16 input [B,3,H,W] read, the pooled bf16
    [B,64,H/2,W/2] written, the weights read once."""
    flops = 2 * h * w * batch * (3 * 3 * 3 * 64 + 3 * 3 * 64 * 64)
    ph, pw = -(-h // 2), -(-w // 2)
    nbytes = 2 * (batch * 3 * h * w + batch * 64 * ph * pw) + 4 * (27 * 64 + 576 * 64 + 128)
    return {"flops": flops, "bytes": nbytes, "bound_s": _bound_s(flops, nbytes)}


def block1_bwd(h: int, w: int, batch: int) -> dict:
    """Block 1's backward without any recompute, the work of K3: conv1_2's
    input gradient, both convolutions' weight gradients (conv1_1's input
    needs none); the input x and the pooled output's gradient read once,
    the weight and bias gradients written once."""
    flops = 2 * h * w * batch * (2 * 3 * 3 * 64 * 64 + 3 * 3 * 3 * 64)
    ph, pw = -(-h // 2), -(-w // 2)
    nbytes = 2 * (batch * 3 * h * w + batch * 64 * ph * pw) + 4 * (27 * 64 + 576 * 64 + 128)
    return {"flops": flops, "bytes": nbytes, "bound_s": _bound_s(flops, nbytes)}


def estep_bytes(batch: int, hw: int, num_classes: int = 21, num_iter: int = 5) -> int:
    """Bytes of K1's E-step: the f32 score map read and the biased map
    written, the int32 labels read, the visit schedule read and the
    per-visit thresholds written."""
    visits = num_iter * num_classes
    return (2 * batch * num_classes * hw * 4 + batch * hw * 4 + visits * 4
            + batch * visits * 4)


def estep(batch: int, hw: int, num_classes: int = 21, num_iter: int = 5) -> dict:
    nbytes = estep_bytes(batch, hw, num_classes, num_iter)
    return {"flops": 0, "bytes": nbytes, "bound_s": nbytes / HBM_BYTES_PER_S}


def _round_half_even_f32(x: float) -> int:
    """numpy's float32 rint, as the CRF's grid geometry rounds."""
    import numpy as np

    return int(np.round(np.float32(x)))


def crf_grid_cells(h: int, w: int, sxy: float = 121.0, srgb: float = 5.0) -> int:
    """Cells of the dense CRF's bilateral grid of an h x w image: one cell
    per kernel std on each of the two spatial and three colour axes, the
    colour axes over the whole uint8 range."""
    import numpy as np

    gy = _round_half_even_f32(np.float32(h - 1) / np.float32(sxy)) + 1
    gx = _round_half_even_f32(np.float32(w - 1) / np.float32(sxy)) + 1
    gc = _round_half_even_f32(np.float32(255.0) / np.float32(srgb)) + 1
    return gy * gx * gc ** 3


def crf_bytes(h: int, w: int, num_classes: int = 21, iterations: int = 10,
              sxy: float = 121.0, srgb: float = 5.0) -> int:
    """Bytes the mean-field CRF must move for one h x w image: each
    iteration's bilateral grid (classes + 1 f32 channels) read and written
    once per blur axis (five)."""
    return iterations * 2 * 5 * crf_grid_cells(h, w, sxy, srgb) * (num_classes + 1) * 4


def mfu_percent(flops: float, seconds: float) -> float:
    return 100.0 * flops / seconds / PEAK_BF16_FLOPS


def roofline_percent(bound_s: float, seconds: float) -> float | None:
    """The share of a layer's roofline reached, in %; None where nothing
    was timed."""
    if not seconds or seconds <= 0 or not math.isfinite(seconds):
        return None
    return 100.0 * bound_s / seconds
