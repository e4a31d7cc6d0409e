"""The one generator of every traffic mix: VOC-like inputs from a seed.

A mix is a data file, ``traffic/<name>.json``; this module reads its
parameters and makes the inputs on the device. Two seeds play apart:

* ``structure_seed`` (in the file) fixes the shape of the work: how many
  foreground classes each image carries, and in evaluation each image's
  size. Every run seed gets the same multiset of them.
* the run's ``--seed`` draws the contents (classes, rectangles, colours,
  noise, weights) and the order of the structure.

Labels are drawn as ``chip_smoke.py::realistic_batch`` draws them,
rescaled to the input size: background plus 1-3 foreground classes in
rectangles and a void (255) band on top. VOC 2012 images carry about 1.5
foreground classes each.
"""

from __future__ import annotations

import numpy as np
import torch

VOID = 255


def tf_nearest_index(out_size: int, in_size: int) -> np.ndarray:
    """TF1 resize_nearest_neighbor's source index of each output index
    (align_corners=False): min(floor(i * (in/out)), in-1) in float32."""
    scale = np.float32(in_size) / np.float32(out_size)
    src = np.arange(out_size, dtype=np.float32) * scale
    return np.minimum(np.floor(src), in_size - 1).astype(np.int64)


def _fg_counts(params: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """Foreground classes of each of n images: the structure's multiset in
    the run's order."""
    lo, hi = params.get("fg_classes", [1, 3])
    base = np.random.default_rng(params["structure_seed"]).integers(lo, hi + 1, size=n)
    return rng.permutation(base)


def _rectangles(rng: np.random.Generator, counts: np.ndarray, h: np.ndarray, w: np.ndarray,
                num_classes: int, void_rows: int):
    """Per image: (classes, [y0, y1, x0, x1] per class, void rows), drawn
    as realistic_batch draws them at 41x41, scaled to each image's size."""
    out = []
    for i, k in enumerate(counts):
        sy, sx = h[i] / 41.0, w[i] / 41.0
        classes = rng.choice(np.arange(1, num_classes), size=int(k), replace=False)
        rects = []
        for _ in classes:
            y0, x0 = rng.integers(0, 41 - 8, size=2)
            y1 = y0 + rng.integers(6, 41 - y0 + 1)
            x1 = x0 + rng.integers(6, 41 - x0 + 1)
            rects.append([int(y0 * sy), int(round(y1 * sy)), int(x0 * sx), int(round(x1 * sx))])
        out.append((classes, rects, int(round(rng.integers(0, void_rows + 1) * sy))))
    return out


def _paint(rects, n: int, hmax: int, wmax: int, device) -> torch.Tensor:
    """uint8 label maps [n, hmax, wmax] on the device from the rectangles."""
    label = torch.zeros(n, hmax, wmax, dtype=torch.uint8, device=device)
    for i, (classes, boxes, void) in enumerate(rects):
        for c, (y0, y1, x0, x1) in zip(classes, boxes):
            label[i, y0:y1, x0:x1] = int(c)
        label[i, :void] = VOID
    return label


def _images(label: torch.Tensor, generator: torch.Generator, num_classes: int,
            noise: float) -> torch.Tensor:
    """uint8 RGB images [n, H, W, 3]: each class region a colour of its own
    per image (void shows the background's), plus Gaussian noise."""
    n = label.shape[0]
    colors = torch.randint(0, 256, (n, num_classes, 3), generator=generator,
                           device=label.device, dtype=torch.int16).to(torch.float32)
    cls = torch.where(label == VOID, torch.zeros_like(label), label).to(torch.int64)
    img = torch.gather(colors, 1, cls.reshape(n, -1, 1).expand(-1, -1, 3)).reshape(
        *label.shape, 3)
    img += noise * torch.randn(img.shape, generator=generator, device=label.device)
    return img.round_().clamp_(0, 255).to(torch.uint8)


def train_pool(params: dict, *, input_size: tuple[int, int], label_size, batch: int,
               num_classes: int, seed: int, device) -> list[dict]:
    """``params["pool_batches"]`` training batches {"image" uint8
    [B,H,W,3], "label" uint8 [B,h,w,1]} on the device, the label at
    ``label_size`` (TF1 nearest from the input size, as the input pipeline
    shrinks it) or at the input size where that is None."""
    rng = np.random.default_rng([seed, 0x7AF])
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    n = params["pool_batches"] * batch
    h, w = input_size
    counts = _fg_counts(params, n, rng)
    rects = _rectangles(rng, counts, np.full(n, h), np.full(n, w), num_classes,
                        params.get("void_rows", 4))
    label = _paint(rects, n, h, w, device)
    image = _images(label, gen, num_classes, params.get("noise", 20.0))
    if label_size is not None:
        lh, lw = label_size
        ys = torch.from_numpy(tf_nearest_index(lh, h)).to(device)
        xs = torch.from_numpy(tf_nearest_index(lw, w)).to(device)
        label = label.index_select(1, ys).index_select(2, xs)
    label = label[..., None].contiguous()
    return [{"image": image[i * batch:(i + 1) * batch],
             "label": label[i * batch:(i + 1) * batch]} for i in range(params["pool_batches"])]


def eval_sizes(params: dict, rng: np.random.Generator) -> np.ndarray:
    """[n, 2] (height, width) of the evaluation images: a share
    ``standard_share`` at VOC's 500x375 or 375x500, the rest with sides of
    ``side_range``; the structure's multiset in the run's order."""
    n = params["images"]
    srng = np.random.default_rng(params["structure_seed"])
    std = int(round(params["standard_share"] * n))
    lo, hi = params["side_range"]
    sizes = np.empty((n, 2), np.int64)
    portrait = srng.random(std) < 0.5
    sizes[:std] = np.where(portrait[:, None], [[500, 375]], [[375, 500]])
    sizes[std:] = srng.integers(lo, hi + 1, size=(n - std, 2))
    return sizes[rng.permutation(n)]


class EvalImages:
    """``params["images"]`` evaluation images and VOC-like index masks at
    their own sizes, in host memory: the dataset protocol of
    ``Evaluator.confusion_voc`` (``len`` and ``load_raw(i)`` -> (RGB uint8
    [H,W,3], uint8 [H,W]))."""

    def __init__(self, params: dict, *, num_classes: int, seed: int, device):
        rng = np.random.default_rng([seed, 0xE7A])
        gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
        self.sizes = eval_sizes(params, rng)
        n = len(self.sizes)
        hmax, wmax = (int(v) for v in self.sizes.max(0))
        counts = _fg_counts(params, n, rng)
        rects = _rectangles(rng, counts, self.sizes[:, 0], self.sizes[:, 1], num_classes,
                            params.get("void_rows", 4))
        label = _paint(rects, n, hmax, wmax, device)
        image = _images(label, gen, num_classes, params.get("noise", 20.0)).cpu().numpy()
        label = label.cpu().numpy()
        crops = [(slice(0, h), slice(0, w)) for h, w in self.sizes]
        self.images = [np.ascontiguousarray(image[j][c]) for j, c in enumerate(crops)]
        self.labels = [np.ascontiguousarray(label[j][c]) for j, c in enumerate(crops)]

    def __len__(self) -> int:
        return len(self.images)

    def load_raw(self, i: int):
        return self.images[i], self.labels[i]
