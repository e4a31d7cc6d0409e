"""PASCAL VOC 2012 (+SBD) dataset utilities.

The port's own copy of ``em_adapt_tpu/data/voc.py``:

* ``convert_dataset``: the one-shot conversion of VOC RGB masks and SBD
  .mat files into index-PNG ``SegmentationClassAug`` (reference
  convert.py:23-51);
* ``rgb_mask_to_index`` / ``index_to_rgb``: exact-color palette matching
  (reference convert.py:8-21, dataset.py:79-105);
* ``read_split``: id lists from ``{list_dir}/{split}.txt`` resolved to
  JPEG/PNG paths (reference dataset.py:25-46).

Pillow and scipy are imported inside the functions that read or write
files, so the module imports on a machine without them.
"""

from __future__ import annotations

import os

import numpy as np

#: The 21-color VOC class palette (class id -> RGB).
VOC_PALETTE: tuple[tuple[int, int, int], ...] = (
    (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0),
    (0, 0, 128), (128, 0, 128), (0, 128, 128), (128, 128, 128),
    (64, 0, 0), (192, 0, 0), (64, 128, 0), (192, 128, 0),
    (64, 0, 128), (192, 0, 128), (64, 128, 128), (192, 128, 128),
    (0, 64, 0), (128, 64, 0), (0, 192, 0), (128, 192, 0),
    (0, 64, 128),
)

#: PASCAL VOC class names, index = label.
VOC_CLASS_NAMES: tuple[str, ...] = (
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor",
)

IGNORE_LABEL = 255


def rgb_mask_to_index(rgb: np.ndarray, ignore: int = IGNORE_LABEL) -> np.ndarray:
    """RGB mask [H,W,3+] -> index mask [H,W] uint8 by exact palette match;
    unmatched pixels (e.g. the white void boundary) become ``ignore``."""
    out = np.full(rgb.shape[:2], ignore, dtype=np.uint8)
    rgb3 = rgb[:, :, :3]
    for idx, color in enumerate(VOC_PALETTE):
        out[np.all(rgb3 == np.asarray(color, rgb3.dtype), axis=-1)] = idx
    return out


def index_to_rgb(
    label: np.ndarray,
    ignore: int = IGNORE_LABEL,
    ignore_color: tuple[int, int, int] = (255, 255, 255),
) -> np.ndarray:
    """Index mask [H,W] -> RGB [H,W,3] uint8 for visual inspection."""
    out = np.zeros(label.shape + (3,), dtype=np.uint8)
    for idx, color in enumerate(VOC_PALETTE):
        out[label == idx] = color
    out[label == ignore] = ignore_color
    return out


def read_split(
    list_dir: str,
    category: str,
    main_path: str,
    *,
    length: int | None = None,
) -> tuple[list[str], list[str], list[str]]:
    """Read ``{list_dir}/{category}.txt`` of bare ids (blank lines skipped);
    resolve image and label paths under ``main_path`` (JPEGImages,
    SegmentationClassAug). ``length`` keeps the first ids only (reference
    dataset.py:38-42)."""
    with open(os.path.join(list_dir, f"{category}.txt")) as f:
        ids = [line.strip() for line in f if line.strip()]
    if length is not None:
        ids = ids[:length]
    imgs = [os.path.join(main_path, "JPEGImages", f"{i}.jpg") for i in ids]
    labels = [os.path.join(main_path, "SegmentationClassAug", f"{i}.png") for i in ids]
    return ids, imgs, labels


def convert_dataset(
    voc_seg_dir: str | None,
    sbd_cls_dir: str | None,
    out_dir: str,
    *,
    progress_every: int = 500,
    log=print,
) -> int:
    """Build ``SegmentationClassAug``: VOC RGB masks -> index PNGs, SBD
    ``GTcls.Segmentation`` matrices -> PNGs (reference convert.py:23-51).
    Palette-mode VOC PNGs (already indexed) are written back unchanged.
    A mask of any other layout (e.g. gray + alpha) raises ValueError
    naming the file. Returns the number of files written."""
    import glob

    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    written = 0
    if voc_seg_dir:
        files = sorted(glob.glob(os.path.join(voc_seg_dir, "*.png")))
        for i, path in enumerate(files):
            if progress_every and i % progress_every == 0:
                log(f"voc: {i}/{len(files)}")
            img = Image.open(path)
            arr = np.asarray(img)
            if arr.ndim == 3 and arr.shape[2] >= 3:
                arr = rgb_mask_to_index(arr)
            elif arr.ndim == 3 and arr.shape[2] == 1:
                arr = arr[:, :, 0]
            elif arr.ndim != 2:
                raise ValueError(
                    f"{path}: unsupported mask layout {arr.shape} (PIL mode {img.mode!r}); "
                    "expected a palette/grayscale index mask or an RGB(A) palette-color mask"
                )
            Image.fromarray(arr.astype(np.uint8)).save(
                os.path.join(out_dir, os.path.basename(path)))
            written += 1
    if sbd_cls_dir:
        from scipy import io as scipy_io

        files = sorted(glob.glob(os.path.join(sbd_cls_dir, "*.mat")))
        for i, path in enumerate(files):
            if progress_every and i % progress_every == 0:
                log(f"sbd: {i}/{len(files)}")
            seg = scipy_io.loadmat(path)["GTcls"]["Segmentation"][0][0].astype(np.uint8)
            stem = os.path.splitext(os.path.basename(path))[0]
            Image.fromarray(seg).save(os.path.join(out_dir, f"{stem}.png"))
            written += 1
    log(f"convert finished: {written} masks -> {out_dir}")
    return written
