"""Input pipeline: synthetic VOC-shaped data and the seeded batch iterator.

Copies of ``SyntheticVOC`` and of the single-process path of
``batch_iterator`` in ``em_adapt_tpu/data/pipeline.py`` (train batches,
and eval batches with a padded tail): the same seed gives bit-identical
batches in both packages. The VOC disk reader,
process sharding and the device prefetcher come with later slices
(ROADMAP.md Queue 1 item 2).
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator

import numpy as np

from em_adapt_torch.config import DataConfig
from em_adapt_torch.data.augment import augment_train, preprocess_eval, resize_nearest_np


class SyntheticVOC:
    """Deterministic fake VOC-shaped data (variable image sizes like the
    real corpus, a void band like VOC object boundaries)."""

    def __init__(self, n: int = 64, num_classes: int = 21, seed: int = 0):
        self.n = n
        self.num_classes = num_classes
        self.seed = seed
        self.ids = [f"synth_{i:06d}" for i in range(n)]

    def __len__(self) -> int:
        return self.n

    def load_raw(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        g = np.random.default_rng(self.seed * 100003 + i)
        h = int(g.integers(200, 500))
        w = int(g.integers(200, 500))
        img = g.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        label = g.integers(0, self.num_classes, size=(h, w)).astype(np.uint8)
        label[: h // 8] = 255
        return img, label


def batch_iterator(
    dataset,
    cfg: DataConfig,
    *,
    batch_size: int,
    seed: int = 0,
    epochs: int | None = None,
    train: bool = True,
    num_workers: int | None = None,
    start_step: int = 0,
) -> Iterator[dict]:
    """Yield batches {"image" [B,H,W,3], "label" [B,H,W,1], "id" list}.

    Training (``train=True``): each epoch's order is a seeded permutation;
    each sample's augmentation draws from its own child generator keyed by
    (seed, epoch, index), so batches do not depend on worker scheduling;
    a final partial batch is dropped. Evaluation (``train=False``): the
    dataset's order and :func:`preprocess_eval`; a final partial batch is
    padded to ``batch_size`` with zero images, all-void (255) labels and
    ids ``"__pad__"``, so no image leaves the metric and the batch shape
    stays fixed. ``start_step`` skips the first batches without decoding
    them.
    """
    n = len(dataset)
    num_workers = num_workers if num_workers is not None else cfg.num_workers
    if train and n < batch_size:
        raise ValueError(
            f"dataset has {n} images < batch_size {batch_size}: every training "
            "batch would be dropped"
        )
    if start_step < 0:
        raise ValueError(f"start_step must be >= 0, got {start_step}")
    batches_per_epoch = n // batch_size if train else max(-(-n // batch_size), 1)
    epoch = start_step // batches_per_epoch
    to_skip = start_step % batches_per_epoch

    def load_one(epoch: int, idx: int) -> tuple[np.ndarray, np.ndarray]:
        img, label = dataset.load_raw(idx)
        if not train:
            return preprocess_eval(img, label, input_size=cfg.input_size,
                                   wire_dtype=cfg.wire_dtype)
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, idx, 0xA46]))
        img_p, lab_p = augment_train(
            img,
            label,
            rng,
            input_size=cfg.input_size,
            scale_range=cfg.scale_range,
            random_scale=cfg.random_scale,
            flip=cfg.flip,
            wire_dtype=cfg.wire_dtype,
        )
        if cfg.train_label_size is not None:
            lab_p = resize_nearest_np(lab_p, tuple(cfg.train_label_size))
        return img_p, lab_p

    pool = cf.ThreadPoolExecutor(max_workers=max(1, num_workers))
    try:
        while epochs is None or epoch < epochs:
            if train:
                perm = np.random.default_rng(np.random.SeedSequence([seed, epoch])).permutation(n)
            else:
                perm = np.arange(n)
            for start in range(0, n, batch_size):
                idxs = perm[start : start + batch_size]
                if len(idxs) < batch_size and train:
                    continue
                if to_skip > 0:
                    to_skip -= 1
                    continue
                results = list(pool.map(lambda i: load_one(epoch, int(i)), idxs))
                ids = [dataset.ids[int(i)] for i in idxs]
                if len(idxs) < batch_size:
                    # -1 rows of the JAX package: a zero image, an all-void label.
                    pad = batch_size - len(idxs)
                    img0, lab0 = results[0]
                    results += [(np.zeros_like(img0), np.full_like(lab0, 255))] * pad
                    ids += ["__pad__"] * pad
                yield {
                    "image": np.stack([r[0] for r in results]),
                    "label": np.stack([r[1] for r in results]),
                    "id": ids,
                }
            epoch += 1
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
