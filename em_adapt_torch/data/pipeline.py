"""Input pipeline: the VOC reader, synthetic VOC-shaped data, the seeded
batch iterator and the device prefetcher.

``VOCSegmentation``, ``SyntheticVOC`` and the single-process path of
``batch_iterator`` are copies of ``em_adapt_tpu/data/pipeline.py``'s
(train batches, and eval batches with a padded tail): the same files or
seed give bit-identical batches in both packages. ``DevicePrefetcher``
is the counterpart of the JAX package's: a thread copies the next batches
to the card through a ring of pinned host buffers on a copy stream of its
own while the current step runs. Process sharding comes with ROADMAP.md
Queue 1 item 11.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import queue
import threading
import time
from typing import Iterator

import numpy as np

from em_adapt_torch.config import DataConfig
from em_adapt_torch.data.augment import augment_train, preprocess_eval, resize_nearest_np
from em_adapt_torch.data.voc import read_split, rgb_mask_to_index


class VOCSegmentation:
    """The VOC + SBD split ``category`` on disk: ``read_split`` of
    ``cfg.list_dir`` under ``cfg.main_path`` (``cfg.length`` keeps the
    first ids), one (RGB uint8 image, index label) pair per ``load_raw``.
    Pillow is imported when an image is read.

    ``is_strong`` flags the ids listed in ``strong_list`` (masks that are
    real pixel annotations): with ``semi_supervised`` those images train on
    their masks instead of the E-step's labels.
    """

    def __init__(self, cfg: DataConfig, category: str = "train", strong_list: str | None = None):
        self.cfg = cfg
        self.category = category
        self.ids, self.img_paths, self.label_paths = read_split(
            cfg.list_dir, category, cfg.main_path, length=cfg.length)
        strong_ids: set[str] = set()
        if strong_list:
            with open(strong_list) as f:
                strong_ids = {line.strip() for line in f if line.strip()}
        self.is_strong = np.array([i in strong_ids for i in self.ids], bool)

    def __len__(self) -> int:
        return len(self.ids)

    def load_raw(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        from PIL import Image

        with Image.open(self.img_paths[i]) as im:
            img = np.asarray(im.convert("RGB"))
        with Image.open(self.label_paths[i]) as im:
            label = np.asarray(im)
        if label.ndim == 3:  # an RGB-coded mask; converted trees hold index PNGs
            label = rgb_mask_to_index(label)
        return img, label


class SyntheticVOC:
    """Deterministic fake VOC-shaped data (variable image sizes like the
    real corpus, a void band like VOC object boundaries). About
    ``strong_fraction`` of the images are flagged ``is_strong``, drawn
    from ``seed`` as the JAX package draws them."""

    def __init__(self, n: int = 64, num_classes: int = 21, seed: int = 0,
                 strong_fraction: float = 0.0):
        self.n = n
        self.num_classes = num_classes
        self.seed = seed
        self.ids = [f"synth_{i:06d}" for i in range(n)]
        self.is_strong = np.random.default_rng(seed).uniform(size=n) < strong_fraction

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
    """Yield batches {"image" [B,H,W,3], "label" [B,H,W,1], "id" list},
    and "is_strong" [B] bool whenever the dataset flags any image strong
    (the whole dataset decides, so every batch has the same keys; pad rows
    are False).

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

    strong = getattr(dataset, "is_strong", None)
    include_strong = strong is not None and bool(strong.any())
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
                flags = [bool(strong[int(i)]) for i in idxs] if include_strong else []
                if len(idxs) < batch_size:
                    # -1 rows of the JAX package: a zero image, an all-void label.
                    pad = batch_size - len(idxs)
                    img0, lab0 = results[0]
                    results += [(np.zeros_like(img0), np.full_like(lab0, 255))] * pad
                    ids += ["__pad__"] * pad
                    flags += [False] * pad
                out = {
                    "image": np.stack([r[0] for r in results]),
                    "label": np.stack([r[1] for r in results]),
                    "id": ids,
                }
                if include_strong:
                    out["is_strong"] = np.array(flags)
                yield out
            epoch += 1
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


class DevicePrefetcher:
    """Batches of ``it`` with their numpy arrays already on ``device``.

    A daemon thread pulls at most ``limit`` batches (None: all) from
    ``it`` and keeps up to ``depth`` of them ready. On a CUDA device it
    copies each array into a ring of ``depth + 1`` pinned host buffers,
    reused from batch to batch, and from there to the card with
    ``non_blocking=True`` on a copy stream of its own; an event recorded
    after a batch's copies is what ``__next__`` makes the consumer's
    stream wait on, and a slot is refilled only once the copy out of it
    has finished. On the CPU each array is copied into a tensor of its
    own. Leaves that are not arrays (the ids) pass through.

    An error in ``it`` ends the stream in the consumer as a RuntimeError
    whose cause is that error. ``close`` stops the thread and waits for
    it; batches read ahead and not consumed are dropped.
    """

    def __init__(self, it: Iterator[dict], device, depth: int = 2, limit: int | None = None):
        import torch

        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        depth = max(1, depth)
        # depth batches wait in the queue while the thread fills one more slot.
        self._ring: list[dict] = [{} for _ in range(depth + 1)]
        self._copied: list = [None] * (depth + 1)  # each slot's last copy's event
        if self._cuda:
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self.device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._limit = limit
        self._done = object()
        self._ended = False
        self._stop = False
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._fill, daemon=True,
                                        name="DevicePrefetcher")
        self._thread.start()

    def _upload(self, batch: dict, slot: int) -> tuple[dict, object]:
        """The batch with its arrays as tensors on the device, and the
        event after their copies (None on the CPU)."""
        import torch

        arrays = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in batch.items() if isinstance(v, np.ndarray)}
        if not self._cuda:
            return {**batch, **{k: v.clone() for k, v in arrays.items()}}, None
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # the DMA out of this slot is done
        pinned = self._ring[slot]
        out = {}
        for k, v in arrays.items():
            buf = pinned.get(k)
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                buf = pinned[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            buf.copy_(v)
            out[k] = buf.to(self.device, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        self._copied[slot] = copied
        return {**batch, **out}, copied

    def _put(self, item) -> bool:
        while not self._stop:
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self) -> None:
        import torch

        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
            n = 0
            with torch.cuda.stream(self._stream) if self._cuda else contextlib.nullcontext():
                while not self._stop and (self._limit is None or n < self._limit):
                    batch = next(self._it, None)
                    if batch is None:
                        break
                    item = self._upload(batch, n % len(self._ring))
                    n += 1
                    if not self._put(item):
                        break
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer by __next__
            # Ending quietly here would look like the end of the data: the
            # training loop would stop and save a partial run.
            self._error = e
        finally:
            self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._ended:
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            self._ended = True
            if self._error is not None:
                raise RuntimeError(
                    "DevicePrefetcher: the fill thread died on an error in the source "
                    "pipeline (decode, augment or copy)"
                ) from self._error
            raise StopIteration
        batch, copied = item
        if copied is not None:
            import torch

            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            for v in batch.values():
                if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                    v.record_stream(stream)  # freed after the consumer's use, not before
        return batch

    def close(self, timeout: float = 60.0) -> None:
        """Stop the fill thread and wait until it has ended; raise if it is
        still alive after ``timeout`` seconds (stuck in the source). A
        thread left inside the source generator would race its next
        consumer ("generator already executing")."""
        self._stop = True
        deadline = time.monotonic() + timeout
        while self._thread.is_alive():
            self._drain()  # unblocks a put in progress
            self._thread.join(timeout=0.1)
            if self._thread.is_alive() and time.monotonic() > deadline:
                raise RuntimeError(
                    f"DevicePrefetcher.close: the fill thread is still alive after {timeout} s "
                    "(stuck in decode or copy?)"
                )
        self._drain()
        self._ended = True

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
