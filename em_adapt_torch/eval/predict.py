"""Prediction, the fixed-resolution evaluation and the VOC protocol.

A copy of ``em_adapt_tpu/eval/predict.py`` without its mesh plan:

* the fixed protocol (predict.py:90-133): the network runs at the
  training input size, its logits are bilinearly upsampled (TF1 grid) to
  that size, the argmax is the prediction, and a streaming confusion
  matrix against the labels (resized as the pipeline resizes them) gives
  the mIoU;
* the VOC protocol (predict.py:135-416), the headline number's: each
  image's logits are upsampled to its original size before the argmax,
  optionally refined by the dense CRF (reference network.py:39-41, :63).
  With ``eval.crf_impl="host"`` (or no CRF) the logits come to the host
  and a thread pool upsamples, refines (``eval/crf.py``) and takes the
  argmax; with "tpu" the whole post-process runs on the model's device
  in size buckets (``eval/crf_device.py``) and only uint8 label maps come
  back.
"""

from __future__ import annotations

import collections
import itertools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from em_adapt_torch.config import EvalConfig, ExperimentConfig, check_supported
from em_adapt_torch.data.augment import preprocess_eval, resize_bilinear_np
from em_adapt_torch.device import set_precision
from em_adapt_torch.eval.miou import ConfusionAccumulator, miou_from_confusion
from em_adapt_torch.utils import tracing


#: Bytes of bilateral grid (cells x (classes + 1) f32) that the on-card
#: CRF refines at once; a bucket batch whose grids need more is refined a
#: chunk of images at a time (two grids of the chunk's size live at once).
#: A small bilateral kernel makes a large grid: at 129x129, sxy 4 and srgb
#: 3 it is 692,664,984 cells, 13.9 GB an image at 4 classes.
CRF_GRID_BYTES = 16 * 2**30


def _pad_rows(stack: np.ndarray, target: int) -> np.ndarray:
    """Zero-pad dim 0 up to ``target`` rows: the tail batch keeps the
    batch shape."""
    n = stack.shape[0]
    if n >= target:
        return stack
    return np.concatenate([stack, np.zeros((target - n,) + stack.shape[1:], stack.dtype)])


def _softmax_np(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def crf_buckets(cfg: EvalConfig) -> tuple[tuple[int, int], list[tuple[int, int]]]:
    """(ceiling, buckets smallest area first) of the on-card CRF: the
    extra buckets no larger in area than ``crf_bucket``, and the ceiling."""
    ceiling = tuple(cfg.crf_bucket)
    area = ceiling[0] * ceiling[1]
    extra = {tuple(b) for b in cfg.crf_buckets if b[0] * b[1] <= area}
    return ceiling, sorted(extra | {ceiling}, key=lambda b: (b[0] * b[1], b))


def route(oh: int, ow: int, ceiling: tuple[int, int], buckets) -> tuple[int, int]:
    """The smallest-area bucket that holds an oh x ow image; the ceiling
    is checked first, so an aspect-swapped bucket cannot admit an image
    that ``crf_bucket`` rejects."""
    if oh > ceiling[0] or ow > ceiling[1]:
        raise ValueError(f"image {oh}x{ow} exceeds eval.crf_bucket ({ceiling[0]}, "
                         f"{ceiling[1]}); raise the bucket")
    return next(b for b in buckets if oh <= b[0] and ow <= b[1])


class Evaluator:
    """Evaluates ``model`` (its weights and device as they are) under
    ``torch.no_grad()`` and ``model.eval()``: a registered architecture
    (``models/registry.py``) or the int8
    ``eval/quantize.py::QuantizedDeepLabLargeFOV``."""

    def __init__(self, cfg: ExperimentConfig, model: torch.nn.Module):
        check_supported(cfg, "eval")
        set_precision(cfg.model.compute_dtype)
        self.cfg = cfg
        self.model = model
        # The int8 model holds its weights as buffers.
        self.device = next(itertools.chain(model.parameters(), model.buffers())).device
        self.passes = 0  # card-CRF VOC passes made: each one's entry id

    @torch.no_grad()
    def logits(self, images) -> torch.Tensor:
        """f32 logits [B, h, w, C] at the network's output resolution, on
        the model's device; ``images`` is a host array or a tensor."""
        self.model.eval()
        return self.model(torch.as_tensor(images).to(self.device, non_blocking=True))

    @torch.no_grad()
    def predict_batch(self, images) -> torch.Tensor:
        """[B,H,W] int64 hard predictions at input resolution, on the
        model's device; ``images`` is a host array or a tensor."""
        self.model.eval()
        return self.model.predict(torch.as_tensor(images).to(self.device, non_blocking=True))[1]

    def confusion_fixed(self, batches) -> np.ndarray:
        """[C, C] int64 confusion matrix of the fixed-resolution protocol;
        matrices of disjoint shards sum to the whole set's."""
        acc = ConfusionAccumulator(self.cfg.model.num_classes)
        for batch in batches:
            pred = self.predict_batch(batch["image"])
            acc.update(pred, torch.as_tensor(batch["label"][..., 0]).to(self.device))
        return acc.matrix()

    def evaluate_fixed(self, batches) -> tuple[float, np.ndarray]:
        """(mIoU, per-class IoU) at the fixed input resolution."""
        return miou_from_confusion(self.confusion_fixed(batches))

    def evaluate_voc(self, dataset, *, use_crf: bool | None = None,
                     batch_size: int | None = None) -> tuple[float, np.ndarray]:
        """(mIoU, per-class IoU) of the VOC protocol: each image compared
        at its original resolution, with the CRF if ``use_crf`` (default
        ``eval.use_crf``)."""
        return miou_from_confusion(self.confusion_voc(dataset, use_crf=use_crf,
                                                      batch_size=batch_size))

    def confusion_voc(self, dataset, *, use_crf: bool | None = None,
                      batch_size: int | None = None) -> np.ndarray:
        """[C, C] int64 confusion matrix of the VOC protocol over
        ``dataset`` (``len`` and ``load_raw(i)`` -> (RGB uint8 image, index
        label)); matrices of disjoint shards sum to the whole set's."""
        eval_cfg = self.cfg.eval
        use_crf = eval_cfg.use_crf if use_crf is None else use_crf
        bs = batch_size or eval_cfg.batch_size
        if use_crf and eval_cfg.crf_impl == "tpu":
            return self._confusion_voc_device(dataset, bs)
        acc = ConfusionAccumulator(self.cfg.model.num_classes)

        def post(lg: np.ndarray, raw_img: np.ndarray, raw_label: np.ndarray) -> np.ndarray:
            up = resize_bilinear_np(lg, raw_label.shape[:2])
            if use_crf:
                from em_adapt_torch.eval.crf import dense_crf

                up = dense_crf(_softmax_np(up), raw_img, eval_cfg)
            return up.argmax(-1)

        workers = max(1, eval_cfg.crf_workers if use_crf else 2)
        if use_crf:
            from em_adapt_torch.eval import permutohedral

            if not permutohedral.available():
                if self.device.type == "cuda":
                    raise RuntimeError("the host CRF runs on the permutohedral lattice on the "
                                       "card's host, and the lattice did not build: "
                                       f"{permutohedral.load_error()}")
                # The grid's dense 5-D array is about 250 MB an image: one at a time.
                workers = 1
        pending: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        futures: collections.deque = collections.deque()

        def flush(pool) -> None:
            if not pending:
                return
            stack = _pad_rows(np.stack([p[0] for p in pending]), bs)
            logits = self.logits(stack).cpu().numpy()
            for lg, (_, raw_img, raw_label) in zip(logits, pending):
                futures.append((pool.submit(post, lg, raw_img, raw_label), raw_label))
            pending.clear()

        def drain(keep: int) -> None:
            # In-flight results are bounded (a val set of maps is about 0.7 GB).
            while len(futures) > keep:
                fut, raw_label = futures.popleft()
                acc.update_host(fut.result(), raw_label)

        with ThreadPoolExecutor(max_workers=workers) as pool:
            for i in range(len(dataset)):
                raw_img, raw_label = dataset.load_raw(i)
                img, _ = preprocess_eval(raw_img, None, input_size=self.cfg.model.input_size)
                pending.append((img, raw_img, raw_label))
                if len(pending) == bs:
                    flush(pool)
                    drain(4 * workers)
            flush(pool)
            drain(0)
        return acc.matrix()

    @torch.no_grad()
    def voc_post_device(self, logits: torch.Tensor, raw_imgs, bucket: tuple[int, int]):
        """The on-card post-process of one batch: each image's logits (of
        ``logits`` [B,h,w,C] on the device; rows past ``raw_imgs`` are
        padding, of size (1, 1)) upsampled to its original size inside
        ``bucket`` (TF1 grid, the host resize's to the bit), softmax,
        mean-field CRF under the validity mask, argmax. Returns [B,BH,BW]
        uint8 labels on the host; only the valid region of the first
        ``len(raw_imgs)`` is meaningful (padding rows are not refined).
        The CRF runs on chunks of images whose grids fit
        :data:`CRF_GRID_BYTES`: each image's grid cells are its own, so
        the labels do not depend on the chunking."""
        from em_adapt_torch.eval import crf_device
        from em_adapt_torch.ops.resize import resize_bilinear_tf_padded

        cfg = self.cfg.eval
        b = logits.shape[0]
        bh, bw = bucket
        rgbs = np.zeros((b, bh, bw, 3), np.uint8)
        sizes = np.ones((b, 2), np.int64)
        for i, img in enumerate(raw_imgs):
            oh, ow = img.shape[:2]
            rgbs[i, :oh, :ow] = img
            sizes[i] = (oh, ow)
        up = resize_bilinear_tf_padded(logits, [tuple(s) for s in sizes.tolist()], bucket)
        dev = up.device
        hw = torch.from_numpy(sizes).to(dev)
        mask = ((torch.arange(bh, device=dev)[None, :, None] < hw[:, 0, None, None])
                & (torch.arange(bw, device=dev)[None, None, :] < hw[:, 1, None, None]))
        e = (up - up.amax(-1, keepdim=True)).exp()
        probs, rgb = e / e.sum(-1, keepdim=True), torch.from_numpy(rgbs).to(dev)
        per_image = crf_device.grid_cells(bh, bw, cfg) * (probs.shape[-1] + 1) * 4
        chunk = max(1, CRF_GRID_BYTES // per_image)
        n = len(raw_imgs)  # padding rows are not refined: their labels stay 0
        labels = []
        for i in range(0, n, chunk):
            with tracing.span("crf.refine", stage=True):
                labels.append(crf_device.crf_refine(
                    probs[i:min(i + chunk, n)], rgb[i:min(i + chunk, n)],
                    mask[i:min(i + chunk, n)], bi_sxy=float(cfg.crf_bi_sxy),
                    bi_srgb=float(cfg.crf_bi_srgb), bi_compat=float(cfg.crf_bi_compat),
                    g_sxy=float(cfg.crf_g_sxy), g_compat=float(cfg.crf_g_compat),
                    iterations=int(cfg.crf_iterations)).argmax(-1))
        labels.append(torch.zeros((b - n, bh, bw), dtype=torch.int64, device=dev))
        with tracing.span("eval.to_host") as copy:
            out = torch.cat(labels).to(torch.uint8).cpu().numpy()
        if dev.type != "cpu":
            tracing.waited(copy.ns)
        return out

    def _confusion_voc_device(self, dataset, bs: int) -> np.ndarray:
        """The VOC protocol with the CRF on the model's device: images
        batched per bucket (:func:`route`), their logits kept on the
        device, and only uint8 label maps copied back. The masked CRF is
        padding-invariant, so an image's labels do not depend on its
        bucket. A pass is an entry of ``utils/tracing.py`` (the root span
        ``eval.pass``) with the spans ``eval.load``, ``eval.preprocess``,
        ``eval.forward``, ``eval.post`` (and in it ``crf.refine`` and
        ``eval.to_host``) and ``eval.confusion``."""
        acc = ConfusionAccumulator(self.cfg.model.num_classes)
        ceiling, buckets = crf_buckets(self.cfg.eval)
        pending: dict[tuple[int, int], list] = {b: [] for b in buckets}

        def flush(bucket: tuple[int, int]) -> None:
            pend = pending[bucket]
            if not pend:
                return
            with tracing.span("eval.forward", stage=True):
                logits = self.logits(_pad_rows(np.stack([p[0] for p in pend]), bs))
            with tracing.span("eval.post"):
                labels = self.voc_post_device(logits, [p[1] for p in pend], bucket)
            with tracing.span("eval.confusion"):
                for i, (_, _, raw_label) in enumerate(pend):
                    oh, ow = raw_label.shape[:2]
                    acc.update_host(labels[i, :oh, :ow], raw_label)
            pend.clear()

        with tracing.root("eval.pass", "eval", self.passes, len(dataset)):
            self.passes += 1
            for i in range(len(dataset)):
                with tracing.span("eval.load"):
                    raw_img, raw_label = dataset.load_raw(i)
                with tracing.span("eval.preprocess"):
                    img, _ = preprocess_eval(raw_img, None,
                                             input_size=self.cfg.model.input_size)
                    bucket = route(*raw_label.shape[:2], ceiling, buckets)
                pending[bucket].append((img, raw_img, raw_label))
                if len(pending[bucket]) == bs:
                    flush(bucket)
            for bucket in buckets:
                flush(bucket)
        return acc.matrix()
