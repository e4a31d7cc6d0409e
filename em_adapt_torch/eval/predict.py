"""Prediction and the fixed-resolution evaluation.

A copy of the fixed protocol of ``em_adapt_tpu/eval/predict.py``
(predict.py:90-133): the network runs at the training input size, its
logits are bilinearly upsampled (TF1 grid) to that size, the argmax is
the prediction, and a streaming confusion matrix against the labels
(resized as the pipeline resizes them) gives the mIoU. The exact VOC
protocol (original resolution, optional CRF) is ROADMAP.md Queue 1 item 7.
"""

from __future__ import annotations

import numpy as np
import torch

from em_adapt_torch.config import ExperimentConfig, check_supported
from em_adapt_torch.device import set_precision
from em_adapt_torch.eval.miou import ConfusionAccumulator, miou_from_confusion
from em_adapt_torch.models.deeplab import DeepLabLargeFOV


class Evaluator:
    """Evaluates ``model`` (its weights and device as they are) under
    ``torch.no_grad()`` and ``model.eval()``."""

    def __init__(self, cfg: ExperimentConfig, model: DeepLabLargeFOV):
        check_supported(cfg, "eval")
        set_precision(cfg.model.compute_dtype)
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device

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

    def evaluate_voc(self, dataset, **kw):
        raise NotImplementedError(
            "the VOC protocol (original resolution, optional CRF) is not ported yet: "
            "ROADMAP.md Queue 1 item 7 brings it"
        )
