"""Faults planted underneath the timed path, to show that the comparison
catches them (``tests/test_faults.py``, ``calibrate.py --fault``):

* ``unchanged``: the optimizer's step returns the state as it was;
* ``half_batch``: the training loss over the first half of the batch only
  (its mean over the rest);
* ``deep_wgrad``: the weight gradient of one deep layer (``DEEP_LAYER``,
  cuDNN's) halved, as if half of its reduction were left out;
* ``k3_dw``: K3's weight gradient of ``conv1_2`` halved, where K3 returns
  it;
* ``altered_labels``: the VOC post-process's labels shifted by one class in
  a 64x64 corner of each image, where they are produced;
* ``half_images``: the VOC post-process leaves the second half of each
  batch's images out (their labels all 0).

``plant(name)`` patches the port and returns a function that undoes it.
"""

from __future__ import annotations

TRAIN = ("unchanged", "half_batch", "deep_wgrad", "k3_dw")
EVAL = ("altered_labels", "half_images")
#: The deep layer whose weight gradient ``deep_wgrad`` halves.
DEEP_LAYER = "conv5_2"


def _half_grad():
    """An identity whose gradient is halved."""
    import torch

    class HalfGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return 0.5 * g

    return HalfGrad.apply


def plant(name: str):
    from em_adapt_torch.eval import predict
    from em_adapt_torch.models import deeplab
    from em_adapt_torch.ops import block1
    from em_adapt_torch.train import optim, trainer

    if name == "unchanged":
        owner, attr = optim.AccumulatingSGD, "step"

        def fault(self, step):
            return False
    elif name == "half_batch":
        owner, attr = trainer, "loss_fn"
        orig = trainer.loss_fn

        def fault(model, batch, cfg, **kw):
            half = batch["image"].shape[0] // 2
            return orig(model, {k: v[:half] for k, v in batch.items()}, cfg, **kw)
    elif name == "deep_wgrad":
        owner, attr = deeplab.DeepLabLargeFOV, "_conv"
        orig, half = deeplab.DeepLabLargeFOV._conv, _half_grad()

        def fault(self, layer, h, cdt, rows):
            if layer != DEEP_LAYER:
                return orig(self, layer, h, cdt, rows)
            conv = self.layers[layer]
            return deeplab.conv2d_same(h, half(conv.weight), conv.bias, rate=conv.rate,
                                       compute_dtype=cdt)
    elif name == "k3_dw":
        owner, attr = block1, "block1_bwd"
        orig = block1.block1_bwd

        def fault(*args):
            dw1, db1, dw2, db2 = orig(*args)
            return dw1, db1, 0.5 * dw2, db2
    elif name in EVAL:
        owner, attr = predict.Evaluator, "voc_post_device"
        orig = predict.Evaluator.voc_post_device

        def fault(self, logits, raw_imgs, bucket):
            labels = orig(self, logits, raw_imgs, bucket)
            if name == "altered_labels":
                c = self.cfg.model.num_classes
                labels[:, :64, :64] = (labels[:, :64, :64].astype(int) + 1) % c
            else:
                labels[(len(raw_imgs) + 1) // 2:] = 0
            return labels
    else:
        raise ValueError(f"no fault {name!r}")
    saved = getattr(owner, attr)
    setattr(owner, attr, fault)
    return lambda: setattr(owner, attr, saved)
