"""The EM training step and a small training loop.

One microbatch step (reference deeplab.py:242-280): forward with dropout
-> TF1 nearest shrink of the label to the score map -> E-step weak labels
(no gradient) -> mean cross-entropy over all pixels + wd * L2(weights)
-> backward -> accumulated SGD with momentum. The pure-weak path of
``em_adapt_tpu/train/trainer.py::loss_fn`` (trainer.py:138-230);
checkpointing, resume, the watchdog, semi-supervision and tag warm-up
come with ROADMAP.md Queue 1 item 2.

Randomness: one ``torch.Generator`` on the training device draws the
dropout masks and the E-step's class orders. It gives other draws than
the JAX package's keys; tests inject the same orders and masks instead.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from em_adapt_torch.config import ExperimentConfig, check_supported
from em_adapt_torch.device import resolve_device, set_precision
from em_adapt_torch.models.deeplab import DeepLabLargeFOV, build_model
from em_adapt_torch.ops import block1 as k23
from em_adapt_torch.ops import estep_kernel as k1
from em_adapt_torch.ops.estep import estep_labels, make_class_orders
from em_adapt_torch.ops.resize import resize_nearest_tf
from em_adapt_torch.train.optim import AccumulatingSGD, lr_at


def loss_fn(
    model: DeepLabLargeFOV,
    batch: dict,
    cfg: ExperimentConfig,
    *,
    generator: torch.Generator | None = None,
    orders: torch.Tensor | None = None,
    masks: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, dict]:
    """Total loss = CE(logits, E-step labels) + wd * L2(weights).

    batch: {"image" [B,H,W,3], "label" [B,H,W,1] (255 = ignore)} tensors
    on the model's device. ``orders`` and ``masks`` replace the draws from
    ``generator``. Returns (total, {"loss", "loss_norm", "loss_l2", "weak"}).
    """
    c = cfg.model.num_classes
    logits = model(batch["image"], train=True, generator=generator, masks=masks)
    out_hw = (logits.shape[1], logits.shape[2])
    label = batch["label"]
    if tuple(label.shape[1:3]) == out_hw:
        shrunk = label[..., 0]
    else:
        shrunk = resize_nearest_tf(label, out_hw)[..., 0]  # reference deeplab.py:110
    if orders is None:
        orders = make_class_orders(generator, cfg.estep.num_iter, c)
    weak = estep_labels(logits.detach(), shrunk, orders, cfg.estep)
    # NCHW view of the logits; every pixel has a valid weak label, so the
    # mean runs over all of them (reference deeplab.py:182).
    ce = F.cross_entropy(logits.permute(0, 3, 1, 2), weak)
    l2 = model.weight_l2()
    total = ce + cfg.optim.weight_decay * l2
    return total, {"loss": total.detach(), "loss_norm": ce.detach(),
                   "loss_l2": l2.detach(), "weak": weak}


@dataclasses.dataclass
class TrainState:
    model: DeepLabLargeFOV
    optimizer: AccumulatingSGD
    generator: torch.Generator
    step: int = 0


def train_step(
    state: TrainState,
    batch: dict,
    cfg: ExperimentConfig,
    *,
    orders: torch.Tensor | None = None,
    masks: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> dict:
    """One microbatch step in place on ``state``. Returns the metrics and
    ``"updated"``: whether this step applied an accumulated update."""
    for p in state.optimizer.params:
        p.grad = None
    total, metrics = loss_fn(
        state.model, batch, cfg, generator=state.generator, orders=orders, masks=masks
    )
    total.backward()
    metrics["updated"] = state.optimizer.step(state.step)
    state.step += 1
    return metrics


def to_device(batch: dict, device: torch.device) -> dict:
    """Host numpy batch -> tensors on ``device`` (non-array leaves pass)."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
        if isinstance(v, np.ndarray) else v
        for k, v in batch.items()
    }


class Trainer:
    """Owns the model, optimizer and generator of one training run."""

    def __init__(self, cfg: ExperimentConfig, *, device=None, steps_per_epoch: int | None = None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        set_precision(cfg.model.compute_dtype)
        self.steps_per_epoch = steps_per_epoch or 1

    def init_state(self, seed: int | None = None) -> TrainState:
        """Fresh parameters (drawn on the CPU from ``seed``, so a seed gives
        the same weights on every device), zeroed optimizer, step 0."""
        seed = self.cfg.train.seed if seed is None else seed
        model = build_model(self.cfg.model, seed, self.device)
        model.train()
        optimizer = AccumulatingSGD(model.parameters(), self.cfg.optim, self.steps_per_epoch)
        generator = torch.Generator(self.device).manual_seed(seed + 1)
        return TrainState(model, optimizer, generator)

    def train_step(self, state: TrainState, batch: dict, **kw) -> dict:
        return train_step(state, to_device(batch, self.device), self.cfg, **kw)

    def fit(
        self,
        state: TrainState,
        batches: Iterable[dict],
        *,
        num_steps: int,
        log_fn: Callable[[dict], None] | None = None,
    ) -> list[dict]:
        """Run ``num_steps`` microbatch steps over ``batches``.

        Returns one record per step: step, loss, lr, whether the params
        moved, the step's seconds (host clock, synchronized) and the
        launches it made of the E-step kernel K1 and of the fused block1's
        forward K2 and backward K3. Raises on a non-finite loss.
        """
        records = []
        it = iter(batches)
        for _ in range(num_steps):
            batch = next(it, None)
            if batch is None:
                break
            launches = (k1.launches, k23.launches, k23.bwd_launches)
            t0 = time.perf_counter()
            metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])  # synchronizes the device
            seconds = time.perf_counter() - t0
            if not math.isfinite(loss):
                raise RuntimeError(f"training unhealthy: loss {loss} at step {state.step - 1}")
            record = {
                "step": state.step - 1,
                "loss": loss,
                "lr": lr_at(self.cfg.optim, self.steps_per_epoch, state.step - 1),
                "updated": metrics["updated"],
                "seconds": seconds,
                "estep_launches": k1.launches - launches[0],
                "block1_fwd_launches": k23.launches - launches[1],
                "block1_bwd_launches": k23.bwd_launches - launches[2],
            }
            records.append(record)
            if log_fn is not None:
                log_fn(record)
        return records
