"""The EM training step and the durable training loop.

One microbatch step (reference deeplab.py:242-280): forward with dropout
-> TF1 nearest shrink of the label to the score map -> E-step weak labels
(no gradient) -> mean cross-entropy over all pixels + wd * L2(weights)
-> backward -> accumulated SGD with momentum. The pure-weak path of
``em_adapt_tpu/train/trainer.py::loss_fn`` (trainer.py:138-230).
``Trainer.fit`` is the loop of ``em_adapt_tpu/train/trainer.py::fit``
(l.612-884) on one process: the batches arrive through a
``DevicePrefetcher`` (``data.prefetch`` deep); "norm" saves, "lr"
snapshots, the preemption save and the loss watchdog. Semi-supervision,
tag warm-up and periodic eval come with ROADMAP.md Queue 1 item 2 (2d).

Randomness: one ``torch.Generator`` on the training device draws the
dropout masks and the E-step's class orders. It gives other draws than
the JAX package's keys; tests inject the same orders and masks instead.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from em_adapt_torch.config import ExperimentConfig, check_supported
from em_adapt_torch.data.pipeline import DevicePrefetcher
from em_adapt_torch.device import resolve_device, set_precision
from em_adapt_torch.models.deeplab import DeepLabLargeFOV, build_model
from em_adapt_torch.ops import block1 as k23
from em_adapt_torch.ops import estep_kernel as k1
from em_adapt_torch.ops.estep import estep_labels, make_class_orders
from em_adapt_torch.ops.resize import resize_nearest_tf
from em_adapt_torch.train.checkpoint import CheckpointManager
from em_adapt_torch.train.optim import AccumulatingSGD, lr_at
from em_adapt_torch.train.state import TrainState
from em_adapt_torch.utils.failure import GracefulShutdown, LossWatchdog


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
    # mean runs over all of them (reference deeplab.py:182). It is taken
    # over the per-pixel losses because cross_entropy's own mean adds them
    # with atomics on a CUDA card: its value (not its gradient) would vary
    # in the last bits from run to run, and a resumed run's losses must
    # equal the uninterrupted run's.
    ce = F.cross_entropy(logits.permute(0, 3, 1, 2), weak, reduction="none").mean()
    l2 = model.weight_l2()
    total = ce + cfg.optim.weight_decay * l2
    return total, {"loss": total.detach(), "loss_norm": ce.detach(),
                   "loss_l2": l2.detach(), "weak": weak}


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
    """The batch with its numpy arrays copied to ``device`` (from pageable
    memory: ``Trainer.fit`` copies through ``DevicePrefetcher``'s pinned
    ring instead). Tensors, and leaves that are not arrays, pass as they
    are."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
        if isinstance(v, np.ndarray) else v
        for k, v in batch.items()
    }


class Trainer:
    """Owns the model, optimizer, generator and checkpoints of one training run."""

    def __init__(self, cfg: ExperimentConfig, *, device=None, steps_per_epoch: int | None = None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        set_precision(cfg.model.compute_dtype)
        self.steps_per_epoch = steps_per_epoch or 1
        self.checkpointer = CheckpointManager(cfg.checkpoint)

    def init_state(self, seed: int | None = None) -> TrainState:
        """Fresh parameters (drawn on the CPU from ``seed``, so a seed gives
        the same weights on every device), zeroed optimizer, step 0."""
        seed = self.cfg.train.seed if seed is None else seed
        model = build_model(self.cfg.model, seed, self.device)
        model.train()
        optimizer = AccumulatingSGD(model.parameters(), self.cfg.optim, self.steps_per_epoch)
        generator = torch.Generator(self.device).manual_seed(seed + 1)
        return TrainState(model, optimizer, generator)

    def restore_state(self, tag: str = "norm", step: int | None = None) -> TrainState:
        """The full state saved under ``tag`` at ``step`` (default: the
        latest), on this trainer's device."""
        return self.checkpointer.restore(self.init_state(), tag, step)

    def train_step(self, state: TrainState, batch: dict, **kw) -> dict:
        return train_step(state, to_device(batch, self.device), self.cfg, **kw)

    def fit(
        self,
        state: TrainState,
        batches: Iterable[dict],
        *,
        num_steps: int | None = None,
        log_fn: Callable[[dict], None] | None = None,
    ) -> list[dict]:
        """Train until ``state.step`` reaches ``num_steps`` (an absolute
        budget: a resumed state runs only the rest; default epochs *
        steps_per_epoch), the batches end, or SIGTERM/SIGINT arrives.

        With ``data.prefetch`` > 0 the batches go through a
        ``DevicePrefetcher`` (unless they already do), which pulls no more
        than the budget's rest and is closed on every way out; batches it
        read ahead and that were not used are dropped.

        Saves "norm" where the step crosses a multiple of
        ``checkpoint.save_every_steps`` (0: never), "lr" right before the
        first step of each LR drop, and on a signal "norm" at the step
        reached, then returns. Every loss goes through the watchdog as soon
        as its step ends, before any save of that state: a non-finite or
        frozen loss raises "training unhealthy" and nothing more is saved.
        The budget and the signal are checked before a batch is pulled.

        Returns one record per step: step, loss, lr, whether the params
        moved, ``wait_seconds`` (host clock in ``next()`` on the batches),
        ``seconds`` (host clock from the batch in hand to the loss read,
        which synchronizes the device) and the launches it made of the
        E-step kernel K1 and of the fused block1's forward K2 and backward
        K3.
        """
        cfg = self.cfg
        total = num_steps if num_steps is not None else cfg.train.epochs * self.steps_per_epoch
        lr_drops = ({epoch * self.steps_per_epoch for epoch, _ in cfg.optim.lr_schedule}
                    if cfg.checkpoint.snapshot_on_lr_drop else set())
        every = cfg.checkpoint.save_every_steps
        watchdog = LossWatchdog()
        records = []
        stop_step = None
        with GracefulShutdown() as shutdown, contextlib.ExitStack() as stack:
            if cfg.data.prefetch > 0 and not isinstance(batches, DevicePrefetcher):
                batches = DevicePrefetcher(batches, self.device, depth=cfg.data.prefetch,
                                           limit=max(total - state.step, 0))
                stack.callback(batches.close)
            stack.callback(self.checkpointer.wait)
            it = iter(batches)
            while state.step < total:
                if stop_step is None and shutdown.requested_uniform():
                    stop_step = shutdown.agreed_stop_step(state.step)
                if stop_step is not None and state.step >= stop_step:
                    self.checkpointer.save(state, "norm")
                    break
                t0 = time.perf_counter()
                batch = next(it, None)
                wait = time.perf_counter() - t0
                if batch is None:
                    break
                if state.step in lr_drops:
                    self.checkpointer.save(state, "lr")
                launches = (k1.launches, k23.launches, k23.bwd_launches)
                t0 = time.perf_counter()
                metrics = self.train_step(state, batch)
                loss = float(metrics["loss"])  # synchronizes the device
                seconds = time.perf_counter() - t0
                step = state.step - 1
                reason = watchdog.check(loss)
                if reason is not None:
                    raise RuntimeError(f"training unhealthy at step {step}: {reason}")
                record = {
                    "step": step,
                    "loss": loss,
                    "lr": lr_at(cfg.optim, self.steps_per_epoch, step),
                    "updated": metrics["updated"],
                    "wait_seconds": wait,
                    "seconds": seconds,
                    "estep_launches": k1.launches - launches[0],
                    "block1_fwd_launches": k23.launches - launches[1],
                    "block1_bwd_launches": k23.bwd_launches - launches[2],
                }
                records.append(record)
                if log_fn is not None:
                    log_fn(record)
                if every and step // every < state.step // every:
                    self.checkpointer.save(state, "norm")
        return records
