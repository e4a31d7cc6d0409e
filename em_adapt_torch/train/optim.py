"""SGD with momentum, gradient accumulation and the staged LR.

The port of ``em_adapt_tpu/train/optim.py::build_optimizer``
(optim.py:109-137), reference deeplab.py:188-208, :243-262:

* momentum is heavy-ball, ``accum = m*accum + g; var -= lr*accum``
  (tf.train.MomentumOptimizer): ``torch.optim.SGD`` with dampening 0 and
  no Nesterov computes the same;
* gradients are averaged over ``accum_steps`` microbatches with optax
  ``MultiSteps``' running mean, ``acc += (g - acc) / (n + 1)``, and one
  update is applied every ``accum_steps`` microbatches;
* the update emitted at microbatch step s uses the microbatch-indexed LR
  at s (the re-indexing of optim.py:117-128);
* weight decay enters through the loss, not here; LR groups stay off.
"""

from __future__ import annotations

from typing import Iterable

import torch

from em_adapt_torch.config import OptimConfig


def lr_at(cfg: OptimConfig, steps_per_epoch: int, step: int) -> float:
    """Piecewise-constant LR at microbatch ``step``: a boundary's value
    applies from ``step >= epoch * steps_per_epoch`` (optim.py:60-76)."""
    epochs = [e for e, _ in cfg.lr_schedule]
    if len(set(epochs)) != len(epochs):
        raise ValueError(f"optim.lr_schedule has duplicate epoch boundaries: {epochs}")
    lr = float(cfg.base_lr)
    for epoch, val in sorted(cfg.lr_schedule):
        if step >= epoch * steps_per_epoch:
            lr = float(val)
    return lr


class AccumulatingSGD:
    """``optax.MultiSteps(optax.sgd(lr, momentum), accum_steps)`` over
    parameters whose ``.grad`` holds one microbatch's gradient."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: OptimConfig,
                 steps_per_epoch: int = 1):
        self.params = list(params)
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.sgd = torch.optim.SGD(
            self.params, lr=cfg.base_lr, momentum=cfg.momentum, dampening=0.0,
            nesterov=False, weight_decay=0.0,
        )
        self.acc = [torch.zeros_like(p) for p in self.params] if cfg.accum_steps > 1 else None
        self.mini_step = 0

    def step(self, step: int) -> bool:
        """Fold in microbatch ``step``'s gradients; apply an update when the
        accumulation window is full. Returns whether the params moved."""
        if self.acc is not None:
            n = self.mini_step
            for p, a in zip(self.params, self.acc):
                a.add_((p.grad - a) / (n + 1))
            if n < self.cfg.accum_steps - 1:
                self.mini_step += 1
                return False
            for p, a in zip(self.params, self.acc):
                p.grad.copy_(a)
                a.zero_()
            self.mini_step = 0
        for group in self.sgd.param_groups:
            group["lr"] = lr_at(self.cfg, self.steps_per_epoch, step)
        self.sgd.step()
        return True
