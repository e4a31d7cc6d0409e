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
* weight decay enters through the loss, not here;
* with ``lr_multipliers`` the Caffe LR groups scale the (accumulated)
  gradient before SGD: bias x2, fc8 weight x10, fc8 bias x20
  (optim.py:79-105). The reference computes them and drops them (a dead
  rebinding loop, reference deeplab.py:194-200), so they default off.
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


#: Gradient multiplier of each Caffe LR group (optim.py:93).
GROUP_MULTIPLIERS = {"weight": 1.0, "bias": 2.0, "fc8_w": 10.0, "fc8_b": 20.0}


def lr_group(name: str) -> str:
    """The LR group of the parameter ``name`` ("layers.<layer>.weight" or
    ".bias", as ``named_parameters`` gives it)."""
    layer, kind = name.split(".")[-2:]
    bias = kind == "bias"
    if layer == "fc8":
        return "fc8_b" if bias else "fc8_w"
    return "bias" if bias else "weight"


class AccumulatingSGD:
    """``optax.MultiSteps(optax.sgd(lr, momentum), accum_steps)`` over
    parameters whose ``.grad`` holds one microbatch's gradient; with
    ``cfg.lr_multipliers`` the ``_scale_by_group`` link before SGD, for
    which ``names`` (one per parameter) are needed."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: OptimConfig,
                 steps_per_epoch: int = 1, names: Iterable[str] | None = None):
        self.params = list(params)
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.multipliers = None
        if cfg.lr_multipliers:
            names = list(names) if names is not None else None
            if names is None or len(names) != len(self.params):
                raise ValueError("optim.lr_multipliers needs one name per parameter")
            self.multipliers = [GROUP_MULTIPLIERS[lr_group(n)] for n in names]
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
        if self.multipliers is not None:
            for p, m in zip(self.params, self.multipliers):
                if m != 1.0:
                    p.grad.mul_(m)
        for group in self.sgd.param_groups:
            group["lr"] = lr_at(self.cfg, self.steps_per_epoch, step)
        self.sgd.step()
        return True

    def state_dict(self) -> dict:
        """Momentum buffers (None where SGD has not made one yet), the
        accumulator and the accumulation position. The tensors are the live
        ones: a caller that keeps them past the next step copies them."""
        return {
            "momentum": [self.sgd.state[p].get("momentum_buffer") if p in self.sgd.state
                         else None for p in self.params],
            "acc": self.acc,
            "mini_step": self.mini_step,
        }

    def load_state_dict(self, sd: dict) -> None:
        """Copy ``sd`` (from :meth:`state_dict`) in; raises when its layout
        is another optimizer config's. A None buffer stays absent, so the
        first update copies its gradient in as SGD does."""
        momentum, acc = sd["momentum"], sd["acc"]
        shapes = [p.shape for p in self.params]
        if (len(momentum) != len(shapes)
                or any(b is not None and b.shape != s for b, s in zip(momentum, shapes))
                or (acc is None) != (self.acc is None)
                or (acc is not None and [a.shape for a in acc] != shapes)):
            raise ValueError("optimizer state does not match this optimizer's parameters "
                             "and accumulation config")
        for p, buf in zip(self.params, momentum):
            if buf is None:
                self.sgd.state.pop(p, None)
            else:
                self.sgd.state[p]["momentum_buffer"] = buf.to(p.device, p.dtype, copy=True)
        if acc is not None:
            for a, src in zip(self.acc, acc):
                a.copy_(src)
        self.mini_step = int(sd["mini_step"])
