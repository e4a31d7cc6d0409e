"""Preemption handling and the loss watchdog.

The counterpart of ``em_adapt_tpu/utils/failure.py``. ``GracefulShutdown``
traps SIGTERM (the preemption signal) and SIGINT: the first one sets a
flag, and the training loop saves the full state and returns at its next
step boundary; a second one goes to the handler that was there before.
``LossWatchdog`` flags a non-finite loss, and a loss that stays bit for
bit the same for ``patience`` checks (a dead pipeline or a zero LR).

In a world of several processes (``parallel/mesh.py``) a signal may reach
only some of them, and they must all stop at one step: the preemption
save is followed by a barrier, and a rank that trained one step more
would wait in a collective its peers never enter. So the flag is agreed
on every step by a host all-reduce (gloo, on host tensors: it does not
wait behind the card's queue) that every rank enters at the same step,
before it pulls a batch; the stop step is then the max of the ranks'
proposals. A failed collective raises; nothing falls back to the local
flag (the JAX package's key-value scheme had a first-writer race and a
silent fallback, ADVICE.md).
"""

from __future__ import annotations

import math
import signal
import threading

import torch
import torch.distributed as dist

from em_adapt_torch.parallel.mesh import world_size


def _world_max(value: int) -> int:
    """The max of ``value`` over the world (a gloo all-reduce of a host
    int64); ``value`` itself on one process."""
    if world_size() == 1:
        return value
    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


class GracefulShutdown:
    """Flag-based signal trap; use as a context manager around the loop.
    Handlers are installed only from the main thread (Python runs them
    there); elsewhere the flag never flips."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._flag = threading.Event()
        self._prev = {}

    @property
    def requested(self) -> bool:
        return self._flag.is_set()

    def requested_uniform(self) -> bool:
        """Whether any process of the world was asked to stop: the max of
        the local flags. Every rank calls it at the same point of each step;
        on one process it is the local flag."""
        return bool(_world_max(int(self._flag.is_set())))

    def agreed_stop_step(self, proposal: int) -> int:
        """The step every process stops at: the max of the ranks'
        proposals, so no rank has to undo a step (each proposes its own
        next step boundary); ``proposal`` on one process."""
        return _world_max(proposal)

    def _handler(self, signum, frame):
        if self._flag.is_set():
            # A second signal: restore the earlier handler and deliver it again.
            signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
            signal.raise_signal(signum)
        self._flag.set()

    def __enter__(self):
        if threading.current_thread() is threading.main_thread():
            for s in self.SIGNALS:
                self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return False


class LossWatchdog:
    """``check(loss)`` returns None while training is healthy, else the
    reason: a non-finite loss, or one bit-identical for ``patience``
    consecutive checks."""

    def __init__(self, patience: int = 50):
        self.patience = patience
        self._last: float | None = None
        self._repeat = 0

    def check(self, loss: float) -> str | None:
        loss = float(loss)
        if not math.isfinite(loss):
            return f"non-finite loss: {loss}"
        if self._last is not None and loss == self._last:
            self._repeat += 1
            if self._repeat >= self.patience:
                return (f"loss frozen at {loss} for {self._repeat} consecutive checks "
                        "(dead pipeline or zero LR?)")
        else:
            self._repeat = 0
        self._last = loss
        return None
