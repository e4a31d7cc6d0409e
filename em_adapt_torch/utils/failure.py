"""Preemption handling and the loss watchdog.

The counterpart of ``em_adapt_tpu/utils/failure.py``. ``GracefulShutdown``
traps SIGTERM (the preemption signal) and SIGINT: the first one sets a
flag, and the training loop saves the full state and returns at its next
step boundary; a second one goes to the handler that was there before.
``LossWatchdog`` flags a non-finite loss, and a loss that stays bit for
bit the same for ``patience`` checks (a dead pipeline or a zero LR).

Single process: the agreement between processes on the stop step comes
with multi-GPU training (ROADMAP.md Queue 1 item 11).
"""

from __future__ import annotations

import math
import signal
import threading


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
        """Whether any process was asked to stop: one process, so the local flag."""
        return self._flag.is_set()

    def agreed_stop_step(self, proposal: int) -> int:
        """The step every process stops at: one process, so ``proposal``."""
        return proposal

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
