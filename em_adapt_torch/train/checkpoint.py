"""Full-state checkpoints with ``torch.save``.

The counterpart of ``em_adapt_tpu/train/checkpoint.py`` (Orbax there). A
checkpoint is the whole :class:`TrainState` resume unit (params, momentum
buffers, accumulator, accumulation position, step, generator state), so a
restore continues bit for bit, the LR schedule's position included.

Layout: ``save_dir/<tag>/<step>/state.pt``. Tags: "norm", the rolling saves
(the newest ``max_to_keep`` kept, reference network.py:100), "lr", a
snapshot right before each LR drop (every one kept, reference
deeplab.py:248), and "best", rolling like "norm". A file is written under a
temporary name, flushed to disk and renamed into place, so a write killed
midway leaves the earlier steps as they were and is never listed, and a
second save of one step replaces the first whole (the newest write wins).
With ``async_save`` the state is copied to host memory inside
:meth:`CheckpointManager.save` and written on a thread; :meth:`wait` joins
it and raises what it raised.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import threading

import torch

from em_adapt_torch.config import CheckpointConfig
from em_adapt_torch.train.state import TrainState

STATE_FILE = "state.pt"
#: Tags that keep only their newest ``max_to_keep`` steps; "lr" keeps all.
ROLLING_TAGS = ("norm", "best")


def to_host(tree):
    """A copy of ``tree`` with every tensor copied to host memory."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        if cfg.max_to_keep < 1:
            raise ValueError(f"checkpoint.max_to_keep must be >= 1, got {cfg.max_to_keep}")
        self.cfg = cfg
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None

    def step_dir(self, tag: str, step: int) -> str:
        return os.path.join(self.cfg.save_dir, tag, str(step))

    def all_steps(self, tag: str = "norm") -> list[int]:
        """The steps of ``tag`` whose file is complete, oldest first."""
        root = os.path.join(self.cfg.save_dir, tag)
        try:
            names = os.listdir(root)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names
                      if n.isdigit() and os.path.isfile(os.path.join(root, n, STATE_FILE)))

    def latest_step(self, tag: str = "norm") -> int | None:
        steps = self.all_steps(tag)
        return steps[-1] if steps else None

    def save(self, state: TrainState, tag: str = "norm") -> None:
        """Save ``state`` at its step under ``tag``. Returns once the state
        is copied to host memory (async) or written (sync); the caller may
        then go on updating ``state`` in place."""
        self.wait()  # one write at a time, in order; raises a failed earlier one
        host = to_host(state.state_dict())
        if self.cfg.async_save:
            self._writer = threading.Thread(target=self._write_recorded, args=(host, tag),
                                            name=f"checkpoint-{tag}-{host['step']}")
            self._writer.start()
        else:
            self._write(host, tag)

    def _write_recorded(self, host: dict, tag: str) -> None:
        try:
            self._write(host, tag)
        except BaseException as e:  # noqa: BLE001 — handed to wait(), which raises it
            self._error = e

    def _write(self, host: dict, tag: str) -> None:
        step_dir = self.step_dir(tag, host["step"])
        os.makedirs(step_dir, exist_ok=True)
        tmp = os.path.join(step_dir, f"{STATE_FILE}.tmp{os.getpid()}")
        try:
            with open(tmp, "wb") as f:
                torch.save(host, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(step_dir, STATE_FILE))
        except BaseException:
            with contextlib.suppress(FileNotFoundError):
                os.remove(tmp)
            raise
        fd = os.open(step_dir, os.O_RDONLY)  # make the rename durable
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if tag in ROLLING_TAGS:
            for old in self.all_steps(tag)[:-self.cfg.max_to_keep]:
                shutil.rmtree(self.step_dir(tag, old))

    def wait(self) -> None:
        """Block until the write in flight is on disk; raise if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def load(self, tag: str = "norm", step: int | None = None) -> dict:
        """The saved state dict of ``step`` (default: the latest) on the host."""
        self.wait()
        step = self.latest_step(tag) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.cfg.save_dir}/{tag}")
        return torch.load(os.path.join(self.step_dir(tag, step), STATE_FILE),
                          map_location="cpu", weights_only=True)

    def restore(self, state: TrainState, tag: str = "norm", step: int | None = None) -> TrainState:
        """Load the full state of ``step`` (default: the latest) into ``state``."""
        state.load_state_dict(self.load(tag, step))
        return state

    def restore_params(self, model: torch.nn.Module, tag: str = "norm",
                       step: int | None = None) -> int:
        """Load only the parameters into ``model`` (for evaluation: a
        checkpoint written under another optimizer config loads too).
        Returns the checkpoint's step."""
        sd = self.load(tag, step)
        model.load_state_dict(sd["params"])
        return int(sd["step"])

    def close(self) -> None:
        self.wait()
