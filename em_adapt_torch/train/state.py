"""The train state: the whole unit that a checkpoint saves and restores.

The counterpart of ``em_adapt_tpu/train/state.py``: the model's
parameters, the optimizer's momentum buffers, gradient accumulator and
accumulation position, the microbatch step, and the state of the
``torch.Generator`` that draws the dropout masks and the E-step's class
orders. Restoring all of it continues a run bit for bit where it stopped,
mid-accumulation included.
"""

from __future__ import annotations

import dataclasses

import torch

from em_adapt_torch.models.deeplab import DeepLabLargeFOV
from em_adapt_torch.train.optim import AccumulatingSGD

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@dataclasses.dataclass
class TrainState:
    model: DeepLabLargeFOV
    optimizer: AccumulatingSGD
    generator: torch.Generator
    step: int = 0

    def state_dict(self) -> dict:
        """The resume unit as tensors and plain containers. The tensors are
        the live ones (the generator's is a new CPU byte tensor)."""
        return {
            "params": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, sd: dict) -> None:
        """Copy ``sd`` (from :meth:`state_dict`) into this state, in place;
        raises when its parameters or optimizer layout differ."""
        self.model.load_state_dict(sd["params"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.generator.set_state(sd["generator"])
        self.step = int(sd["step"])


def bitwise_diff(a, b, path: str = "") -> list[str]:
    """The paths at which two state dicts differ: in structure, type,
    dtype, shape or any bit (so -0.0 differs from +0.0, and a NaN equals
    the same NaN). Tensors are compared on ``a``'s device."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        if a.dtype != b.dtype or a.shape != b.shape:
            return [path]
        bits = _BITS[a.element_size()]
        same = torch.equal(a.detach().view(bits), b.detach().to(a.device).view(bits))
        return [] if same else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return [path]
        return [d for k in a for d in bitwise_diff(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if type(a) is not type(b) or len(a) != len(b):
            return [path]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in bitwise_diff(x, y, f"{path}/{i}")]
    return [] if type(a) is type(b) and a == b else [path]
