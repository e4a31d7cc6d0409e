"""Parameter interchange with the JAX package.

The JAX package keeps ``{layer: {"w": HWIO, "b": [C]}}`` (also the layout
of the Caffe-converted init.npy); the port's module keeps OIHW weights.
These two functions convert between them without changing a bit, so both
packages compute with the same weights and init.npy files interchange.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def from_jax_params(params: dict[str, dict[str, Any]]) -> dict[str, torch.Tensor]:
    """``{layer: {"w": HWIO, "b"}}`` (numpy or tensors) -> the state dict of
    :class:`~em_adapt_torch.models.deeplab.DeepLabLargeFOV`."""
    def tensor(a) -> torch.Tensor:
        return a if torch.is_tensor(a) else torch.from_numpy(np.array(a, np.float32))

    state = {}
    for name, p in params.items():
        state[f"layers.{name}.weight"] = tensor(p["w"]).permute(3, 2, 0, 1).contiguous()
        state[f"layers.{name}.bias"] = tensor(p["b"]).clone()
    return state


def to_jax_params(model_or_state) -> dict[str, dict[str, np.ndarray]]:
    """A module or its state dict -> ``{layer: {"w": HWIO, "b"}}`` numpy."""
    state = model_or_state.state_dict() if hasattr(model_or_state, "state_dict") else model_or_state
    out: dict[str, dict[str, np.ndarray]] = {}
    for key, t in state.items():
        _, name, kind = key.split(".")
        t = t.detach().to("cpu")
        if kind == "weight":
            out.setdefault(name, {})["w"] = t.permute(2, 3, 1, 0).contiguous().numpy()
        else:
            out.setdefault(name, {})["b"] = t.clone().numpy()
    return out
