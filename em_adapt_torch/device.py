"""Device and dtype helper.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). With no card and no device given,
:func:`resolve_device` raises: nothing carries on quietly on the CPU.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def card_info() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them: the
    label every time on the card is kept beside."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def set_deterministic() -> None:
    """Make cuDNN pick deterministic algorithms, and stop it timing
    candidates (``cudnn.deterministic = True``, ``benchmark = False``):
    two runs of one seed then take the same algorithms and sum in the same
    order. It changes which kernels the card runs, not the model's
    arithmetic. Call it before the model is built."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def set_precision(compute_dtype: str = "float32") -> None:
    """Pin float32 math to true float32, for either compute dtype.

    Sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False``: cuDNN runs float32
    convolutions in TF32 by default, which keeps about three decimal
    digits. This is the counterpart of the JAX package's
    ``precision="highest"`` for float32 convolutions (ops/conv.py:55).
    Under "bfloat16" the model's convolutions and their gradients take
    bf16 operands, and the f32 convolutions left (the plain versions of
    the fused block1's forward and backward) stay f32.
    """
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype={compute_dtype!r}: expected 'float32' or 'bfloat16'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
