"""The weights of a run, made on the device from the seed in one draw.

``reference``: the reference's own init (xtudbxk/em-adapt-tensorflow
``deeplab.py:151-154``), N(0, 0.01) weights and zero biases. ``he``:
Kaiming-normal weights (std sqrt(2 / fan_in)) with fc8 at N(0, 0.01) and
zero biases, under which the network's scores keep their scale through
the 16 layers (under the reference init they shrink to about 1e-8).
Weights are OIHW float32; :func:`hwio` gives the ``{layer: {"w": HWIO,
"b"}}`` layout through which the port loads parameters.
"""

from __future__ import annotations

import math

import torch

import work


def make(scheme: str, seed: int, device, **widths) -> dict:
    """{layer: {"w": OIHW f32, "b": f32}} on ``device``."""
    specs = work.layers(**widths)
    sizes = [kh * kw * cin * cout for _, kh, kw, cin, cout, _ in specs]
    gen = torch.Generator(device=device).manual_seed((seed * 2654435761 + 7) % 2 ** 63)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    params, off = {}, 0
    for (name, kh, kw, cin, cout, _), n in zip(specs, sizes):
        if scheme == "reference" or name == "fc8":
            std = 0.01
        elif scheme == "he":
            std = math.sqrt(2.0 / (kh * kw * cin))
        else:
            raise ValueError(f"weights {scheme!r}: expected 'reference' or 'he'")
        w = flat[off:off + n].view(cout, cin, kh, kw).mul_(std)
        params[name] = {"w": w, "b": torch.zeros(cout, device=device)}
        off += n
    return params


def hwio(params: dict) -> dict:
    return {n: {"w": p["w"].permute(2, 3, 1, 0), "b": p["b"]} for n, p in params.items()}
