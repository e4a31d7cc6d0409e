"""The weights of a DeepLab-v2 ResNet-101 run, made on the device from the
seed in one draw.

DeepLab-v2's reference init is an ImageNet-trained trunk (its
``init.caffemodel``, not in the repository) and the ASPP branches from
N(0, 0.01) with zero biases (the prototxt's gaussian filler).
``reference`` draws every conv, trunk and ASPP, from N(0, 0.01), with zero
ASPP biases. The frozen BN statistics start at the identity (gamma 1,
beta 0, mean 0, var 1) and :func:`calibrate` sets them from a batch by the
reference's ``calibrate``: every BN then standardizes its input, as
ImageNet-trained statistics do, and each residual branch's last BN
scales its output by the reference's ``RESIDUAL_GAMMA`` (0.1), as a
trained ResNet's branches add to the stream at a small gain (under this
trunk the first SGD steps at lr 1e-3 go non-finite at gamma 1, and on
some seeds at 0.2).
"""

from __future__ import annotations

import torch

from reference import deeplab_v2 as ref


class Params(dict):
    """``{conv: {"w": OIHW f32}}`` (``{"w", "b"}`` for an ASPP branch) in
    forward order, the training step's leaves; ``frozen``: ``{conv:
    {"gamma", "beta", "mean", "var"}}`` of the trunk's convs."""

    frozen: dict


def make(scheme: str, seed: int, device, num_classes: int = 21, width: float = 1.0,
         **_) -> Params:
    """The weights at the configuration's classes and width (the VGG
    cells' ``fc6_channels`` is ignored) on ``device``."""
    if scheme != "reference":
        raise ValueError(f"weights {scheme!r}: expected 'reference'")
    specs = ref.layers(num_classes, width)
    sizes = [k * k * cin * cout for _, k, cin, cout, _, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed((seed * 2654435761 + 7) % 2 ** 63)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    params, off = Params(), 0
    params.frozen = {}
    for (name, k, cin, cout, _, _, bias), n in zip(specs, sizes):
        params[name] = {"w": flat[off:off + n].view(cout, cin, k, k).mul_(0.01)}
        if bias:
            params[name]["b"] = torch.zeros(cout, device=device)
        else:
            params.frozen[name] = {
                "gamma": torch.ones(cout, device=device), "beta": torch.zeros(cout, device=device),
                "mean": torch.zeros(cout, device=device), "var": torch.ones(cout, device=device)}
        off += n
    return params


def calibrate(params: Params, images: torch.Tensor) -> None:
    """Set the frozen statistics from ``images`` (the reference's
    ``calibrate``, float32, layer by layer)."""
    ref.calibrate(params, params.frozen, images)


def hwio(params: Params) -> dict:
    """The ``{conv: {"w": HWIO, "b" or "gamma", "beta", "mean", "var"}}``
    layout through which the port loads the network."""
    return {n: {"w": p["w"].permute(2, 3, 1, 0), **{k: v for k, v in p.items() if k != "w"},
                **params.frozen.get(n, {})} for n, p in params.items()}
