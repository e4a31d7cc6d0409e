"""DeepLab-LargeFOV (VGG-16 + atrous head) as a PyTorch module.

Architecture (reference deeplab.py:35-107): five VGG blocks of 3x3 SAME
convs + ReLU (conv5 at atrous rate 2), 3x3 SAME max pools of stride 2
after blocks 1-3 and stride 1 after blocks 4-5 (output stride 8: 321 ->
41), fc6 = 4x4 atrous rate 4, fc7 = 1x1, fc8 = 1x1 to C classes, TF1
keep-prob dropout after relu6 and relu7; raw fc8 logits out.

Inside, activations are NCHW and weights OIHW. At the boundary the port
keeps the JAX package's layouts: parameters as ``{layer: {"w": HWIO,
"b": [C]}}`` (:func:`init_params`, :mod:`em_adapt_torch.models.convert`)
and logits as NHWC float32 (a view of the NCHW result).

``compute_dtype="bfloat16"`` keeps the whole trunk in bf16 as the JAX
package does (deeplab.py:349-352): one cast at the entry, the weights
cast per conv, f32 logits out. ``block1_impl="pallas"`` runs block 1
through the fused block (:mod:`em_adapt_torch.ops.block1`: the CUDA
kernels K2 forward and K3 backward on the card), in training and at
inference; ``"auto"`` picks it where it applies on the card and is the
faster (:meth:`DeepLabLargeFOV._block1_mode`). ``remat=True`` recomputes
each VGG block's activations in the backward
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does (deeplab.py:
338-347).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from em_adapt_torch.config import ModelConfig
from em_adapt_torch.data.augment import normalize_uint8
from em_adapt_torch.models.registry import get_model, register_model
from em_adapt_torch.ops.block1 import block1_fused, block1_supported
from em_adapt_torch.ops.conv import conv2d_same
from em_adapt_torch.ops.pooling import max_pool_same
from em_adapt_torch.ops.resize import resize_bilinear_tf

# (name, kh, kw, in_ch, out_ch, atrous_rate), reference deeplab.py:133-141.
VGG_CONV_SPECS: tuple[tuple[str, int, int, int, int, int], ...] = (
    ("conv1_1", 3, 3, 3, 64, 1),
    ("conv1_2", 3, 3, 64, 64, 1),
    ("conv2_1", 3, 3, 64, 128, 1),
    ("conv2_2", 3, 3, 128, 128, 1),
    ("conv3_1", 3, 3, 128, 256, 1),
    ("conv3_2", 3, 3, 256, 256, 1),
    ("conv3_3", 3, 3, 256, 256, 1),
    ("conv4_1", 3, 3, 256, 512, 1),
    ("conv4_2", 3, 3, 512, 512, 1),
    ("conv4_3", 3, 3, 512, 512, 1),
    ("conv5_1", 3, 3, 512, 512, 2),
    ("conv5_2", 3, 3, 512, 512, 2),
    ("conv5_3", 3, 3, 512, 512, 2),
)

#: Pools after the last conv of each block: (after_layer, stride).
POOLS: dict[str, int] = {
    "conv1_2": 2,
    "conv2_2": 2,
    "conv3_3": 2,
    "conv4_3": 1,
    "conv5_3": 1,
}


def vgg_conv_specs(cfg: ModelConfig) -> tuple[tuple[str, int, int, int, int, int], ...]:
    """The VGG trunk with the config's input channels, conv5 rate and
    width multiplier applied."""
    m = cfg.width_multiplier

    def scale(c: int) -> int:
        return c if m == 1.0 else max(8, int(round(c * m)))

    out = []
    for name, kh, kw, cin, cout, rate in VGG_CONV_SPECS:
        cin = cfg.input_channels if name == "conv1_1" else scale(cin)
        if name.startswith("conv5"):
            rate = cfg.conv5_rate
        out.append((name, kh, kw, cin, scale(cout), rate))
    return tuple(out)


def layer_specs(cfg: ModelConfig) -> tuple[tuple[str, int, int, int, int, int], ...]:
    """All parameterized layers including the atrous-FC head."""
    trunk = vgg_conv_specs(cfg)
    trunk_out = trunk[-1][4]
    return trunk + (
        ("fc6", 4, 4, trunk_out, cfg.fc6_channels, cfg.fc6_rate),
        ("fc7", 1, 1, cfg.fc6_channels, cfg.fc6_channels, 1),
        ("fc8", 1, 1, cfg.fc6_channels, cfg.num_classes, 1),
    )


def _xavier_uniform(generator: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    """TF1 xavier_initializer(uniform=True): U(-l, l), l = sqrt(6/(fi+fo));
    a 1-D bias has fan_in = fan_out = its length (reference deeplab.py:156-167)."""
    if len(shape) == 4:
        rf = shape[0] * shape[1]
        fan_in, fan_out = shape[2] * rf, shape[3] * rf
    else:
        fan_in = fan_out = shape[0]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


def init_params(
    generator: torch.Generator, cfg: ModelConfig, init_model: dict[str, Any] | None = None
) -> dict[str, dict[str, torch.Tensor]]:
    """Parameters ``{layer: {"w": HWIO, "b": [C]}}`` on the generator's device.

    With ``init_model`` (the Caffe-converted init.npy dict) every layer but
    fc8 copies it and fc8 gets Xavier-uniform w and b; without, the
    ``cfg.init_scheme`` draw: "reference" N(0, 0.01) weights and zero bias
    (reference deeplab.py:151-154), or "he" Kaiming-normal fan-in with a
    small fc8.
    """
    params = {}
    for name, kh, kw, cin, cout, _ in layer_specs(cfg):
        shape = (kh, kw, cin, cout)
        if init_model is not None and name != "fc8":
            w = torch.as_tensor(np.asarray(init_model[name]["w"], np.float32))
            b = torch.as_tensor(np.asarray(init_model[name]["b"], np.float32))
            if tuple(w.shape) != shape:
                raise ValueError(
                    f"{name}: init.npy weight shape {tuple(w.shape)} != expected {shape} (HWIO)"
                )
        elif init_model is not None:
            w = _xavier_uniform(generator, shape)
            b = _xavier_uniform(generator, (cout,))
        elif cfg.init_scheme == "he" and name != "fc8":
            w = math.sqrt(2.0 / (kh * kw * cin)) * torch.randn(shape, generator=generator)
            b = torch.zeros(cout)
        elif cfg.init_scheme in ("he", "reference"):
            w = 0.01 * torch.randn(shape, generator=generator)
            b = torch.zeros(cout)
        else:
            raise ValueError(f"model.init_scheme={cfg.init_scheme!r}: expected 'reference' or 'he'")
        params[name] = {"w": w, "b": b}
    return params


def build_model(cfg: ModelConfig, seed: int, device: torch.device) -> "DeepLabLargeFOV":
    """The model ``cfg.name`` names, with fresh parameters on ``device``:
    the Caffe init.npy of ``cfg.init_model_path`` or the
    ``cfg.init_scheme`` draw, made on the CPU from ``seed`` so that a seed
    gives the same weights everywhere."""
    cls = get_model(cfg.name)
    init_model = load_caffe_init(cfg.init_model_path) if cfg.init_model_path else None
    params = init_params(torch.Generator().manual_seed(seed), cfg, init_model)
    return cls(cfg).load_params(params).to(device)


def load_caffe_init(path: str) -> dict[str, Any]:
    """The Caffe-converted init.npy: {layer: {"w": HWIO, "b": [C]}}
    (np.load latin1 pickle, reference deeplab.py:126-129)."""
    return np.load(path, encoding="latin1", allow_pickle=True).item()


def dropout(
    x: torch.Tensor,
    keep_prob: float,
    *,
    generator: torch.Generator | None = None,
    mask: torch.Tensor | None = None,
    shard: tuple[int, int] = (0, 1),
) -> torch.Tensor:
    """TF1 ``tf.nn.dropout``: keep with probability ``keep_prob`` and scale
    kept values by 1/keep_prob. ``mask`` (bool, x's shape) injects the keep
    pattern; otherwise it is drawn from ``generator``: with ``shard=(rank,
    n)`` the mask of the whole world's batch (n times x's rows) is drawn
    and rows ``[rank·B, (rank+1)·B)`` kept, so that n processes with one
    seed draw what one process draws for their batches together."""
    if mask is None:
        rank, n = shard
        b = x.shape[0]
        mask = torch.rand((b * n, *x.shape[1:]), generator=generator,
                          device=x.device)[rank * b:(rank + 1) * b] < keep_prob
    return torch.where(mask, x / keep_prob, torch.zeros_like(x))


class _Conv(nn.Module):
    def __init__(self, kh: int, kw: int, cin: int, cout: int, rate: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout))
        self.rate = rate

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        return conv2d_same(x, self.weight, self.bias, rate=self.rate, compute_dtype=compute_dtype)


@register_model("deeplab_largefov")
class DeepLabLargeFOV(nn.Module):
    """``model(x, train=..., generator=...)`` -> NHWC float32 logits.

    Built with empty parameters; :meth:`load_params` (or
    ``load_state_dict(from_jax_params(...))``) fills them.
    """

    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleDict(
            {name: _Conv(kh, kw, cin, cout, rate) for name, kh, kw, cin, cout, rate in layer_specs(cfg)}
        )

    def load_params(self, params: dict[str, dict[str, Any]]) -> "DeepLabLargeFOV":
        """Copy ``{layer: {"w": HWIO, "b": [C]}}`` into the module."""
        from em_adapt_torch.models.convert import from_jax_params

        self.load_state_dict(from_jax_params(params))
        return self

    def _block1_mode(self, h: int, w: int, device: torch.device) -> str:
        """"pallas" (the fused block, K2 and K3 on the card) or "xla" (the
        conv path). "auto" picks the fused block wherever it applies: on
        the card, in bf16, at full width, on a square odd input; elsewhere,
        the CPU included, the conv path. It is the faster there in
        inference and in training alike (chip_smoke.py, NVIDIA H100 80GB
        HBM3 at 700 W; PERF.md): K2 alone 0.47 against 0.96 ms for the
        cuDNN chain at B=6; block 1's forward and weight gradients through
        K2+K3 2.280 against 2.613 ms at B=6 and 10.908 against 11.342 ms at
        the folded B=30. "pallas" forces it and raises where it cannot
        run, by the JAX package's rules (deeplab.py:224-269): a square odd
        input, and bf16 on the card."""
        impl = self.cfg.block1_impl
        if impl == "xla":
            return "xla"
        if impl == "auto":
            fits = (device.type == "cuda" and self.cfg.compute_dtype == "bfloat16"
                    and self.layers["conv1_1"].weight.shape[0] == 64 and block1_supported(h, w))
            return "pallas" if fits else "xla"
        if impl != "pallas":
            raise ValueError(f"model.block1_impl={impl!r}: expected 'auto', 'xla' or 'pallas'")
        if not block1_supported(h, w):
            raise ValueError(
                f"model.block1_impl='pallas' does not support input {h}x{w} "
                "(needs square odd sizes); use 'xla'"
            )
        if device.type == "cuda" and self.cfg.compute_dtype != "bfloat16":
            raise ValueError(
                "model.block1_impl='pallas' on the card requires compute_dtype='bfloat16' "
                "(the kernel computes in bf16); use 'xla' or 'auto'"
            )
        return "pallas"

    def _block(self, h: torch.Tensor, names: tuple[str, ...], cdt) -> torch.Tensor:
        """One VGG block: its convs with ReLU, then its pool."""
        for name in names:
            h = F.relu(self.layers[name](h, cdt), inplace=True)
            if name in POOLS:
                h = max_pool_same(h, 3, POOLS[name])
        return h

    def forward(
        self,
        x: torch.Tensor,
        *,
        train: bool = False,
        generator: torch.Generator | None = None,
        masks: tuple[torch.Tensor, torch.Tensor] | None = None,
        shard: tuple[int, int] = (0, 1),
    ) -> torch.Tensor:
        """x [B,H,W,3]: float is preprocessed (BGR, mean-subtracted); uint8
        is raw RGB and is normalized here, on x's device. In training,
        dropout masks come from ``masks`` (two bool NCHW tensors, after
        relu6 and relu7) or are drawn from ``generator``, as the rows
        ``shard`` (rank, world size) names of the world batch's masks
        (:func:`dropout`).
        Returns f32 logits [B, ceil(H/8), ceil(W/8), C] (NHWC view)."""
        if train and masks is None and generator is None:
            raise ValueError("train=True needs a dropout generator or masks")
        cdt = torch.bfloat16 if self.cfg.compute_dtype == "bfloat16" else None
        h = normalize_uint8(x).permute(0, 3, 1, 2).contiguous()
        if cdt is not None:
            h = h.to(cdt)
        names = [spec[0] for spec in vgg_conv_specs(self.cfg)]
        if self._block1_mode(h.shape[2], h.shape[3], h.device) == "pallas":
            c1, c2 = self.layers["conv1_1"], self.layers["conv1_2"]
            h = block1_fused(h, c1.weight, c1.bias, c2.weight, c2.bias)
            names = names[2:]
        remat = self.cfg.remat and torch.is_grad_enabled()
        while names:
            end = next(i for i, name in enumerate(names) if name in POOLS) + 1
            block, names = tuple(names[:end]), names[end:]
            if remat:
                h = checkpoint(self._block, h, block, cdt, use_reentrant=False)
            else:
                h = self._block(h, block, cdt)
        keep = self.cfg.dropout_keep_prob
        for i, name in enumerate(("fc6", "fc7")):
            h = F.relu(self.layers[name](h, cdt), inplace=True)
            if train:
                h = dropout(h, keep, generator=generator, mask=None if masks is None else masks[i],
                            shard=shard)
        return self.layers["fc8"](h, cdt).float().permute(0, 2, 3, 1)

    def predict(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Bilinear (TF1 grid) upsampled logits at input resolution and
        their argmax (reference network.py:39-41)."""
        up = resize_bilinear_tf(self(x), (x.shape[1], x.shape[2]))
        return up, up.argmax(3)

    def weight_l2(self) -> torch.Tensor:
        """Sum of 0.5*||w||^2 over conv weights only, biases excluded
        (tf.nn.l2_loss over the weights, reference deeplab.py:184)."""
        return sum(0.5 * layer.weight.square().sum() for layer in self.layers.values())
