"""DeepLab-v2 ResNet-101 with ASPP-L as a PyTorch module.

The network of Chen, Papandreou, Kokkinos, Murphy and Yuille, "DeepLab:
Semantic Image Segmentation with Deep Convolutional Nets, Atrous
Convolution, and Fully Connected CRFs" (arXiv:1606.00915, TPAMI 2017,
§3.2 and §4.1.3, Table 4's ResNet-101 + ASPP rows), layer for layer as the
DeepLab-v2 release's ResNet-101 VOC12 ``train.prototxt`` has it; Caffe's
layer names:

* **Stem.** ``conv1``: 7x7, stride 2, pad 3, 64 channels, no bias; frozen
  BN; ReLU. A 3x3 max pool of stride 2 (TF SAME, ceil(H/2):
  ``ops/pooling.py::max_pool_same``): 321 -> 161 -> 81.
* **Bottlenecks.** Four stages of Caffe-MSRA bottlenecks with [3, 4, 23,
  3] blocks (``res2a``-``res2c``, ``res3a``, ``res3b1``-``res3b3``,
  ``res4a``, ``res4b1``-``res4b22``, ``res5a``-``res5c``), widths
  (mid/out) 64/256, 128/512, 256/1024 and 512/2048. A block x -> y:

      a = ReLU(BN(conv1x1_mid(x)))                  # branch2a
      b = ReLU(BN(conv3x3_mid(a, rate)))            # branch2b, pad = rate
      y = ReLU(BN(conv1x1_out(b)) + s)              # branch2c
      s = x, or BN(conv1x1_out(x)) in a stage's first block (branch1)

  Only res3's first block strides (2, on branch2a and branch1); res4's
  3x3 convs have atrous rate 2 and res5's rate 4, so the output stride is
  8: 321 -> 41, 513 -> 65 (ceil(H/8)).
* **Frozen BN.** BatchNorm with ``use_global_stats: true`` and Scale with
  ``lr_mult: 0``: y = gamma * (x - mean) / sqrt(var + 1e-5) + beta with
  gamma, beta, mean and var fixed. They are buffers (``layers.<conv>.
  gamma``, ``.beta``, ``.mean``, ``.var``), saved with the state and never
  trained. Every trunk conv has one and no bias.
* **ASPP-L head.** Four 3x3 convs from 2,048 channels to the classes at
  rates 6, 12, 18 and 24 (pad = rate), each with a bias
  (``fc1_voc12_c0``-``c3``); their outputs are summed into the logits.
  These are the model's :attr:`DeepLabV2ResNet101.HEAD` (LR x10 weights,
  x20 biases under ``optim.lr_multipliers``). No dropout.

43,943,188 trainable parameters at the published widths (42,394,816 in
the trunk, 1,548,372 in ASPP; :func:`num_params`).

One departure: the published best model also trains on multi-scale
inputs (MSC: scales 1, 0.75 and 0.5, max-fused), which would change the
score map that the E-step sees; this is the single-scale network.

Computation: each frozen BN is folded into its conv at every forward, w
* s and a shift t = beta - mean * s with s = gamma / sqrt(var + eps),
both in float32 from the buffers (exact under autograd: the gradient
still flows to w through the product). With ``compute_dtype="bfloat16"``
the input is cast once at the entry, each folded weight is cast to bf16
per conv, the conv's bf16 output gets the shift added in bf16 (the
rounding rule of ``ops/conv.py::conv2d_same``), the ReLUs and residual
adds run in bf16, and the four ASPP outputs are summed in float32 into
f32 logits. ``remat=True`` recomputes each bottleneck in the backward
pass (``torch.utils.checkpoint``).

The forward opens the stage spans ``resnet.stem``, ``resnet.res2`` ...
``resnet.res5`` and ``resnet.aspp`` (``utils/tracing.py``), inside the
training step's ``step.forward``.

DeepLab-LargeFOV's VGG-only paths refuse this model with an error that
names it: the fused block 1 (``model.block1_impl="pallas"``), the mesh's
``model`` axis (fc6/fc7 tensor parallelism) and a ``space`` axis above 1
(here, at construction), int8 PTQ (``eval/quantize.py``), TF1 checkpoint
import (``models/tf_import.py``) and the npy interchange
(``eval/export.py``).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from em_adapt_torch.config import ModelConfig
from em_adapt_torch.data.augment import normalize_uint8
from em_adapt_torch.models.registry import register_model
from em_adapt_torch.ops.conv import conv2d_same
from em_adapt_torch.ops.pooling import max_pool_same
from em_adapt_torch.ops.resize import resize_bilinear_tf
from em_adapt_torch.parallel.mesh import MeshPlan
from em_adapt_torch.utils import tracing

NAME = "deeplab_v2_resnet101"
#: (stage, blocks, mid width, out width, stride of its first block, atrous
#: rate of its 3x3 convs).
STAGES = (
    ("res2", 3, 64, 256, 1, 1),
    ("res3", 4, 128, 512, 2, 1),
    ("res4", 23, 256, 1024, 1, 2),
    ("res5", 3, 512, 2048, 1, 4),
)
#: The ASPP-L branches' atrous rates (``fc1_voc12_c0``-``c3``).
ASPP_RATES = (6, 12, 18, 24)
#: Caffe BatchNorm's epsilon.
BN_EPS = 1e-5


class ConvSpec(NamedTuple):
    """One conv: Caffe's layer name, kernel size, channels in and out,
    stride, atrous rate, and whether it has a bias (an ASPP branch) rather
    than a frozen BN (a trunk conv)."""

    name: str
    k: int
    cin: int
    cout: int
    stride: int = 1
    rate: int = 1
    bias: bool = False


class Block(NamedTuple):
    """One bottleneck: its name and its convs' names (``branch1`` None for
    an identity shortcut)."""

    name: str
    branch2a: str
    branch2b: str
    branch2c: str
    branch1: str | None


def _block_suffixes(n: int) -> list[str]:
    """Caffe ResNet-101's block names in a stage of ``n``: a, b, c for
    three blocks, else a, b1, b2, ..."""
    return list("abc") if n == 3 else ["a"] + [f"b{i}" for i in range(1, n)]


def _width(cfg: ModelConfig, c: int) -> int:
    """A published width under ``cfg.width_multiplier`` (at least 8
    channels; other multipliers than 1 serve the CPU tests only)."""
    m = cfg.width_multiplier
    return c if m == 1.0 else max(8, int(round(c * m)))


#: Each stage's name and blocks.
Stages = tuple[tuple[str, tuple[Block, ...]], ...]


def architecture(cfg: ModelConfig) -> tuple[tuple[ConvSpec, ...], Stages]:
    """(every conv in forward order, each stage's blocks) at the config's
    width and classes."""
    stem = _width(cfg, 64)
    convs = [ConvSpec("conv1", 7, cfg.input_channels, stem, stride=2)]
    stages, cin = [], stem
    for stage, n, mid, out, stride, rate in STAGES:
        mid, out = _width(cfg, mid), _width(cfg, out)
        blocks = []
        for i, suffix in enumerate(_block_suffixes(n)):
            name = f"{stage}{suffix}"
            first = i == 0
            s = stride if first else 1
            branch1 = f"{name}_branch1" if first else None
            if first:
                convs.append(ConvSpec(branch1, 1, cin, out, stride=s))
            convs += [ConvSpec(f"{name}_branch2a", 1, cin, mid, stride=s),
                      ConvSpec(f"{name}_branch2b", 3, mid, mid, rate=rate),
                      ConvSpec(f"{name}_branch2c", 1, mid, out)]
            blocks.append(Block(name, f"{name}_branch2a", f"{name}_branch2b",
                                f"{name}_branch2c", branch1))
            cin = out
        stages.append((stage, tuple(blocks)))
    convs += [ConvSpec(f"fc1_voc12_c{i}", 3, cin, cfg.num_classes, rate=r, bias=True)
              for i, r in enumerate(ASPP_RATES)]
    return tuple(convs), tuple(stages)


def conv_specs(cfg: ModelConfig) -> tuple[ConvSpec, ...]:
    """Every conv of the network, in forward order."""
    return architecture(cfg)[0]


def num_params(cfg: ModelConfig) -> int:
    """Trainable parameters (conv weights and the ASPP biases; the frozen
    BN statistics are buffers), from the specs: 43,943,188 at the
    published widths with 21 classes."""
    return sum(s.k * s.k * s.cin * s.cout + (s.cout if s.bias else 0) for s in conv_specs(cfg))


def init_params(generator: torch.Generator, cfg: ModelConfig,
                init_model: dict[str, Any] | None = None) -> dict[str, dict[str, torch.Tensor]]:
    """Parameters ``{conv: {"w": HWIO, ...}}`` on the generator's device: a
    trunk conv's weight with its frozen BN (``gamma`` 1, ``beta`` 0,
    ``mean`` 0, ``var`` 1), an ASPP branch's weight and bias ``b``.
    ``cfg.init_scheme`` "reference" draws every weight from N(0, 0.01);
    "he" the trunk's Kaiming-normal (fan-in) and ASPP's N(0, 0.01). Biases
    are zero."""
    if init_model is not None:
        raise ValueError(f"model.init_model_path: model.name={NAME!r} has no converter for the "
                         "DeepLab-v2 ImageNet init.caffemodel yet; leave it unset (random init)")
    if cfg.init_scheme not in ("reference", "he"):
        raise ValueError(f"model.init_scheme={cfg.init_scheme!r}: expected 'reference' or 'he'")
    params = {}
    for s in conv_specs(cfg):
        std = math.sqrt(2.0 / (s.k * s.k * s.cin)) if cfg.init_scheme == "he" and not s.bias \
            else 0.01
        p = {"w": std * torch.randn((s.k, s.k, s.cin, s.cout), generator=generator)}
        if s.bias:
            p["b"] = torch.zeros(s.cout)
        else:
            p.update(gamma=torch.ones(s.cout), beta=torch.zeros(s.cout),
                     mean=torch.zeros(s.cout), var=torch.ones(s.cout))
        params[s.name] = p
    return params


#: ``load_params``' keys of a conv's leaves besides ``w``, and the module's
#: names of them.
_LEAVES = {"b": "bias", "gamma": "gamma", "beta": "beta", "mean": "mean", "var": "var"}


class _ConvBN(nn.Module):
    """A bias-free conv and its frozen BN, folded into it at each call."""

    def __init__(self, s: ConvSpec):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(s.cout, s.cin, s.k, s.k))
        for name in ("gamma", "beta", "mean", "var"):
            self.register_buffer(name, torch.empty(s.cout))
        self.stride, self.rate = s.stride, s.rate

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype | None) -> torch.Tensor:
        with torch.no_grad():
            scale = self.gamma * torch.rsqrt(self.var + BN_EPS)
            shift = self.beta - self.mean * scale
        return conv2d_same(x, self.weight * scale[:, None, None, None], shift, rate=self.rate,
                           stride=self.stride, compute_dtype=compute_dtype)


class _Conv(nn.Module):
    """An ASPP branch: a 3x3 atrous conv with a bias."""

    def __init__(self, s: ConvSpec):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(s.cout, s.cin, s.k, s.k))
        self.bias = nn.Parameter(torch.empty(s.cout))
        self.rate = s.rate

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype | None) -> torch.Tensor:
        return conv2d_same(x, self.weight, self.bias, rate=self.rate, compute_dtype=compute_dtype)


@register_model(NAME)
class DeepLabV2ResNet101(nn.Module):
    """``model(x, train=..., generator=...)`` -> NHWC float32 logits, the
    forward contract of ``DeepLabLargeFOV``: ``train``, ``generator``,
    ``masks`` and ``shard`` are accepted and draw nothing (no dropout).

    Built with empty parameters and buffers; :meth:`load_params` fills
    them. ``plan``: this rank's place on a mesh of processes, whose data
    axis alone this model takes (``DistributedDataParallel``).
    """

    HEAD = tuple(f"fc1_voc12_c{i}" for i in range(len(ASPP_RATES)))
    output_stride = 8
    init_params = staticmethod(init_params)

    def __init__(self, cfg: ModelConfig = ModelConfig(name=NAME), plan: MeshPlan | None = None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan or MeshPlan()
        if cfg.block1_impl == "pallas":
            raise ValueError(f"model.block1_impl='pallas' runs VGG's fused block 1 (K2/K3); "
                             f"model.name={NAME!r} has none: use 'xla' or 'auto'")
        if self.plan.num_model_shards > 1:
            raise ValueError(f"the mesh's 'model' axis shards DeepLab-LargeFOV's fc6/fc7; "
                             f"model.name={NAME!r} has no fc6/fc7: train it on the data axis")
        if self.plan.num_space_shards > 1:
            raise ValueError(f"a 'space' axis above 1 runs DeepLab-LargeFOV's row strips; "
                             f"model.name={NAME!r} has none: train it on the data axis")
        convs, stages = architecture(cfg)
        self.layers = nn.ModuleDict({s.name: (_Conv if s.bias else _ConvBN)(s) for s in convs})
        self._stages = tuple((f"resnet.{stage}", blocks) for stage, blocks in stages)

    def load_params(self, params: dict[str, dict[str, Any]]) -> "DeepLabV2ResNet101":
        """Copy ``{conv: {"w": HWIO, and "b" or "gamma", "beta", "mean",
        "var"}}`` (:func:`init_params`' layout) into the module."""
        def tensor(a) -> torch.Tensor:
            return torch.as_tensor(a, dtype=torch.float32)

        state = {}
        for name, p in params.items():
            state[f"layers.{name}.weight"] = tensor(p["w"]).permute(3, 2, 0, 1).contiguous()
            for key, leaf in _LEAVES.items():
                if key in p:
                    state[f"layers.{name}.{leaf}"] = tensor(p[key]).clone()
        self.load_state_dict(state)
        return self

    def _bottleneck(self, h: torch.Tensor, block: Block, cdt) -> torch.Tensor:
        layers = self.layers
        short = h if block.branch1 is None else layers[block.branch1](h, cdt)
        y = F.relu(layers[block.branch2a](h, cdt), inplace=True)
        y = F.relu(layers[block.branch2b](y, cdt), inplace=True)
        y = layers[block.branch2c](y, cdt)
        return F.relu(y.add_(short), inplace=True)

    def forward(
        self,
        x: torch.Tensor,
        *,
        train: bool = False,
        generator: torch.Generator | None = None,
        masks: tuple[torch.Tensor, torch.Tensor] | None = None,
        shard: tuple[int, int] = (0, 1),
        strip: bool = False,
    ) -> torch.Tensor:
        """x [B,H,W,3]: float is preprocessed (BGR, mean-subtracted); uint8
        is raw RGB and is normalized here, on x's device. Returns f32
        logits [B, ceil(H/8), ceil(W/8), C] (NHWC view)."""
        cdt = torch.bfloat16 if self.cfg.compute_dtype == "bfloat16" else None
        h = normalize_uint8(x).permute(0, 3, 1, 2).contiguous()
        if cdt is not None:
            h = h.to(cdt)
        with tracing.span("resnet.stem", stage=True):
            h = F.relu(self.layers["conv1"](h, cdt), inplace=True)
            h = max_pool_same(h, 3, 2)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for span, blocks in self._stages:
            with tracing.span(span, stage=True):
                for block in blocks:
                    if remat:
                        h = checkpoint(self._bottleneck, h, block, cdt, use_reentrant=False)
                    else:
                        h = self._bottleneck(h, block, cdt)
        with tracing.span("resnet.aspp", stage=True):
            logits = None
            for name in self.HEAD:
                y = self.layers[name](h, cdt).float()
                logits = y if logits is None else logits + y
        return logits.permute(0, 2, 3, 1)

    def predict(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Bilinear (TF1 grid) upsampled logits at input resolution and
        their argmax, as ``DeepLabLargeFOV.predict``."""
        up = resize_bilinear_tf(self(x), (x.shape[1], x.shape[2]))
        return up, up.argmax(3)

    def weight_l2(self) -> torch.Tensor:
        """0.5 * ||w||^2 over every conv weight: no bias and no BN buffer.
        One reduction over the weights laid end to end (108 of them)."""
        flat = torch.cat([layer.weight.reshape(-1) for layer in self.layers.values()])
        return 0.5 * flat.square().sum()
