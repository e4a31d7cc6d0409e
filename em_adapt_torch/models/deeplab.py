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

On a mesh of processes (``plan``, ``parallel/mesh.py::MeshPlan``) the
module holds this rank's part: under a ``model`` axis of n, fc6's
``cout/n`` output channels and fc7's ``cin/n`` input channels
(``parallel/tensor.py``); with ``strip=True`` (a ``space`` axis) the input
is this rank's rows of the image, every conv and pool runs on row strips
with halo exchanges (``parallel/spatial.py``), and the logits are this
rank's rows of the score map.
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
from em_adapt_torch.parallel.mesh import MeshPlan
from em_adapt_torch.parallel.spatial import conv_rows, pool_rows, row_split
from em_adapt_torch.parallel.tensor import copy_to_model, reduce_from_model, shard_params

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
) -> dict[str, dict[str, Any]]:
    """Fresh parameters of the architecture ``cfg.name`` names, in the
    layout its ``load_params`` takes: the model class's ``init_params``
    (:func:`vgg_init_params` for DeepLab-LargeFOV)."""
    return get_model(cfg.name).init_params(generator, cfg, init_model)


def vgg_init_params(
    generator: torch.Generator, cfg: ModelConfig, init_model: dict[str, Any] | None = None
) -> dict[str, dict[str, torch.Tensor]]:
    """DeepLab-LargeFOV's parameters ``{layer: {"w": HWIO, "b": [C]}}`` on
    the generator's device.

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


def build_model(cfg: ModelConfig, seed: int, device: torch.device,
                plan: MeshPlan | None = None) -> nn.Module:
    """The model ``cfg.name`` names, with fresh parameters on ``device``:
    the Caffe init.npy of ``cfg.init_model_path`` or the
    ``cfg.init_scheme`` draw, made on the CPU from ``seed`` so that a seed
    gives the same weights everywhere. On a mesh (``plan``) every rank
    draws the whole model and keeps its part, so a world starts from the
    weights that one process starts from."""
    cls = get_model(cfg.name)
    init_model = load_caffe_init(cfg.init_model_path) if cfg.init_model_path else None
    params = cls.init_params(torch.Generator().manual_seed(seed), cfg, init_model)
    return cls(cfg, plan=plan).load_params(params).to(device)


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
    channels: tuple[int, int, int] | None = None,
    rows: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    """TF1 ``tf.nn.dropout``: keep with probability ``keep_prob`` and scale
    kept values by 1/keep_prob. ``mask`` (bool, x's shape) injects the keep
    pattern; otherwise it is drawn from ``generator`` as the mask of the
    whole world's batch at the whole width and height, of which this rank
    keeps its slices: with ``shard=(d, n)`` (the data group: n data
    indices) the images ``[d·B, (d+1)·B)`` of n times x's; with
    ``channels=(lo, hi, c)`` (the model group: fc6's channels on this
    model rank) channels ``[lo, hi)`` of c; with ``rows=(lo, hi, h)`` (the
    space group) rows ``[lo, hi)`` of h. So the ranks of a world with one
    seed draw what one process draws for their batches together."""
    if mask is None:
        d, n = shard
        b = x.shape[0]
        shape = [b * n, *x.shape[1:]]
        if channels is not None:
            shape[1] = channels[2]
        if rows is not None:
            shape[2] = rows[2]
        mask = torch.rand(shape, generator=generator, device=x.device)[d * b:(d + 1) * b]
        if channels is not None:
            mask = mask[:, channels[0]:channels[1]]
        if rows is not None:
            mask = mask[:, :, rows[0]:rows[1]]
        mask = mask < keep_prob
    return torch.where(mask, x / keep_prob, torch.zeros_like(x))


class _Conv(nn.Module):
    def __init__(self, kh: int, kw: int, cin: int, cout: int, rate: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout))
        self.rate = rate

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        return conv2d_same(x, self.weight, self.bias, rate=self.rate, compute_dtype=compute_dtype)


def require_vgg(cfg: ModelConfig, what: str) -> None:
    """Raise for an architecture other than DeepLab-LargeFOV on a path that
    walks VGG's layer table (``what`` names the path)."""
    if cfg.name != "deeplab_largefov":
        raise ValueError(f"{what} runs only model.name='deeplab_largefov' (VGG-16 "
                         f"DeepLab-LargeFOV); model.name={cfg.name!r} has no VGG layer table")


@register_model("deeplab_largefov")
class DeepLabLargeFOV(nn.Module):
    """``model(x, train=..., generator=...)`` -> NHWC float32 logits.

    Built with empty parameters; :meth:`load_params` (or
    ``load_state_dict(from_jax_params(...))``) fills them. ``plan``: this
    rank's place on a mesh of processes (default: one process).
    """

    #: The classifier head's layers: the Caffe LR groups' x10/x20
    #: (``train/optim.py::lr_group``).
    HEAD = ("fc8",)
    #: Input pixels per score-map pixel a side: ceil(H/8) rows of logits
    #: (the pools' strides, :data:`POOLS`; 321 -> 41, 513 -> 65).
    output_stride = math.prod(POOLS.values())
    init_params = staticmethod(vgg_init_params)

    def __init__(self, cfg: ModelConfig = ModelConfig(), plan: MeshPlan | None = None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan or MeshPlan()
        n = self.plan.num_model_shards
        if cfg.fc6_channels % n:
            raise ValueError(f"model.fc6_channels={cfg.fc6_channels} does not divide over a "
                             f"model axis of {n}")
        layers = {}
        for name, kh, kw, cin, cout, rate in layer_specs(cfg):
            if name == "fc6":
                cout //= n
            elif name == "fc7":
                cin //= n
            layers[name] = _Conv(kh, kw, cin, cout, rate)
        self.layers = nn.ModuleDict(layers)

    def load_params(self, params: dict[str, dict[str, Any]]) -> "DeepLabLargeFOV":
        """Copy ``{layer: {"w": HWIO, "b": [C]}}``, the whole model, into the
        module (this model rank's slices of it on a model axis)."""
        from em_adapt_torch.models.convert import from_jax_params

        plan = self.plan
        self.load_state_dict(from_jax_params(
            shard_params(params, plan.model_index, plan.num_model_shards)))
        return self

    def _block1_mode(self, h: int, w: int, device: torch.device, strip: bool = False) -> str:
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
        input, and bf16 on the card. On row strips (``strip``, a space
        axis) "auto" takes the conv path, as the JAX package takes XLA
        there, and "pallas" raises: the fused kernel has no halo exchange."""
        impl = self.cfg.block1_impl
        if impl == "xla" or (strip and impl == "auto"):
            return "xla"
        if strip and impl == "pallas":
            raise ValueError(
                "model.block1_impl='pallas' cannot run on a space axis above 1: the fused block 1 "
                "has no halo exchange between row strips; use 'auto' or 'xla'")
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

    def _conv(self, name: str, h: torch.Tensor, cdt, rows: int | None) -> torch.Tensor:
        """Layer ``name`` on ``h``: the whole tensor, or this rank's rows of
        a ``rows``-row one."""
        layer = self.layers[name]
        if rows is None:
            return layer(h, cdt)
        return conv_rows(h, layer.weight, layer.bias, rate=layer.rate, compute_dtype=cdt,
                         plan=self.plan, h=rows)

    def _block(self, h: torch.Tensor, names: tuple[str, ...], cdt,
               rows: int | None = None) -> torch.Tensor:
        """One VGG block: its convs with ReLU, then its pool (on row strips
        of a ``rows``-row input where ``rows`` is given)."""
        for name in names:
            h = F.relu(self._conv(name, h, cdt, rows), inplace=True)
            if name in POOLS:
                if rows is None:
                    h = max_pool_same(h, 3, POOLS[name])
                else:
                    h, _ = pool_rows(h, 3, POOLS[name], plan=self.plan, h=rows)
        return h

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
        is raw RGB and is normalized here, on x's device. In training,
        dropout masks come from ``masks`` (two bool NCHW tensors of this
        rank's part, after relu6 and relu7) or are drawn from ``generator``
        as this rank's slices of the world batch's masks (:func:`dropout`):
        the images ``shard`` (data index, data shards) names, and on a mesh
        its channels and rows.
        Returns f32 logits [B, ceil(H/8), ceil(W/8), C] (NHWC view). With
        ``strip`` on a space axis of n, x holds this rank's H/n rows of the
        image and the logits its rows of the score map
        (``parallel/spatial.py::row_split``)."""
        if train and masks is None and generator is None:
            raise ValueError("train=True needs a dropout generator or masks")
        cdt = torch.bfloat16 if self.cfg.compute_dtype == "bfloat16" else None
        h = normalize_uint8(x).permute(0, 3, 1, 2).contiguous()
        if cdt is not None:
            h = h.to(cdt)
        names = [spec[0] for spec in vgg_conv_specs(self.cfg)]
        plan = self.plan
        strip = strip and plan.num_space_shards > 1
        rows = h.shape[2] * plan.num_space_shards if strip else None
        if self._block1_mode(h.shape[2], h.shape[3], h.device, strip) == "pallas":
            c1, c2 = self.layers["conv1_1"], self.layers["conv1_2"]
            h = block1_fused(h, c1.weight, c1.bias, c2.weight, c2.bias)
            names = names[2:]
        remat = self.cfg.remat and torch.is_grad_enabled()
        while names:
            end = next(i for i, name in enumerate(names) if name in POOLS) + 1
            block, names = tuple(names[:end]), names[end:]
            if remat:
                h = checkpoint(self._block, h, block, cdt, rows, use_reentrant=False)
            else:
                h = self._block(h, block, cdt, rows)
            if rows is not None:
                rows = -(-rows // POOLS[block[-1]])
        keep = self.cfg.dropout_keep_prob
        n = plan.num_model_shards
        own = None if rows is None else (*row_split(rows, plan.num_space_shards)[plan.space_index],
                                         rows)
        c6, m = self.cfg.fc6_channels, plan.model_index
        channels = None if n == 1 else (m * c6 // n, (m + 1) * c6 // n, c6)
        h = F.relu(self._conv("fc6", copy_to_model(h, plan), cdt, rows), inplace=True)
        if train:
            h = dropout(h, keep, generator=generator, mask=None if masks is None else masks[0],
                        shard=shard, channels=channels, rows=own)
        if n > 1:  # row-parallel fc7: the model group's partial sums, then the whole bias
            fc7 = self.layers["fc7"]
            h = reduce_from_model(conv2d_same(h, fc7.weight, compute_dtype=cdt), plan)
            h = h + fc7.bias.to(h.dtype)[:, None, None]
        else:
            h = self.layers["fc7"](h, cdt)
        h = F.relu(h, inplace=True)
        if train:
            h = dropout(h, keep, generator=generator, mask=None if masks is None else masks[1],
                        shard=shard, rows=own)
        return self.layers["fc8"](h, cdt).float().permute(0, 2, 3, 1)

    def predict(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Bilinear (TF1 grid) upsampled logits at input resolution and
        their argmax (reference network.py:39-41)."""
        up = resize_bilinear_tf(self(x), (x.shape[1], x.shape[2]))
        return up, up.argmax(3)

    def weight_l2(self) -> torch.Tensor:
        """Sum of 0.5*||w||^2 over conv weights only, biases excluded
        (tf.nn.l2_loss over the weights, reference deeplab.py:184). On a
        model axis the sharded weights' sums are added over the model
        group for the value (the whole model's), while each shard's
        gradient stays its own (``parallel/tensor.py::reduce_from_model``)."""
        if self.plan.num_model_shards == 1:
            return sum(0.5 * layer.weight.square().sum() for layer in self.layers.values())
        sharded = ("fc6", "fc7")
        whole = sum(0.5 * layer.weight.square().sum() for name, layer in self.layers.items()
                    if name not in sharded)
        parts = sum(0.5 * self.layers[name].weight.square().sum() for name in sharded)
        return whole + reduce_from_model(parts, self.plan)
