"""The plain reference of DeepLab-v2 ResNet-101's EM training step, in
PyTorch.

Follows the published network (Chen et al., arXiv:1606.00915 §3.2 and
§4.1.3, Table 4's ResNet-101 + ASPP rows; the DeepLab-v2 release's
ResNet-101 VOC12 ``train.prototxt``): conv1 7x7 of stride 2 (pad 3),
frozen BN, ReLU, a 3x3 max pool of stride 2 (TF SAME: 321 -> 161 -> 81);
four stages of bottlenecks with [3, 4, 23, 3] blocks, 1x1 (mid) -> 3x3
(mid) -> 1x1 (out), frozen BN after each conv, ReLU after the first two,
ReLU(branch + shortcut) at the end, the shortcut a 1x1 projection with
frozen BN in each stage's first block; res3's first block strides by 2
on its 1x1s, res4's 3x3s at atrous rate 2 and res5's at rate 4 (output
stride 8); the ASPP-L head, four 3x3 convs to the classes at rates 6, 12,
18 and 24 (pad = rate) with biases, summed. Frozen BN is the explicit
affine gamma * (y - mean) / sqrt(var + 1e-5) + beta. No dropout; the
single-scale network (the paper's MSC inputs left out).

The training step is ``reference/model.py``'s: the adaptive E-step on the
score map, the mean cross-entropy over all pixels plus the weight decay
of 0.5 ||w||^2 over the weights (no bias, no BN statistic), SGD with
heavy-ball momentum. A batch is computed in blocks of ``chunk`` images
(the E-step's batch max needs every image's logits: a forward without
gradient over the blocks, the E-step, then a forward and backward a
block), so that float32 activations of a batch of 30 at 321x321 need
not fit at once.

Float32 throughout, TF32 off. ``quant=True`` computes every convolution
(forward and both gradients) from fp8 e4m3 operands with a per-tensor
scale: the control, one precision below the bf16 that the configuration
states. Weights are ``{conv: {"w": OIHW}}`` for a trunk conv and ``{"w",
"b"}`` for an ASPP branch, in forward order; the frozen statistics
``{conv: {"gamma", "beta", "mean", "var"}}`` are apart from them (they are
no leaf of the training step). It imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.model import _Fp8, estep, exact_float32, normalize, resize_nearest_tf

#: (stage, blocks, mid width, out width, stride of its first block, atrous
#: rate of its 3x3 convs).
STAGES = (
    ("res2", 3, 64, 256, 1, 1),
    ("res3", 4, 128, 512, 2, 1),
    ("res4", 23, 256, 1024, 1, 2),
    ("res5", 3, 512, 2048, 1, 4),
)
ASPP_RATES = (6, 12, 18, 24)
EPS = 1e-5
#: :func:`calibrate`'s gamma of each residual branch's last BN (branch2c).
RESIDUAL_GAMMA = 0.1


def _scale(c: int, width: float) -> int:
    return c if width == 1.0 else max(8, int(round(c * width)))


def blocks() -> list[tuple[str, str, int, int, bool]]:
    """(stage, block name, stride, atrous rate, projection shortcut) of
    every bottleneck, in order."""
    out = []
    for stage, n, _, _, stride, rate in STAGES:
        names = ["a", "b", "c"] if n == 3 else ["a"] + [f"b{i}" for i in range(1, n)]
        out += [(stage, f"{stage}{s}", stride if i == 0 else 1, rate, i == 0)
                for i, s in enumerate(names)]
    return out


def layers(num_classes: int = 21, width: float = 1.0, **_) -> list[tuple]:
    """(name, k, cin, cout, stride, rate, bias) of every conv in forward
    order: 43,943,188 parameters at width 1 with 21 classes."""
    stem = _scale(64, width)
    out, cin = [("conv1", 7, 3, stem, 2, 1, False)], stem
    widths = {stage: (_scale(mid, width), _scale(o, width)) for stage, _, mid, o, _, _ in STAGES}
    for stage, name, stride, rate, proj in blocks():
        mid, o = widths[stage]
        if proj:
            out.append((f"{name}_branch1", 1, cin, o, stride, 1, False))
        out += [(f"{name}_branch2a", 1, cin, mid, stride, 1, False),
                (f"{name}_branch2b", 3, mid, mid, 1, rate, False),
                (f"{name}_branch2c", 1, mid, o, 1, 1, False)]
        cin = o
    out += [(f"fc1_voc12_c{i}", 3, cin, num_classes, 1, r, True)
            for i, r in enumerate(ASPP_RATES)]
    return out


def conv(x: torch.Tensor, w: torch.Tensor, stride: int, rate: int,
         quant: bool = False) -> torch.Tensor:
    """Caffe's convolution: symmetric pad (k-1)/2 * rate, the stride."""
    if quant:
        x, w = _Fp8.apply(x), _Fp8.apply(w)
    y = F.conv2d(x, w, stride=stride, padding=(w.shape[2] - 1) // 2 * rate, dilation=rate)
    return _Fp8.apply(y) if quant else y


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 TF SAME max pool of stride 2 (ceil(H/2) outputs)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, 2)


def frozen_bn(y: torch.Tensor, s: dict, fit: float | None = None) -> torch.Tensor:
    """The frozen BN's affine of ``y`` [B,C,H,W]; with ``fit`` its
    statistics are first set from ``y``: mean and (biased) variance per
    channel, gamma ``fit``, beta 0."""
    if fit is not None:
        s["mean"] = y.mean((0, 2, 3))
        s["var"] = y.var((0, 2, 3), unbiased=False)
        s["gamma"] = torch.full_like(s["mean"], fit)
        s["beta"] = torch.zeros_like(s["mean"])
    c = (slice(None), None, None)
    return (y - s["mean"][c]) / torch.sqrt(s["var"][c] + EPS) * s["gamma"][c] + s["beta"][c]


def forward(params: dict, stats: dict, image: torch.Tensor, *, quant: bool = False,
            fit: bool = False) -> torch.Tensor:
    """Logits NHWC float32 of uint8 RGB (or normalized float) NHWC images.
    With ``fit`` each frozen BN's statistics are set from its input first
    (:func:`calibrate`)."""
    # Strides and rates do not depend on the widths.
    spec = {name: (stride, rate) for name, _, _, _, stride, rate, _ in layers()}

    def cbn(h, name):
        stride, rate = spec[name]
        gamma = (RESIDUAL_GAMMA if name.endswith("_branch2c") else 1.0) if fit else None
        return frozen_bn(conv(h, params[name]["w"], stride, rate, quant), stats[name], gamma)

    h = normalize(image)
    h = max_pool_same(F.relu(cbn(h, "conv1")))
    for _, name, _, _, proj in blocks():
        short = cbn(h, f"{name}_branch1") if proj else h
        y = F.relu(cbn(h, f"{name}_branch2a"))
        y = F.relu(cbn(y, f"{name}_branch2b"))
        h = F.relu(cbn(y, f"{name}_branch2c") + short)
    logits = 0.0
    for i, rate in enumerate(ASPP_RATES):
        p = params[f"fc1_voc12_c{i}"]
        logits = logits + conv(h, p["w"], 1, rate, quant) + p["b"][:, None, None]
    return logits.permute(0, 2, 3, 1)


@torch.no_grad()
def calibrate(params: dict, stats: dict, images: torch.Tensor) -> None:
    """Set every frozen BN's statistics in place, layer by layer, to the
    per-channel mean and variance of its input over ``images``, with beta
    0 and gamma 1, but :data:`RESIDUAL_GAMMA` for each residual branch's
    last BN: every BN then standardizes its input, as ImageNet-trained
    statistics do (identity statistics would let the residual stream
    double through the 23 blocks of res4), and the branches add to the
    stream at a small gain, as a trained ResNet's do. Under an N(0, 0.01)
    trunk the first SGD steps at lr 1e-3 go non-finite at gamma 1 (by
    step 2) and on some seeds at 0.2 (by step 5); a frozen BN scales its
    conv's weight gradient by gamma over the conv output's deviation, which
    an N(0, 0.01) weight keeps small."""
    exact_float32()
    forward(params, stats, images, fit=True)


def weight_l2(params: dict) -> torch.Tensor:
    return sum(0.5 * p["w"].square().sum() for p in params.values())


class Trainer:
    """The reference's training steps from given weights and frozen
    statistics (``params.frozen``: :mod:`weights_r101`): ``step(batch)``
    returns (loss, logits, weak labels) and updates ``params`` every
    ``accum`` microbatches. The gradient of the loss is the
    cross-entropy's (autograd) plus the weight decay's ``wd * w`` on each
    weight. ``keep`` is accepted for the VGG reference's signature: the
    network has no dropout, and a step draws only the E-step's class
    orders from ``generator``."""

    def __init__(self, params: dict, *, lr: float, momentum: float, weight_decay: float,
                 accum: int, keep: float, generator: torch.Generator, num_classes: int = 21,
                 rounds: int = 5, quant: bool = False, chunk: int = 10):
        self.params = {n: {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
                       for n, p in params.items()}
        self.stats = params.frozen
        self.leaves = [(f"{n}.{k}", v) for n, p in self.params.items() for k, v in p.items()]
        self.lr, self.momentum, self.wd, self.accum = lr, momentum, weight_decay, accum
        self.generator, self.num_classes, self.rounds, self.quant = (generator, num_classes,
                                                                     rounds, quant)
        self.chunk = chunk
        self.acc = [torch.zeros_like(v) for _, v in self.leaves]
        self.buf = None
        self.mini = 0
        self.first_grad = None  # the first microbatch's gradient, weight decay's term in
        self.first_data_grad = None  # and the cross-entropy's alone

    def _forward(self, image):
        return forward(self.params, self.stats, image, quant=self.quant)

    def step(self, batch: dict):
        image, label = batch["image"], batch["label"][..., 0]
        b = image.shape[0]
        dev = self.generator.device
        orders = torch.stack([torch.randperm(self.num_classes - 1, generator=self.generator,
                                             device=dev) + 1 for _ in range(self.rounds)])
        blocks_ = [slice(i, min(i + self.chunk, b)) for i in range(0, b, self.chunk)]
        with torch.no_grad():
            logits = torch.cat([self._forward(image[s]) for s in blocks_])
        hw = tuple(logits.shape[1:3])
        shrunk = label if tuple(label.shape[1:]) == hw else resize_nearest_tf(label, hw)
        with torch.no_grad():
            weak = estep(logits, shrunk, orders)
        pixels = weak.numel()
        data = [torch.zeros_like(v) for _, v in self.leaves]
        ce_sum = 0.0
        for s in blocks_:
            z = self._forward(image[s])
            ce = F.cross_entropy(z.permute(0, 3, 1, 2), weak[s], reduction="sum") / pixels
            for d, g in zip(data, torch.autograd.grad(ce, [v for _, v in self.leaves])):
                d.add_(g)
            ce_sum = ce_sum + ce.detach()
        with torch.no_grad():
            loss = ce_sum + self.wd * weight_l2(self.params)
            grads = [g + self.wd * v if name.endswith(".w") else g
                     for (name, v), g in zip(self.leaves, data)]
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini + 1))
            if self.first_grad is None:
                self.first_grad = [a.clone() for a in self.acc]
                self.first_data_grad = [g.clone() for g in data]
            self.mini += 1
            if self.mini == self.accum:
                if self.buf is None:
                    self.buf = [a.clone() for a in self.acc]
                else:
                    for m, a in zip(self.buf, self.acc):
                        m.mul_(self.momentum).add_(a)
                for (_, v), m in zip(self.leaves, self.buf):
                    v.sub_(self.lr * m)
                for a in self.acc:
                    a.zero_()
                self.mini = 0
        return loss.detach(), logits, weak
