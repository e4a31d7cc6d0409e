"""A plain float32 PyTorch reference of DeepLab-v2 ResNet-101 with ASPP-L
and of one EM training step on it, for the CPU tests of
``em_adapt_torch/models/resnet.py``.

The network of Chen et al., arXiv:1606.00915 (§3.2, §4.1.3, Table 4's
ResNet-101 + ASPP rows; the DeepLab-v2 release's ResNet-101 VOC12
``train.prototxt``): conv1 7x7/2 (pad 3) -> frozen BN -> ReLU -> 3x3/2 max
pool (TF SAME); [3, 4, 23, 3] bottlenecks 1x1 -> 3x3 -> 1x1 with frozen
BN after each conv, ReLU after the first two and after the residual add,
a projection shortcut (1x1 + frozen BN) in each stage's first block,
res3a strided by 2 on its 1x1s, res4's 3x3s at rate 2 and res5's at rate
4; the ASPP-L head, four 3x3 convs at rates 6, 12, 18, 24 with biases,
summed. Written from the paper and the prototxt with ``F.conv2d`` and
explicit padding, the explicit affine gamma * (y - mean) / sqrt(var +
1e-5) + beta, ReLU and add; it imports nothing of ``em_adapt_torch`` or
JAX.

Weights are ``{conv: {"w": OIHW}}`` (``"b"`` too for an ASPP branch); the
frozen statistics ``{conv: {"gamma", "beta", "mean", "var"}}``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: (stage, blocks, mid, out, stride of the first block, rate of the 3x3s)
STAGES = (("res2", 3, 64, 256, 1, 1), ("res3", 4, 128, 512, 2, 1),
          ("res4", 23, 256, 1024, 1, 2), ("res5", 3, 512, 2048, 1, 4))
ASPP_RATES = (6, 12, 18, 24)
EPS = 1e-5
#: :func:`calibrate`'s gamma of each residual branch's last BN.
RESIDUAL_GAMMA = 0.1
#: The Caffe mean, BGR.
BGR_MEAN = (104.00698793, 116.66876762, 122.67891434)


def exact_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _blocks():
    """(block name, stride, rate, projection) in order."""
    for stage, n, _, _, stride, rate in STAGES:
        names = ["a", "b", "c"] if n == 3 else ["a"] + [f"b{i}" for i in range(1, n)]
        for i, s in enumerate(names):
            yield f"{stage}{s}", stride if i == 0 else 1, rate, i == 0


def convs(num_classes: int = 21, width: float = 1.0) -> list[tuple]:
    """(name, k, cin, cout, stride, rate, bias) of every conv in order."""
    def w(c):
        return c if width == 1.0 else max(8, int(round(c * width)))

    out, cin = [("conv1", 7, 3, w(64), 2, 1, False)], w(64)
    mids = {stage: (w(mid), w(o)) for stage, _, mid, o, _, _ in STAGES}
    for name, stride, rate, proj in _blocks():
        mid, o = mids[name[:4]]
        if proj:
            out.append((f"{name}_branch1", 1, cin, o, stride, 1, False))
        out += [(f"{name}_branch2a", 1, cin, mid, stride, 1, False),
                (f"{name}_branch2b", 3, mid, mid, 1, rate, False),
                (f"{name}_branch2c", 1, mid, o, 1, 1, False)]
        cin = o
    return out + [(f"fc1_voc12_c{i}", 3, cin, num_classes, 1, r, True)
                  for i, r in enumerate(ASPP_RATES)]


def init(generator: torch.Generator, num_classes: int = 21, width: float = 1.0,
         trunk_std: float | None = 0.01) -> tuple[dict, dict]:
    """Seeded weights (the trunk's N(0, trunk_std), or Kaiming-normal where
    ``trunk_std`` is None; ASPP's N(0, 0.01)), zero ASPP biases and
    identity statistics."""
    params, stats = {}, {}
    for name, k, cin, cout, _, _, bias in convs(num_classes, width):
        std = 0.01 if bias else trunk_std or (2.0 / (k * k * cin)) ** 0.5
        params[name] = {"w": std * torch.randn(cout, cin, k, k, generator=generator)}
        if bias:
            params[name]["b"] = torch.zeros(cout)
        else:
            stats[name] = {"gamma": torch.ones(cout), "beta": torch.zeros(cout),
                           "mean": torch.zeros(cout), "var": torch.ones(cout)}
    return params, stats


def normalize(image: torch.Tensor) -> torch.Tensor:
    """uint8 RGB NHWC -> BGR minus the mean, NCHW float32."""
    mean = torch.tensor(BGR_MEAN, dtype=torch.float32, device=image.device)
    return (image.to(torch.float32).flip(-1) - mean).permute(0, 3, 1, 2)


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool of stride 2, TF SAME (ceil(H/2), the extra pad high)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, 2)


def forward(params: dict, stats: dict, image: torch.Tensor, *, fit: bool = False) -> torch.Tensor:
    """f32 logits NHWC; with ``fit`` every frozen BN's statistics are set
    from its input first (:func:`calibrate`)."""
    spec = {name: (stride, rate) for name, _, _, _, stride, rate, _ in convs()}

    def cbn(h, name):
        stride, rate = spec[name]
        w = params[name]["w"]
        y = F.conv2d(h, w, stride=stride, padding=(w.shape[2] - 1) // 2 * rate, dilation=rate)
        s = stats[name]
        if fit:
            s["mean"], s["var"] = y.mean((0, 2, 3)), y.var((0, 2, 3), unbiased=False)
            gamma = RESIDUAL_GAMMA if name.endswith("_branch2c") else 1.0
            s["gamma"], s["beta"] = torch.full_like(s["mean"], gamma), torch.zeros_like(s["mean"])
        c = (slice(None), None, None)
        return (y - s["mean"][c]) / torch.sqrt(s["var"][c] + EPS) * s["gamma"][c] + s["beta"][c]

    h = max_pool_same(F.relu(cbn(normalize(image), "conv1")))
    for name, _, _, proj in _blocks():
        short = cbn(h, f"{name}_branch1") if proj else h
        y = F.relu(cbn(h, f"{name}_branch2a"))
        y = F.relu(cbn(y, f"{name}_branch2b"))
        h = F.relu(cbn(y, f"{name}_branch2c") + short)
    logits = 0.0
    for i, rate in enumerate(ASPP_RATES):
        p = params[f"fc1_voc12_c{i}"]
        logits = logits + F.conv2d(h, p["w"], p["b"], padding=rate, dilation=rate)
    return logits.permute(0, 2, 3, 1)


@torch.no_grad()
def calibrate(params: dict, stats: dict, images: torch.Tensor) -> None:
    """Set the frozen statistics layer by layer to each BN's input's
    per-channel mean and variance over ``images``: gamma 1 (the residual
    branches' last BN :data:`RESIDUAL_GAMMA`) and beta 0."""
    forward(params, stats, images, fit=True)


def estep(scores: torch.Tensor, label: torch.Tensor, orders: torch.Tensor, *,
          bg_p: float = 0.4, fg_p: float = 0.2, margin: float = 1e-5) -> torch.Tensor:
    """EM-Adapt's adaptive E-step (arXiv:1502.02734 §3.3): weak labels
    [B,h,w] from scores [B,h,w,C], the label's tags and the visit orders
    [rounds, C-1]."""
    f = scores.clone()
    b, hh, ww, c = f.shape
    classes = torch.arange(c, device=f.device)
    tags = (label.to(torch.int64).reshape(b, -1, 1) == classes).any(1).float()
    present = tags[:, None, None, :] > 0
    pmin = (f + torch.where(present, 0.0, f.amax())).amin(3, keepdim=True)
    f = torch.where(~present & (f > pmin), pmin - margin, f)
    k_bg, k_fg = int(hh * ww * bg_p), int(hh * ww * fg_p)
    for row in orders.tolist():
        for j in [0] + row:
            diff = (f.amax(3) - f[..., j]).reshape(b, -1)
            th = diff.sort(1).values[:, k_bg if j == 0 else k_fg]
            f[..., j] += (th * tags[:, j])[:, None, None]
    return f.argmax(3)


def train_step(params: dict, stats: dict, batch: dict, weak: torch.Tensor, *, lr: float,
               weight_decay: float) -> tuple[torch.Tensor, dict, dict]:
    """One SGD step from a zero momentum buffer with the Caffe LR groups
    (the ASPP head's weights x10, biases x20): (loss, each leaf's
    multiplied gradient, each leaf updated), the leaves keyed (conv,
    "w" or "b"). ``weak``: the targets."""
    leaves = {(n, k): v.detach().clone().requires_grad_(True)
              for n, p in params.items() for k, v in p.items()}
    tree = {}
    for (n, k), v in leaves.items():
        tree.setdefault(n, {})[k] = v
    logits = forward(tree, stats, batch["image"])
    ce = F.cross_entropy(logits.permute(0, 3, 1, 2), weak)
    l2 = sum(0.5 * v.square().sum() for (_, k), v in leaves.items() if k == "w")
    loss = ce + weight_decay * l2
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    out, new = {}, {}
    for (n, k), g in grads.items():
        head = n.startswith("fc1_voc12")
        mult = (20.0 if head else 2.0) if k == "b" else (10.0 if head else 1.0)
        out[(n, k)] = g * mult
        new[(n, k)] = leaves[(n, k)].detach() - lr * out[(n, k)]
    return loss.detach(), out, new
