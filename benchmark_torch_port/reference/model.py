"""The plain reference of DeepLab-LargeFOV's EM training step, in PyTorch.

Follows the published network (Papandreou et al., arXiv:1502.02734 §4;
xtudbxk/em-adapt-tensorflow ``deeplab.py:35-280``): VGG-16 with conv5 at
rate 2, fc6 4x4 at rate 4, fc7 1x1, fc8 1x1 to the classes, TF SAME
padding for convolutions and 3x3 max pools, TF1 keep-prob dropout after
relu6 and relu7; the adaptive E-step (bg 40%, fg 20%, five rounds, absent
classes clamped below the present ones); the mean cross-entropy over all
pixels plus the weight decay of 0.5 ||w||^2 over the weights; SGD with
heavy-ball momentum and a running mean over the accumulated microbatches.

Float32 throughout, TF32 off. ``quant=True`` computes every convolution
(forward and both gradients) from fp8 e4m3 operands with a per-tensor
scale: the control, one precision below the bf16 that the configuration
states. Weights are ``{layer: {"w": OIHW, "b": [C]}}``. It imports
nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: (name, atrous rate, stride of the pool after it or 0).
LAYERS = (
    ("conv1_1", 1, 0), ("conv1_2", 1, 2),
    ("conv2_1", 1, 0), ("conv2_2", 1, 2),
    ("conv3_1", 1, 0), ("conv3_2", 1, 0), ("conv3_3", 1, 2),
    ("conv4_1", 1, 0), ("conv4_2", 1, 0), ("conv4_3", 1, 1),
    ("conv5_1", 2, 0), ("conv5_2", 2, 0), ("conv5_3", 2, 1),
    ("fc6", 4, 0), ("fc7", 1, 0), ("fc8", 1, 0),
)
#: The Caffe mean, BGR.
BGR_MEAN = (104.00698793, 116.66876762, 122.67891434)
FP8_MAX = 448.0


def exact_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (its amax to 448)."""
    amax = x.detach().abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return x
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


class _Fp8(torch.autograd.Function):
    """fp8 rounding forward, and of the gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return fp8(x)

    @staticmethod
    def backward(ctx, g):
        return fp8(g)


def normalize(image: torch.Tensor) -> torch.Tensor:
    """uint8 RGB NHWC -> BGR minus the mean, NCHW float32; a float image is
    taken as already normalized (NHWC)."""
    if image.dtype == torch.uint8:
        mean = torch.tensor(BGR_MEAN, dtype=torch.float32, device=image.device)
        image = image.to(torch.float32).flip(-1) - mean
    return image.permute(0, 3, 1, 2).contiguous()


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, rate: int,
         quant: bool = False) -> torch.Tensor:
    """Stride-1 TF SAME convolution at an atrous rate (the extra pad
    element high)."""
    pads = []
    for k in (w.shape[3], w.shape[2]):
        total = (k - 1) * rate
        pads += [total // 2, total - total // 2]
    if quant:
        x, w = _Fp8.apply(x), _Fp8.apply(w)
    y = F.conv2d(F.pad(x, pads), w, dilation=rate)
    if quant:
        y = _Fp8.apply(y)
    return y + b[:, None, None]


def max_pool_same(x: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 TF SAME max pool."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        out = -(-n // stride)
        total = max((out - 1) * stride + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, stride)


def forward(params: dict, image: torch.Tensor, *, masks=None, keep: float = 0.5,
            quant: bool = False) -> torch.Tensor:
    """Logits NHWC float32. ``masks``: the two bool keep masks [B,C6,h,w]
    after relu6 and relu7 (training), or None (inference)."""
    h = normalize(image)
    for name, rate, pool in LAYERS:
        p = params[name]
        h = conv(h, p["w"], p["b"], rate, quant)
        if name != "fc8":
            h = F.relu(h)
        if masks is not None and name in ("fc6", "fc7"):
            h = torch.where(masks[0 if name == "fc6" else 1], h / keep, torch.zeros_like(h))
        if pool:
            h = max_pool_same(h, pool)
    return h.permute(0, 2, 3, 1)


def resize_nearest_tf(label: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """TF1 nearest resize of [B,H,W] (float32 source coordinates)."""
    out = label
    for axis, (n_out, n_in) in ((1, (size[0], label.shape[1])), (2, (size[1], label.shape[2]))):
        scale = torch.tensor(n_in, dtype=torch.float32) / torch.tensor(n_out, dtype=torch.float32)
        src = torch.arange(n_out, dtype=torch.float32) * scale
        idx = torch.clamp(torch.floor(src), max=n_in - 1).to(torch.int64).to(label.device)
        out = out.index_select(axis, idx)
    return out


def estep(scores: torch.Tensor, label: torch.Tensor, orders: torch.Tensor, *,
          bg_p: float = 0.4, fg_p: float = 0.2, margin: float = 1e-5) -> torch.Tensor:
    """The adaptive E-step's weak labels [B,h,w] from f32 scores [B,h,w,C],
    the label [B,h,w] (255 void) and the visit orders [rounds, C-1]: absent
    classes clamped below the present minimum after a lift by the batch
    max; each round visits background then the foreground order, raising
    class j by the k-th smallest of (pixel max - score_j), k = 40% (bg) or
    20% (fg) of the pixels, where j is tagged."""
    f = scores.to(torch.float32).clone()
    b, hh, ww, c = f.shape
    lab = label.to(torch.int64)
    classes = torch.arange(c, device=f.device)
    tags = (lab.reshape(b, -1, 1) == classes).any(1).to(torch.float32)
    present = tags[:, None, None, :] > 0
    lifted = f + torch.where(present, 0.0, f.amax())
    pmin = lifted.amin(3, keepdim=True)
    f = torch.where(~present & (f > pmin), pmin - margin, f)
    k_bg, k_fg = int(hh * ww * bg_p), int(hh * ww * fg_p)
    for row in orders.tolist():
        for j in [0] + row:
            diff = (f.amax(3) - f[..., j]).reshape(b, -1)
            th = diff.sort(1).values[:, k_bg if j == 0 else k_fg]
            f[..., j] += (th * tags[:, j])[:, None, None]
    return f.argmax(3)


def weight_l2(params: dict) -> torch.Tensor:
    return sum(0.5 * p["w"].square().sum() for p in params.values())


def draws(generator: torch.Generator, batch: int, fc6: int, hw: tuple[int, int],
          keep: float, rounds: int, num_classes: int):
    """One training step's draws, in the order the step makes them: the
    uniform keep masks after relu6 and relu7, then the E-step's class
    orders (a permutation of 1..C-1 per round)."""
    dev = generator.device
    masks = tuple(torch.rand((batch, fc6, *hw), generator=generator, device=dev) < keep
                  for _ in range(2))
    orders = torch.stack([torch.randperm(num_classes - 1, generator=generator, device=dev) + 1
                          for _ in range(rounds)])
    return masks, orders


class Trainer:
    """The reference's training steps from given weights: ``step(batch)``
    returns (loss, logits, weak labels) and updates ``params`` every
    ``accum`` microbatches. The gradient of the loss is the cross-entropy's
    (autograd) plus the weight decay's ``wd * w`` on each weight."""

    def __init__(self, params: dict, *, lr: float, momentum: float, weight_decay: float,
                 accum: int, keep: float, generator: torch.Generator, num_classes: int = 21,
                 rounds: int = 5, quant: bool = False):
        self.params = {n: {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
                       for n, p in params.items()}
        self.leaves = [(f"{n}.{k}", v) for n, p in self.params.items() for k, v in p.items()]
        self.lr, self.momentum, self.wd, self.accum, self.keep = (lr, momentum, weight_decay,
                                                                  accum, keep)
        self.generator, self.num_classes, self.rounds, self.quant = (generator, num_classes,
                                                                     rounds, quant)
        self.acc = [torch.zeros_like(v) for _, v in self.leaves]
        self.buf = None
        self.mini = 0
        self.first_grad = None  # the first microbatch's gradient, weight decay's term in
        self.first_data_grad = None  # and the cross-entropy's alone

    def step(self, batch: dict):
        image, label = batch["image"], batch["label"][..., 0]
        b, h, w = image.shape[:3]
        sh, sw = h, w
        for _ in range(3):
            sh, sw = -(-sh // 2), -(-sw // 2)
        masks, orders = draws(self.generator, b, self.params["fc6"]["w"].shape[0], (sh, sw),
                              self.keep, self.rounds, self.num_classes)
        logits = forward(self.params, image, masks=masks, keep=self.keep, quant=self.quant)
        shrunk = label if tuple(label.shape[1:]) == (sh, sw) else resize_nearest_tf(label,
                                                                                    (sh, sw))
        with torch.no_grad():
            weak = estep(logits.detach(), shrunk, orders)
        ce = F.cross_entropy(logits.permute(0, 3, 1, 2), weak, reduction="none").mean()
        data = torch.autograd.grad(ce, [v for _, v in self.leaves])
        with torch.no_grad():
            loss = ce + self.wd * weight_l2(self.params)
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
        return loss.detach(), logits.detach(), weak
