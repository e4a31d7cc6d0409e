"""The fused block1 forward K2: CUDA wrapper and its plain PyTorch version.

``block1_fused`` computes VGG block 1 of DeepLab-LargeFOV at inference:
conv1_1 (3 -> 64, 3x3 SAME) + b1 + ReLU -> conv1_2 (64 -> 64) + b2 + ReLU
-> 3x3 stride-2 SAME max pool, on NCHW activations and OIHW weights (the
model's own layouts, so conv2_1 reads the result without a transpose).
On a CUDA tensor it launches the hand-written kernel of
``csrc/block1_fwd.cu``, which replaces the TPU kernel
``em_adapt_tpu/ops/block1_pallas.py::_fwd_kernel``; on a CPU tensor it
runs :func:`block1_plain`. There is no fallback from one to the other.

The arithmetic is the TPU kernel's, not the conv path's: each product
takes the inputs and weights rounded to x's dtype and sums in f32, and
each bias is added in f32 *before* the rounding to x's dtype
(block1_pallas.py:43-45; the conv path adds a bf16 bias after rounding).
Both kernels sum conv1_1's 27 products in (u, v, c) order, and so does
:func:`conv1_plain`: a y1 rounded to the neighbouring bf16 value moves
an output by a step of y1 times a w2 weight, far more than its own step
where the output is small.
The kernel has no backward yet (ROADMAP.md Queue 1 item 1b), so it
refuses weights that need a gradient.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from em_adapt_torch.ops.pooling import max_pool_same

#: Kernel launches made by :func:`block1_fused` (plain runs not counted).
launches = 0

#: :func:`bf16_close` takes the bf16 step at no less than this share of
#: the largest output.
STEP_FLOOR = 2.0 ** -12


def block1_supported(h: int, w: int) -> bool:
    """Whether the fused block handles this input size (square, odd), as
    ``block1_pallas.py::block1_supported``."""
    return h == w and h % 2 == 1


def bf16_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-element distance, in representable bf16 steps, between two
    tensors of bf16 values (+0 and -0 are the same step). The checks of
    the kernel against :func:`block1_plain` count in it."""
    def ordered(t):
        bits = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(a) - ordered(b)).abs()


def bf16_close(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per element: ``got`` within one bf16 step of ``want``, the step
    taken at ``max(|want|, STEP_FLOOR * max|want|)``. Below that floor an
    output is a small difference of large products, and an f32 sum of
    conv1_2's 576 products in another order (the tensor cores' against
    cuDNN's) moves it by up to about 1e-7 of the largest output, which
    near zero is many of its own steps."""
    w = want.float()
    ref = torch.maximum(w.abs(), w.abs().amax() * STEP_FLOOR)
    step = torch.exp2(torch.floor(torch.log2(ref)) - 7)  # bf16 keeps 8 significant bits
    return (got.float() - w).abs() <= step


def _lib() -> ctypes.CDLL:
    from em_adapt_torch.utils.build import load

    lib = load("block1_fwd")
    if not getattr(lib, "_em_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.em_block1_fwd_launch.argtypes = [p] * 6 + [i] * 3 + [p]
        lib.em_block1_fwd_launch.restype = i
        lib.em_cuda_error_string.argtypes = [i]
        lib.em_cuda_error_string.restype = ctypes.c_char_p
        lib._em_typed = True
    return lib


def conv1_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """y1 = relu(conv1_1(x) + b1) rounded to x's dtype, x [B,3,H,W], summed
    as the kernels sum it: in f32 from 0, one product at a time in
    (u, v, c) order, then + b1 (bf16 x bf16 products are exact in f32, so
    this is K2's fused multiply-add chain to the bit)."""
    b, cin, h, w = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1))
    wf = w1.to(x.dtype).float()
    acc = torch.zeros(b, wf.shape[0], h, w, device=x.device)
    for u in range(3):
        for v in range(3):
            for c in range(cin):
                acc = acc + xp[:, c:c + 1, u:u + h, v:v + w] * wf[None, :, c, u, v, None, None]
    return F.relu(acc + b1.float()[None, :, None, None]).to(x.dtype)


def block1_plain(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch; same arguments and result
    as :func:`block1_fused`: :func:`conv1_plain`, then conv1_2 in f32 on
    the values rounded to x's dtype, + b2, ReLU, rounding, pool."""
    dt = x.dtype
    y1 = conv1_plain(x, w1, b1)
    y2 = F.conv2d(y1.float(), w2.to(dt).float(), padding=1) + b2.float()[None, :, None, None]
    return max_pool_same(F.relu(y2).to(dt), 3, 2)


def block1_fused(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> torch.Tensor:
    """x [B,3,H,W] (H = W, odd), w1 [F,3,3,3], w2 [F,F,3,3], b1/b2 [F].
    Returns the pooled activations [B, F, (H+1)//2, (W+1)//2] in x.dtype.
    On the card x must be bf16 and F = 64 (full width)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (w1, b1, w2, b2)):
        raise RuntimeError(
            "block1_fused has no backward yet (K3, ROADMAP.md Queue 1 item 1b): "
            "call it under torch.no_grad() or with weights that need no gradient"
        )
    b, cin, h, w = x.shape
    if not block1_supported(h, w):
        raise ValueError(f"block1_fused needs square odd inputs, got {h}x{w}")
    if x.device.type == "cpu":
        return block1_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"block1_fused: unsupported device {x.device}")
    f = w1.shape[0]
    if x.dtype != torch.bfloat16 or cin != 3 or f != 64:
        raise ValueError(
            f"block1_fused on the card takes bf16 x with 3 channels and 64 filters, got "
            f"{x.dtype} x with {cin} channels and {f} filters"
        )
    for name, t, shape in (("w1", w1, (64, 3, 3, 3)), ("b1", b1, (64,)),
                           ("w2", w2, (64, 64, 3, 3)), ("b2", b2, (64,))):
        if t.device != x.device or tuple(t.shape) != shape:
            raise ValueError(
                f"block1_fused: {name} must be {shape} on {x.device}, got "
                f"{tuple(t.shape)} on {t.device}"
            )
    x = x.contiguous()
    w1c, w2c = (t.to(torch.bfloat16).contiguous() for t in (w1, w2))
    b1c, b2c = (t.to(torch.float32).contiguous() for t in (b1, b2))
    out = torch.empty(b, 64, (h + 1) // 2, (w + 1) // 2, dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.em_block1_fwd_launch(
            x.data_ptr(), w1c.data_ptr(), b1c.data_ptr(), w2c.data_ptr(), b2c.data_ptr(),
            out.data_ptr(), b, h, w, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"block1 kernel launch failed: {lib.em_cuda_error_string(err).decode()} ({err})"
        )
    global launches
    launches += 1
    return out
