"""The fused block1 forward K2 and backward K3: CUDA wrappers, their plain
PyTorch versions and the autograd Function around them.

``block1_fused`` computes VGG block 1 of DeepLab-LargeFOV: conv1_1
(3 -> 64, 3x3 SAME) + b1 + ReLU -> conv1_2 (64 -> 64) + b2 + ReLU -> 3x3
stride-2 SAME max pool, on NCHW activations and OIHW weights (the model's
own layouts, so conv2_1 reads the result without a transpose). On a CUDA
tensor it launches the hand-written kernel of ``csrc/block1_fwd.cu``,
which replaces the TPU kernel
``em_adapt_tpu/ops/block1_pallas.py::_fwd_kernel``; on a CPU tensor it
runs :func:`block1_plain`. Where a weight needs a gradient it runs as an
autograd Function whose backward is :func:`block1_bwd`: the kernel of
``csrc/block1_bwd.cu`` (replacing ``_bwd_kernel``) on the card,
:func:`block1_bwd_plain` on the CPU. It saves only x and the weights (the
backward recomputes y1 and y2) and gives x no gradient, as the JAX
package's ``stop_gradient`` contract (deeplab.py:370-374): an x that
needs one raises. There is no fallback from a kernel to its plain version.

Without gradients the forward runs as the registered operator
``torch.ops.em_adapt.block1_fwd`` (:func:`block1_fwd_op`), whose fake
implementation gives the output's shape: ``torch.export`` traces with
fake tensors, which have no memory for the ctypes launch, so an exported
predict holds the operator as a node of its graph and launches K2 when
it runs (``eval/export.py``). The autograd Function of training calls
:func:`_block1_forward` directly: its forward launches K2 once, as
before, with no dispatch in between.

The arithmetic is the TPU kernel's, not the conv path's: each product
takes the inputs and weights rounded to x's dtype and sums in f32, and
each bias is added in f32 *before* the rounding to x's dtype
(block1_pallas.py:43-45; the conv path adds a bf16 bias after rounding).
Both kernels sum conv1_1's 27 products in (u, v, c) order, and so does
:func:`conv1_plain`: a y1 rounded to the neighbouring bf16 value moves
an output by a step of y1 times a w2 weight, far more than its own step
where the output is small.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from em_adapt_torch.ops.pooling import max_pool_same

#: Launches of K2 made by :func:`block1_fused` (plain runs not counted).
launches = 0
#: Launches of K3 made by :func:`block1_bwd` (plain runs not counted).
bwd_launches = 0

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


#: f32 floats of one CTA's row of K3's partial sums: dw1, db1, dw2, db2.
BWD_PARTIAL_FLOATS = 27 * 64 + 64 + 576 * 64 + 64

#: Each library's launch function and its count of pointer arguments
#: (then B, H, W and the stream).
_LAUNCH = {"block1_fwd": ("em_block1_fwd_launch", 6), "block1_bwd": ("em_block1_bwd_launch", 11)}


def _lib(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The typed library of ``csrc/<name>.cu``, built with ``defines``
    (none: the production build)."""
    from em_adapt_torch.utils.build import load

    lib = load(name, defines)
    if not getattr(lib, "_em_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn, pointers = _LAUNCH[name]
        getattr(lib, fn).argtypes = [p] * pointers + [i] * 3 + [p]
        getattr(lib, fn).restype = i
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


def pool_route_plain(y2: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The pool's backward with first-match routing, before the ReLU mask.

    Each pooled gradient goes to the first row-major position of its 3x3
    window that equals the window's maximum, as XLA's SelectAndScatter
    picks it (block1_pallas.py:181-240). A y2 position covered by several
    windows sums their gradients in y2's dtype, one rounding per window,
    in the window-internal order (u, v) of the TPU kernel's shifts
    (block1_pallas.py:326-343). y2 [B,F,H,W] (H, W odd), dy [B,F,OH,OW]."""
    b, f, h, w = y2.shape
    oh, ow = dy.shape[2:]
    yp = F.pad(y2, (1, 1, 1, 1), value=-float("inf"))  # the pool's own padding
    windows = [yp[..., u:u + 2 * oh:2, v:v + 2 * ow:2] for u in range(3) for v in range(3)]
    pooled = torch.stack(windows).amax(0)
    first = torch.full(pooled.shape, 9, dtype=torch.int8, device=y2.device)
    for k, cand in enumerate(windows):
        first = torch.where((cand == pooled) & (first == 9), k, first)
    acc = torch.zeros(b, f, h + 2, w + 2, dtype=y2.dtype, device=y2.device)
    for k in range(9):
        u, v = divmod(k, 3)
        acc[..., u:u + 2 * oh:2, v:v + 2 * ow:2] += torch.where(first == k, dy, 0).to(y2.dtype)
    return acc[..., 1:h + 1, 1:w + 1]


def block1_bwd_plain(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    dy: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The TPU backward kernel's arithmetic in plain PyTorch; same
    arguments and results as :func:`block1_bwd`: (dw1, db1, dw2, db2) in
    f32, the weights OIHW. It recomputes y1 (:func:`conv1_plain`, exact
    against K2) and y2, routes dy rounded to x's dtype (block1_pallas.py:
    553) through :func:`pool_route_plain`, masks by y2 > 0, and rounds
    where ``_bwd_kernel`` rounds: db2 sums the rounded dz2 in f32; dy1 is
    f32; db1 sums the f32 dz1; dz1 is rounded to x's dtype before the dw1
    product. Every product takes values of x's dtype and sums in f32."""
    dt = x.dtype
    y1 = conv1_plain(x, w1, b1)
    w2c = w2.to(dt).float()
    y2 = F.relu(F.conv2d(y1.float(), w2c, padding=1) + b2.float()[None, :, None, None]).to(dt)
    dz2 = torch.where(y2 > 0, pool_route_plain(y2, dy.to(dt)), 0).float()
    db2 = dz2.sum((0, 2, 3))
    dw2 = torch.nn.grad.conv2d_weight(y1.float(), w2.shape, dz2, padding=1)
    dy1 = torch.nn.grad.conv2d_input(y1.shape, w2c, dz2, padding=1)
    dz1 = torch.where(y1 > 0, dy1, 0)
    db1 = dz1.sum((0, 2, 3))
    dw1 = torch.nn.grad.conv2d_weight(x.float(), w1.shape, dz1.to(dt).float(), padding=1)
    return dw1, db1, dw2, db2


def _card_args(who: str, x: torch.Tensor, w1, b1, w2, b2):
    """The kernels' weights on the card (bf16 OIHW, f32 biases, contiguous)
    after the checks they share; raises on anything they do not take."""
    b, cin, h, w = x.shape
    f = w1.shape[0]
    if x.dtype != torch.bfloat16 or cin != 3 or f != 64:
        raise ValueError(
            f"{who} on the card takes bf16 x with 3 channels and 64 filters, got "
            f"{x.dtype} x with {cin} channels and {f} filters"
        )
    for name, t, shape in (("w1", w1, (64, 3, 3, 3)), ("b1", b1, (64,)),
                           ("w2", w2, (64, 64, 3, 3)), ("b2", b2, (64,))):
        if t.device != x.device or tuple(t.shape) != shape:
            raise ValueError(
                f"{who}: {name} must be {shape} on {x.device}, got "
                f"{tuple(t.shape)} on {t.device}"
            )
    w1c, w2c = (t.detach().to(torch.bfloat16).contiguous() for t in (w1, w2))
    b1c, b2c = (t.detach().to(torch.float32).contiguous() for t in (b1, b2))
    return w1c, b1c, w2c, b2c


def _check_launch(lib: ctypes.CDLL, err: int, who: str) -> None:
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: "
                           f"{lib.em_cuda_error_string(err).decode()} ({err})")


def _block1_forward(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> torch.Tensor:
    """K2 on a CUDA tensor, :func:`block1_plain` on a CPU tensor."""
    b, cin, h, w = x.shape
    if not block1_supported(h, w):
        raise ValueError(f"block1_fused needs square odd inputs, got {h}x{w}")
    if x.device.type == "cpu":
        return block1_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"block1_fused: unsupported device {x.device}")
    w1c, b1c, w2c, b2c = _card_args("block1_fused", x, w1, b1, w2, b2)
    x = x.contiguous()
    out = torch.empty(b, 64, (h + 1) // 2, (w + 1) // 2, dtype=torch.bfloat16, device=x.device)
    lib = _lib("block1_fwd")
    with torch.cuda.device(x.device):
        err = lib.em_block1_fwd_launch(
            x.data_ptr(), w1c.data_ptr(), b1c.data_ptr(), w2c.data_ptr(), b2c.data_ptr(),
            out.data_ptr(), b, h, w, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check_launch(lib, err, "block1 forward")
    global launches
    launches += 1
    return out


@torch.library.custom_op("em_adapt::block1_fwd", mutates_args=())
def block1_fwd_op(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> torch.Tensor:
    """:func:`_block1_forward` as an operator: K2 on a CUDA tensor,
    :func:`block1_plain` on a CPU tensor."""
    return _block1_forward(x, w1, b1, w2, b2)


@block1_fwd_op.register_fake
def _block1_fwd_fake(x, w1, b1, w2, b2):
    b, _, h, w = x.shape
    return x.new_empty(b, w1.shape[0], (h + 1) // 2, (w + 1) // 2)


def block1_bwd(
    x: torch.Tensor, dy: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
    b2: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block 1's weight gradients for the pooled gradient ``dy`` [B, F,
    (H+1)//2, (W+1)//2]: (dw1 [F,3,3,3], db1 [F], dw2 [F,F,3,3], db2 [F]),
    all f32. On a CUDA tensor it launches K3 (x and dy bf16 and contiguous,
    F = 64); on a CPU tensor it runs :func:`block1_bwd_plain`."""
    if check_bwd_args(x, dy, w1) == "cpu":
        return block1_bwd_plain(x, w1, b1, w2, b2, dy)
    grads = launch_bwd(x, dy, w1, b1, w2, b2)
    global bwd_launches
    bwd_launches += 1
    return grads


def check_bwd_args(x: torch.Tensor, dy: torch.Tensor, w1: torch.Tensor) -> str:
    """The checks of :func:`block1_bwd`'s input that do not depend on the
    device; its device type ("cpu" or "cuda"), or raises."""
    b, cin, h, w = x.shape
    if not block1_supported(h, w):
        raise ValueError(f"block1_bwd needs square odd inputs, got {h}x{w}")
    oh, ow = (h + 1) // 2, (w + 1) // 2
    if tuple(dy.shape) != (b, w1.shape[0], oh, ow) or dy.device != x.device:
        raise ValueError(f"block1_bwd: dy must be {(b, w1.shape[0], oh, ow)} on {x.device}, got "
                         f"{tuple(dy.shape)} on {dy.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block1_bwd: unsupported device {x.device}")
    return x.device.type


def launch_bwd(
    x: torch.Tensor, dy: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
    b2: torch.Tensor, defines: tuple[str, ...] = (),
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/block1_bwd.cu`` built with ``defines`` (none:
    K3 itself) on CUDA tensors, counted by its caller."""
    if dy.dtype != torch.bfloat16 or not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError(f"block1_bwd on the card takes contiguous x and bf16 dy, got "
                         f"{dy.dtype} dy, contiguous: x {x.is_contiguous()}, "
                         f"dy {dy.is_contiguous()}")
    b, _, h, w = x.shape
    w1c, b1c, w2c, b2c = _card_args("block1_bwd", x, w1, b1, w2, b2)
    f32 = dict(dtype=torch.float32, device=x.device)
    dw1, db1 = torch.empty(64, 3, 3, 3, **f32), torch.empty(64, **f32)
    dw2, db2 = torch.empty(64, 64, 3, 3, **f32), torch.empty(64, **f32)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    partials = torch.empty(sms, BWD_PARTIAL_FLOATS, **f32)  # one row per CTA
    lib = _lib("block1_bwd", defines)
    with torch.cuda.device(x.device):
        err = lib.em_block1_bwd_launch(
            x.data_ptr(), dy.data_ptr(), w1c.data_ptr(), b1c.data_ptr(), w2c.data_ptr(),
            b2c.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
            partials.data_ptr(), b, h, w, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check_launch(lib, err, "block1 backward")
    return dw1, db1, dw2, db2


class _Block1(torch.autograd.Function):
    """K2 forward, K3 backward; x gets no gradient."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _block1_forward(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        grads = block1_bwd(x, dy.to(x.dtype).contiguous(), w1, b1, w2, b2)
        return (None,) + tuple(g.to(p.dtype) for g, p in zip(grads, (w1, b1, w2, b2)))


def block1_fused(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
) -> torch.Tensor:
    """x [B,3,H,W] (H = W, odd), w1 [F,3,3,3], w2 [F,F,3,3], b1/b2 [F].
    Returns the pooled activations [B, F, (H+1)//2, (W+1)//2] in x.dtype.
    On the card x must be bf16 and F = 64 (full width). With grad mode on
    and a weight that needs a gradient, the backward is :func:`block1_bwd`;
    x must then need none. Otherwise it runs :func:`block1_fwd_op`."""
    if not torch.is_grad_enabled():
        return block1_fwd_op(x, w1, b1, w2, b2)
    if x.requires_grad:
        raise RuntimeError(
            "block1_fused gives its input no gradient (block 1 is the first layer): "
            "pass an x that needs none, or use block1_impl='xla'"
        )
    if any(t.requires_grad for t in (w1, b1, w2, b2)):
        return _Block1.apply(x, w1, b1, w2, b2)
    return block1_fwd_op(x, w1, b1, w2, b2)
