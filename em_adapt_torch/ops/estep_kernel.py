"""The E-step kernel K1: CUDA wrapper and its plain PyTorch version.

``estep_kernel`` runs the adaptive-bias E-step on scores laid out
``[B, C, HW]`` (the model's NCHW logits, reshaped without a copy). On a
CUDA tensor it launches the hand-written kernel of ``csrc/estep.cu``,
which replaces the TPU kernel ``em_adapt_tpu/ops/estep_pallas.py::_kernel``;
on a CPU tensor it runs :func:`estep_plain`, the same search on the
float bits in plain PyTorch: each round fixes a digit of
:data:`DIGIT_BITS` bits of every visit's threshold, as the kernel's
block rounds do. There is no fallback from one to the other.

An image of up to 2048 pixels (41x41 at a 321x321 input) runs in one
CTA; a larger one (65x65 at 513x513) over a thread block cluster of up
to :data:`MAX_CLUSTER` CTAs, each holding a share of its pixels
(:func:`ctas_per_image`). Beyond that the wrapper raises.

Inputs computed outside the kernel, as the JAX side computes them
(estep_pallas.py:218-239): ``k_bg``/``k_fg`` = ``int(hw * p)``, the visit
schedule as an int32 array, and ``gmax``, the max of the whole batch's
scores before suppression, as a one-element device tensor (a multi-GPU
run all-reduces it).
"""

from __future__ import annotations

import ctypes

import torch

#: Kernel launches made by :func:`estep_kernel` (plain runs not counted).
launches = 0

#: Dynamic shared memory a block may use on Hopper (227 KB opt-in).
MAX_SMEM_BYTES = 232448

#: The most CTAs one image may span (the portable cluster size).
MAX_CLUSTER = 8

#: Bits of a threshold that one block round of the kernel fixes: its
#: ``K1_DIGIT_BITS``, checked against the library when it is loaded. A
#: present class visit takes ``search_rounds(DIGIT_BITS)`` rounds.
DIGIT_BITS = 4


def type_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Types the C interface that every version of ``csrc/estep.cu`` has."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.em_estep_launch.argtypes = [p] * 6 + [i] * 7 + [ctypes.c_float, p]
    lib.em_estep_launch.restype = i
    lib.em_estep_smem_bytes.argtypes = [i, i]
    lib.em_estep_smem_bytes.restype = ctypes.c_size_t
    lib.em_estep_max_pixels.restype = i
    lib.em_cuda_error_string.argtypes = [i]
    lib.em_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    from em_adapt_torch.utils.build import load

    lib = load("estep")
    if not getattr(lib, "_em_typed", False):
        type_library(lib)
        lib.em_estep_digit_bits.restype = ctypes.c_int
        if lib.em_estep_digit_bits() != DIGIT_BITS:
            raise RuntimeError(f"csrc/estep.cu fixes {lib.em_estep_digit_bits()} threshold bits "
                               f"a round, ops/estep_kernel.py {DIGIT_BITS}")
        lib.em_estep_cluster_size.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.em_estep_cluster_size.restype = ctypes.c_int
        lib._em_typed = True
    return lib


def ctas_per_image(c: int, hw: int) -> int:
    """CTAs the kernel gives one image of ``c`` channels and ``hw`` pixels:
    1 (no cluster) up to 2048 pixels at 21 classes, the least cluster
    whose CTAs each hold a share beyond that, 0 where none of
    :data:`MAX_CLUSTER` does. Builds the kernel's library."""
    return _lib().em_estep_cluster_size(c, hw)


def search_rounds(digit_bits: int) -> int:
    """Dependent block rounds of one present class visit: the 31 bits of a
    non-negative float, ``digit_bits`` at a time."""
    return -(-31 // digit_bits)


def search_thresholds(dbits: torch.Tensor, k1: int, digit_bits: int) -> torch.Tensor:
    """Per row of ``dbits`` [B,HW] (diff bit patterns, int32), the least
    31-bit pattern with at least ``k1`` patterns at or below it: the
    (k1-1)-th smallest, found a digit at a time from the top as the kernel
    finds it. A round at shift s tests the probes cand | m << s |
    (1 << s) - 1 for m < 2^bits - 1; the digit is the number of probes
    with fewer than k1 patterns at or below them. The first round takes
    the bits left over (31 % digit_bits, or digit_bits); ``digit_bits=1``
    is the bisection. Returns [B] int32."""
    cand = torch.zeros(dbits.shape[0], 1, dtype=torch.int32, device=dbits.device)
    rounds = search_rounds(digit_bits)
    shift = 31
    for r in range(rounds):
        bits = 31 - (rounds - 1) * digit_bits if r == 0 else digit_bits
        shift -= bits
        m = torch.arange((1 << bits) - 1, dtype=torch.int32, device=dbits.device)
        probes = cand | (m << shift)[None, :] | ((1 << shift) - 1)  # [B, 2^bits - 1]
        count = (dbits[:, None, :] <= probes[:, :, None]).sum(2)
        cand = cand | ((count < k1).sum(1, keepdim=True).to(torch.int32) << shift)
    return cand[:, 0]


def estep_plain(
    scores: torch.Tensor,
    labels: torch.Tensor,
    visit: torch.Tensor,
    gmax: torch.Tensor,
    *,
    k_bg: int,
    k_fg: int,
    suppress: bool,
    margin: float,
    digit_bits: int = DIGIT_BITS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch; same arguments and results
    as :func:`estep_kernel`: (biased scores [B,C,HW], thresholds [B,L]).
    ``digit_bits`` is the search's round width (:func:`search_thresholds`);
    every width gives the same bits."""
    b, c, hw = scores.shape
    f = scores.clone()
    classes = torch.arange(c, device=scores.device)
    tags = (labels[:, None, :] == classes[None, :, None]).any(2)  # [B,C]
    if suppress:
        lift = torch.where(tags, torch.zeros_like(gmax), gmax)[:, :, None]
        pmin = (f + lift).amin(1, keepdim=True)
        f = torch.where(~tags[:, :, None] & (f > pmin), pmin - margin, f)
    rowmax = f.amax(1)  # [B,HW]
    inv_hw = torch.tensor(1.0 / hw, dtype=torch.float32)
    before = rowmax.sum(1) * inv_hw
    schedule = visit.tolist()
    thresholds = torch.zeros(b, len(schedule), dtype=torch.float32, device=scores.device)
    for t, j in enumerate(schedule):
        dbits = (rowmax - f[:, j]).view(torch.int32)
        k1 = (k_bg if j == 0 else k_fg) + 1
        th = search_thresholds(dbits, k1, digit_bits).view(torch.float32) * tags[:, j]
        thresholds[:, t] = th
        f[:, j] += th[:, None]
        rowmax = torch.maximum(rowmax, f[:, j])
    after = rowmax.sum(1) * inv_hw
    return f + (before - after)[:, None, None], thresholds


def estep_kernel(
    scores: torch.Tensor,
    labels: torch.Tensor,
    visit: torch.Tensor,
    gmax: torch.Tensor,
    *,
    k_bg: int,
    k_fg: int,
    suppress: bool,
    margin: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Adaptive-bias E-step. scores [B,C,HW] f32, labels [B,HW] int32
    (uint8-cast), visit [L] int32, gmax [1] f32.

    Returns (biased scores [B,C,HW] f32, thresholds [B,L] f32: the bias
    visit t added to its class, 0 where the class is absent).
    """
    if scores.device.type == "cpu":
        return estep_plain(
            scores, labels, visit, gmax, k_bg=k_bg, k_fg=k_fg,
            suppress=suppress, margin=margin,
        )
    if scores.device.type != "cuda":
        raise ValueError(f"estep_kernel: unsupported device {scores.device}")
    b, c, hw = scores.shape
    length = visit.numel()
    dev = scores.device
    for name, t, dtype, shape in (
        ("scores", scores, torch.float32, (b, c, hw)),
        ("labels", labels, torch.int32, (b, hw)),
        ("visit", visit, torch.int32, (length,)),
        ("gmax", gmax, torch.float32, (1,)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"estep_kernel: {name} must be {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"estep_kernel: {name} must be contiguous")
    if not (0 <= k_bg < hw and 0 <= k_fg < hw):
        raise ValueError(f"estep_kernel: ranks k_bg={k_bg}, k_fg={k_fg} outside [0, {hw})")
    lib = _lib()
    if lib.em_estep_cluster_size(c, hw) == 0:
        raise ValueError(
            f"estep_kernel: one image's state ({c} x {hw} f32) does not fit a "
            f"cluster of {MAX_CLUSTER} CTAs ({lib.em_estep_max_pixels()} pixels at four a "
            f"thread, {MAX_SMEM_BYTES} B of shared memory a CTA)"
        )
    out, thresholds = launch(lib, scores, labels, visit, gmax, k_bg=k_bg, k_fg=k_fg,
                             suppress=suppress, margin=margin)
    global launches
    launches += 1
    return out, thresholds


def launch(lib: ctypes.CDLL, scores, labels, visit, gmax, *, k_bg: int, k_fg: int,
           suppress: bool, margin: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``lib``'s ``em_estep_launch`` (a library typed by
    :func:`type_library`) on inputs that :func:`estep_kernel` accepts;
    raises when the launch fails. Not counted in :data:`launches`."""
    b, c, hw = scores.shape
    dev = scores.device
    out = torch.empty_like(scores)
    thresholds = torch.empty(b, visit.numel(), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.em_estep_launch(
            scores.data_ptr(), labels.data_ptr(), visit.data_ptr(), gmax.data_ptr(),
            out.data_ptr(), thresholds.data_ptr(), b, c, hw, visit.numel(), k_bg, k_fg,
            int(suppress), margin, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"estep kernel launch failed: {lib.em_cuda_error_string(err).decode()} ({err})"
        )
    return out, thresholds
