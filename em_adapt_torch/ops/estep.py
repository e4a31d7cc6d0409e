"""Adaptive-bias E-step: tags, suppression, class orders, the sort
reference and the weak-label entry point.

Semantics are those of ``em_adapt_tpu/ops/estep_oracle.py`` (reference
estep.py:33-84): the channel-argmax label maps are pixel-identical, and
the biased scores agree to float tolerance (the only difference is the
summation order of the per-image means of the final shift).

Three implementations of EM-Adapt:
* :func:`estep` — the sort reference (``impl="jax"``): each visit sorts
  ``rowmax - f_j`` and reads the k-th value;
* :func:`estep_bisect` — the kernel K1 (``impl="auto"``/``"pallas"``):
  the hand-written CUDA kernel on a CUDA tensor, its plain PyTorch version
  on a CPU tensor (:mod:`em_adapt_torch.ops.estep_kernel`);
* ``impl="native"`` — the host C++ library
  (:mod:`em_adapt_torch.ops.estep_native`) on a host copy of the scores.

And EM-Fixed (:func:`estep_fixed`, ``method="fixed"``): a constant bias
per present class, one elementwise add in plain PyTorch whatever the
``impl`` (no kernel: the JAX package runs it as plain XLA too).

Class orders are explicit ``[num_iter, C-1]`` arrays. In training they are
drawn from a ``torch.Generator``, which gives other orders than JAX's keys
for the same seed; tests pass both packages the same array.

The E-step's one link between images is the batch max that lifts absent
classes before the channel min (reference estep.py:46-55). The JAX package
takes it over the global, sharded batch; :func:`estep_labels` takes it
over the world's batch (``parallel/mesh.py::global_max``: an all-reduce of
the local max when several processes train together).
"""

from __future__ import annotations

import torch

from em_adapt_torch.config import EStepConfig
from em_adapt_torch.ops.estep_kernel import estep_kernel
from em_adapt_torch.ops.estep_native import estep_native
from em_adapt_torch.parallel.mesh import MeshPlan, global_max


def derive_tags(label: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Image-level tags [B, C] in {0,1} (float32) from a mask [B, H, W].

    The uint8 cast keeps 255 (the ignore label), which then matches no
    class (reference estep.py:35-44).
    """
    lab = label.to(torch.uint8).to(torch.int64)
    classes = torch.arange(num_classes, device=label.device)
    return (lab[..., None] == classes).any(2).any(1).to(torch.float32)


def suppress_absent(scores: torch.Tensor, tags: torch.Tensor, margin: float,
                    gmax: torch.Tensor | None = None) -> torch.Tensor:
    """Clamp absent-class scores above the per-pixel present-class min,
    lifting absent channels by the global batch max first (reference
    estep.py:46-55). scores [B,H,W,C], tags [B,C]; ``gmax`` overrides the
    batch max."""
    present = tags[:, None, None, :] > 0
    gmax = scores.amax() if gmax is None else gmax.reshape(())
    lifted = scores + torch.where(present, torch.zeros_like(gmax), gmax)
    present_min = lifted.amin(3, keepdim=True)
    clamp = ~present & (scores > present_min)
    return torch.where(clamp, present_min - margin, scores)


def make_class_orders(
    generator: torch.Generator, num_iter: int, num_classes: int, device=None
) -> torch.Tensor:
    """[num_iter, C-1] int32 foreground visit orders (values 1..C-1), drawn
    on ``device`` (default: the generator's) from ``generator``."""
    device = generator.device if device is None else device
    if num_iter == 0:
        return torch.zeros(0, num_classes - 1, dtype=torch.int32, device=device)
    rows = [
        torch.randperm(num_classes - 1, generator=generator, device=device) + 1
        for _ in range(num_iter)
    ]
    return torch.stack(rows).to(torch.int32)


def visit_schedule(orders: torch.Tensor) -> torch.Tensor:
    """[num_iter * C] int32: background first in every round, then the
    round's foreground order (reference estep.py:64-66)."""
    bg = torch.zeros(orders.shape[0], 1, dtype=torch.int32, device=orders.device)
    return torch.cat([bg, orders.to(torch.int32)], 1).reshape(-1)


def _check_orders(orders: torch.Tensor, num_iter: int, c: int) -> None:
    if tuple(orders.shape) != (num_iter, c - 1):
        raise ValueError(
            f"orders must have shape (num_iter={num_iter}, C-1={c - 1}), "
            f"got {tuple(orders.shape)}; build it with make_class_orders()"
        )


def estep(
    scores: torch.Tensor,
    label: torch.Tensor,
    orders: torch.Tensor,
    *,
    bg_p: float = 0.4,
    fg_p: float = 0.2,
    num_iter: int = 5,
    suppress_others: bool = True,
    margin_others: float = 1e-5,
    gmax: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sort reference. scores [B,H,W,C] f32, label [B,H,W], orders
    [num_iter, C-1]; ``gmax`` overrides the batch max. Returns the biased
    [B,H,W,C] score map."""
    f = scores.to(torch.float32).clone()
    b, h, w, c = f.shape
    _check_orders(orders, num_iter, c)
    tags = derive_tags(label, c)
    if suppress_others:
        f = suppress_absent(f, tags, margin_others, gmax)
    before = f.amax(3).mean((1, 2))
    k_bg, k_fg = int(h * w * bg_p), int(h * w * fg_p)
    for j in visit_schedule(orders).tolist():
        diff = (f.amax(3) - f[..., j]).reshape(b, h * w)
        th = diff.sort(1).values[:, k_bg if j == 0 else k_fg]
        f[..., j] += (th * tags[:, j])[:, None, None]
    after = f.amax(3).mean((1, 2))
    return f + (before - after)[:, None, None, None]


def estep_fixed(
    scores: torch.Tensor,
    label: torch.Tensor,
    *,
    bg_bias: float = 3.0,
    fg_bias: float = 5.0,
    suppress_others: bool = True,
    margin_others: float = 1e-5,
    bias_units: str = "logit",
    gmax: torch.Tensor | None = None,
) -> torch.Tensor:
    """EM-Fixed (arXiv:1502.02734 §3.3; ``em_adapt_tpu/ops/estep.py::
    estep_fixed``): ``bg_bias`` added to the background's scores and
    ``fg_bias`` to each present foreground class's, nothing to an absent
    class (clamped below the present-class min first, as in EM-Adapt,
    with ``suppress_others``). ``bias_units="spread"`` multiplies the
    biases by the image's STD of its present-class scores (moments masked
    to the present channels). scores [B,H,W,C], label [B,H,W]; ``gmax``
    overrides the batch max of the suppression. Returns the biased
    [B,H,W,C] f32 map."""
    if bias_units not in ("logit", "spread"):
        raise ValueError(f"bias_units={bias_units!r}: expected 'logit' or 'spread'")
    f = scores.to(torch.float32)
    b, h, w, c = f.shape
    tags = derive_tags(label, c)
    if suppress_others:
        f = suppress_absent(f, tags, margin_others, gmax)
    per_class = torch.full((c,), fg_bias, dtype=torch.float32, device=f.device)
    per_class[0] = bg_bias
    bias = (tags * per_class)[:, None, None, :]
    if bias_units == "spread":
        mask = tags[:, None, None, :]
        n = (tags.sum(1) * (h * w)).clamp(min=1.0)
        mean = (f * mask).sum((1, 2, 3)) / n
        var = (mask * (f - mean[:, None, None, None]) ** 2).sum((1, 2, 3)) / n
        bias = bias * var.sqrt()[:, None, None, None]
    return f + bias


def _estep_bisect_nchw(
    scores: torch.Tensor,
    label: torch.Tensor,
    orders: torch.Tensor,
    *,
    bg_p: float,
    fg_p: float,
    num_iter: int,
    suppress_others: bool,
    margin_others: float,
    gmax: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 on scores [B,C,H,W] (NCHW logits, no transpose). Returns the
    biased [B,C,H,W] map and the thresholds [B, num_iter*C]."""
    b, c, h, w = scores.shape
    _check_orders(orders, num_iter, c)
    hw = h * w
    flat = scores.to(torch.float32).reshape(b, c, hw).contiguous()
    labels = label.to(torch.uint8).to(torch.int32).reshape(b, hw).contiguous()
    if gmax is None:
        gmax = flat.amax()
    out, thresholds = estep_kernel(
        flat,
        labels,
        visit_schedule(orders.to(scores.device)),
        gmax.to(torch.float32).reshape(1),
        k_bg=int(hw * bg_p),
        k_fg=int(hw * fg_p),
        suppress=suppress_others,
        margin=margin_others,
    )
    return out.reshape(b, c, h, w), thresholds


def estep_bisect(
    scores: torch.Tensor,
    label: torch.Tensor,
    orders: torch.Tensor,
    *,
    bg_p: float = 0.4,
    fg_p: float = 0.2,
    num_iter: int = 5,
    suppress_others: bool = True,
    margin_others: float = 1e-5,
    gmax: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``estep_pallas``: scores [B,H,W,C], label [B,H,W],
    orders [num_iter, C-1]; ``gmax`` overrides the batch max. Returns the
    biased [B,H,W,C] map and the per-visit thresholds [B, num_iter*C]."""
    out, thresholds = _estep_bisect_nchw(
        scores.permute(0, 3, 1, 2), label, orders, bg_p=bg_p, fg_p=fg_p,
        num_iter=num_iter, suppress_others=suppress_others,
        margin_others=margin_others, gmax=gmax,
    )
    return out.permute(0, 2, 3, 1), thresholds


def estep_labels(
    scores: torch.Tensor, label: torch.Tensor, orders: torch.Tensor, cfg: EStepConfig,
    plan: MeshPlan | None = None,
) -> torch.Tensor:
    """Weak label map [B, H, W] int64 = argmax of the biased score map.

    scores [B,H,W,C]; a view of NCHW logits (the model's output) reaches
    the kernel without a copy. No gradient flows: the E-step output is a
    fixed target (reference deeplab.py:120-123). ``cfg.method="fixed"``
    runs :func:`estep_fixed` for every ``cfg.impl`` (``orders`` unused);
    ``cfg.impl="native"`` copies the scores to the host, runs the C++
    library there and copies the labels back to the scores' device.

    In a world of several processes the batch max is the world's
    (``parallel/mesh.py::global_max``), for every method and impl but
    "native", which raises where the batch is split over processes (a
    data × space of ``plan`` above 1; no plan is one process):
    the host library takes its own batch's max, and the JAX package's
    native path has no sharded form either. Each rank passes its data
    shard's whole score map (on a space axis, the map gathered over the
    space group; on a model axis, the same map on every model rank).
    """
    if cfg.method not in ("adaptive", "fixed"):
        raise ValueError(f"estep.method={cfg.method!r}: expected 'adaptive' or 'fixed'")
    if cfg.impl not in ("auto", "pallas", "jax", "native"):
        raise ValueError(
            f"estep.impl={cfg.impl!r}: expected 'auto', 'pallas', 'jax' or 'native'")
    split = plan is not None and plan.ddp_size > 1
    if cfg.impl == "native" and cfg.method == "adaptive" and split:
        raise ValueError(
            "estep.impl='native' cannot train in a world of several processes: the host "
            "library takes the batch max over its own process's images, where the E-step "
            "needs the world's (recorded in ROADMAP.md under item 11); use 'auto'")
    kw = dict(suppress_others=cfg.suppress_others, margin_others=cfg.margin_others)
    with torch.no_grad():
        if cfg.impl != "native" or cfg.method == "fixed":
            kw["gmax"] = global_max(scores)
        if cfg.method == "fixed":
            return estep_fixed(scores, label, bg_bias=cfg.fixed_bg_bias,
                               fg_bias=cfg.fixed_fg_bias, bias_units=cfg.fixed_bias_units,
                               **kw).argmax(3)
        kw.update(bg_p=cfg.bg_p, fg_p=cfg.fg_p, num_iter=cfg.num_iter)
        if cfg.impl == "native":
            biased = estep_native(scores.float().cpu().numpy(), label.cpu().numpy(),
                                  orders.cpu().numpy(), **kw)
            return torch.from_numpy(biased.argmax(3)).to(scores.device)
        if cfg.impl == "jax":
            return estep(scores, label, orders, **kw).argmax(3)
        biased, _ = _estep_bisect_nchw(scores.permute(0, 3, 1, 2), label, orders, **kw)
        return biased.argmax(1)
