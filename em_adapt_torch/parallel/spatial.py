"""Spatial partitioning over the mesh's ``space`` axis: row strips.

The counterpart of what XLA's partitioner inserts when the JAX package
shards the batch's H over ``space`` (``em_adapt_tpu/parallel/mesh.py:
59-66, 97-117``). Each of the n space ranks of a data index holds rows of
every activation: of an activation of h rows, rank i owns rows
``[i·⌈h/n⌉, (i+1)·⌈h/n⌉)`` clipped to h (:func:`row_split`; the last rank
the shorter, as XLA pads an uneven dimension: 41 rows over 3 are 14, 14
and 13). The image must divide (:func:`check_image_rows`); the rows of
later activations follow the rule at each one's own height, so a stride-2
pool moves the boundaries (321 -> 161 rows over 3 is 107 a rank -> 54, 54
and 53).

:func:`conv_rows` and :func:`pool_rows` compute this rank's output rows of
a TF-SAME conv or max pool: from the layer's kernel, stride, rate and SAME
padding they find the input rows those output rows read, fetch the ones
other ranks own (:class:`_Exchange`, a halo exchange), pad only at the
image's true top and bottom (zeros for a conv, -inf for a pool) and run
the layer with no other H padding. A halo may be wider than a
neighbour's strip (fc6's 6 rows over strips of 2, 2 and 1 at a 33-row
input over 3), so rows come from whichever rank owns them: every rank
packs the rows that the others need from it into one buffer and the
space group all-gathers the buffers. The backward sends each fetched
row's gradient back to its owner the same way, and the owner adds it.
The buffers move as bytes, so bf16 and float32 take the one path on
gloo and NCCL alike. :func:`gather_rows` joins a strip into the whole
tensor (the E-step's score map); its backward hands each rank its own
rows' gradient.

Every rank of the space group runs every exchange in the same order:
the layers run in one order everywhere, and under ``remat`` the
recompute repeats the exchange on every rank alike.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from em_adapt_torch.ops.conv import conv2d_same, same_padding
from em_adapt_torch.ops.pooling import _same_pool_padding, max_pool_same
from em_adapt_torch.parallel.mesh import MeshPlan
from em_adapt_torch.utils import tracing

Rows = tuple[int, int]


def check_image_rows(h: int, n: int) -> None:
    """Raise, in the JAX package's words, unless an image of ``h`` rows
    divides over a space axis of ``n``."""
    if n > 1 and h % n:
        raise ValueError(
            f"spatial sharding: image height {h} is not divisible by the space axis ({n}); "
            f"pick an input size divisible by it (e.g. 321 with space=3) or set space=1")


def row_split(h: int, n: int) -> list[Rows]:
    """The rows ``[lo, hi)`` of an ``h``-row activation that each of ``n``
    space ranks owns: ``⌈h/n⌉`` a rank, the last ones shorter. Raises when
    a rank would own none."""
    step = -(-h // n)
    parts = [(min(i * step, h), min((i + 1) * step, h)) for i in range(n)]
    empty = [i for i, (lo, hi) in enumerate(parts) if lo >= hi]
    if empty:
        raise ValueError(f"spatial sharding: {h} rows over a space axis of {n} leave rank "
                         f"{empty[0]} no rows; use a larger input or a smaller space axis")
    return parts


def my_rows(x: torch.Tensor, plan: MeshPlan, dim: int) -> torch.Tensor:
    """This rank's rows (along ``dim``) of a whole tensor."""
    if plan.num_space_shards == 1:
        return x
    lo, hi = row_split(x.shape[dim], plan.num_space_shards)[plan.space_index]
    return x.narrow(dim, lo, hi - lo)


def _overlap(a: Rows, b: Rows) -> Rows | None:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


def _all_gather(buf: torch.Tensor, plan: MeshPlan) -> list[torch.Tensor]:
    """Every space rank's ``buf`` (one shape on all), moved as bytes."""
    flat = buf.contiguous().view(torch.uint8)
    out = [torch.empty_like(flat) for _ in range(plan.num_space_shards)]
    with tracing.span("space_exchange"):
        dist.all_gather(out, flat, group=plan.space_group)
    return [o.view(buf.dtype) for o in out]


def _send_plan(parts: list[Rows], needs: list[Rows]) -> list[list[Rows | None]]:
    """[src][dst]: the rows that rank dst needs from rank src (None: none;
    a rank's own rows are not sent)."""
    n = len(parts)
    return [[_overlap(needs[d], parts[s]) if d != s else None for d in range(n)]
            for s in range(n)]


def _size(seg: Rows | None) -> int:
    return 0 if seg is None else seg[1] - seg[0]


def _pack(x: torch.Tensor, segs: list[Rows | None], base: int, cap: int) -> torch.Tensor:
    """``x``'s rows ``segs`` (global rows, ``x`` starting at ``base``) in
    order, zero-padded to ``cap`` rows along dim 2."""
    buf = x.new_zeros(x.shape[0], x.shape[1], cap, x.shape[3])
    at = 0
    for seg in segs:
        if seg is not None:
            buf[:, :, at:at + _size(seg)] = x[:, :, seg[0] - base:seg[1] - base]
            at += _size(seg)
    return buf


def _exchange(x: torch.Tensor, plan: MeshPlan, parts: list[Rows],
              needs: list[Rows]) -> torch.Tensor:
    """Rows ``needs[me]`` of the whole activation from this rank's rows
    ``parts[me]`` of it (x [B,C,rows,W])."""
    me = plan.space_index
    sends = _send_plan(parts, needs)
    cap = max(sum(_size(s) for s in row) for row in sends)
    got = _all_gather(_pack(x, sends[me], parts[me][0], cap), plan) if cap else None
    pieces = []
    for src, part in enumerate(parts):
        seg = _overlap(needs[me], part)
        if seg is None:
            continue
        if src == me:
            pieces.append(x[:, :, seg[0] - part[0]:seg[1] - part[0]])
        else:
            at = sum(_size(s) for d, s in enumerate(sends[src]) if d < me)
            pieces.append(got[src][:, :, at:at + _size(seg)])
    return torch.cat(pieces, 2) if len(pieces) > 1 else pieces[0]


def _exchange_back(g: torch.Tensor, plan: MeshPlan, parts: list[Rows],
                   needs: list[Rows]) -> torch.Tensor:
    """The gradient of :func:`_exchange`'s input: each fetched row's
    gradient goes back to its owner, which adds it to its own rows'."""
    me, lo = plan.space_index, parts[plan.space_index][0]
    a = needs[me][0]
    grad = g.new_zeros(g.shape[0], g.shape[1], parts[me][1] - lo, g.shape[3])
    own = _overlap(needs[me], parts[me])
    if own is not None:
        grad[:, :, own[0] - lo:own[1] - lo] += g[:, :, own[0] - a:own[1] - a]
    # backs[r][src]: the rows whose gradient rank r returns to rank src.
    backs = [[_overlap(needs[r], p) if s != r else None for s, p in enumerate(parts)]
             for r in range(len(parts))]
    cap = max(sum(_size(s) for s in row) for row in backs)
    if not cap:
        return grad
    got = _all_gather(_pack(g, backs[me], a, cap), plan)
    for d, row in enumerate(backs):
        seg = row[me] if d != me else None
        if seg is not None:
            at = sum(_size(s) for src, s in enumerate(row) if src < me)
            grad[:, :, seg[0] - lo:seg[1] - lo] += got[d][:, :, at:at + _size(seg)]
    return grad


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, parts, needs):
        ctx.plan, ctx.parts, ctx.needs = plan, parts, needs
        return _exchange(x, plan, parts, needs)

    @staticmethod
    def backward(ctx, g):
        return _exchange_back(g.contiguous(), ctx.plan, ctx.parts, ctx.needs), None, None, None


def _halo(x: torch.Tensor, plan: MeshPlan, h_in: int, h_out: int, k_eff: int, stride: int,
          pad_top: int) -> tuple[torch.Tensor, Rows]:
    """The input rows this rank's output rows read (fetched where others
    own them) and the (top, bottom) padding they need at the image's true
    edges, for a window of ``k_eff`` rows at ``stride`` whose SAME padding
    puts ``pad_top`` rows above row 0."""
    n = plan.num_space_shards
    needs, pads = [], []
    for lo, hi in row_split(h_out, n):
        a, b = lo * stride - pad_top, (hi - 1) * stride - pad_top + k_eff
        needs.append((max(a, 0), min(b, h_in)))
        pads.append((max(-a, 0), max(b - h_in, 0)))
    return _Exchange.apply(x, plan, row_split(h_in, n), needs), pads[plan.space_index]


def conv_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *, rate: int,
              compute_dtype: torch.dtype | None, plan: MeshPlan, h: int) -> torch.Tensor:
    """This rank's rows of ``conv2d_same(whole, w, b, rate=...,
    compute_dtype=...)``, from its rows ``x`` [B,Cin,rows,W] of an ``h``-row
    input."""
    k = w.shape[2]
    if k == 1:
        return conv2d_same(x, w, b, rate=rate, compute_dtype=compute_dtype)
    x, h_pad = _halo(x, plan, h, h, (k - 1) * rate + 1, 1, same_padding(k, rate)[0])
    return conv2d_same(x, w, b, rate=rate, compute_dtype=compute_dtype, h_pad=h_pad)


def pool_rows(x: torch.Tensor, window: int, stride: int, *, plan: MeshPlan,
              h: int) -> tuple[torch.Tensor, int]:
    """(this rank's rows of ``max_pool_same(whole, window, stride)``, the
    whole output's rows), from its rows ``x`` of an ``h``-row input."""
    h_out = -(-h // stride)
    x, h_pad = _halo(x, plan, h, h_out, window, stride, _same_pool_padding(h, window, stride)[0])
    return max_pool_same(x, window, stride, h_pad=h_pad), h_out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, h):
        parts = row_split(h, plan.num_space_shards)
        ctx.rows = parts[plan.space_index]
        cap = max(hi - lo for lo, hi in parts)
        got = _all_gather(_pack(x, [ctx.rows], ctx.rows[0], cap), plan)
        return torch.cat([t[:, :, :hi - lo] for t, (lo, hi) in zip(got, parts)], 2)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return g[:, :, lo:hi], None, None


def gather_rows(x: torch.Tensor, plan: MeshPlan, h: int) -> torch.Tensor:
    """The whole ``h``-row tensor [B,C,h,W] from every space rank's rows
    ``x``; its gradient is this rank's rows of the whole one's (every rank
    computes the same function of the whole tensor)."""
    return x if plan.num_space_shards == 1 else _GatherRows.apply(x, plan, h)
