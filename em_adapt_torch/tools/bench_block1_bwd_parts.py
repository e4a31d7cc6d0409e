"""Cost decomposition of K3, the fused block1 backward, on the card.

    python -m em_adapt_torch.tools.bench_block1_bwd_parts [--batch 6] [--iters 100]

The counterpart of the JAX package's probe ``tools/bench_block1_bwd_parts.py``
(its ``pallas_call`` at l.169): K3's own source, ``csrc/block1_bwd.cu``,
built once per variant with one part switched off at compile time (the
macros of :data:`VARIANTS`; ``full`` defines none and is the production
library), each variant timed at B = ``--batch``, 321x321, on the probe's
inputs. One JSON line per variant: its time, the time it saves against
``full`` and its share of it, ptxas's registers and spills, the HMMA
instructions of its SASS (``cuobjdump -sass``), and the products of the
parts it switches off: the FLOP the kernel executes for them, the FLOP
the function needs, and the floor of the executed FLOP at the card's
peak. The parts overlap inside a CTA, so the savings need not add up to
``full``'s time.

Every variant but ``skip_update`` computes a definite function, stated
in :func:`block1_bwd_parts_plain`, and the card check in ``chip_smoke.py``
holds each against it. ``skip_update`` keeps only each CTA's first store
into its partial row (its later tiles issue no reductions), so its
result depends on which tiles a CTA takes;
its HMMA count, equal to ``full``'s, shows that no product was dropped.

Without a CUDA card the tool raises; it never times the plain versions
in the card's place.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import re
import statistics
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from em_adapt_torch.ops import block1 as k23
from em_adapt_torch.utils.timing import BF16_TENSOR_OPS_PER_S, SIMT_OPS_PER_S, cuda_ms_per_launch


class Variant(NamedTuple):
    #: The macros of csrc/block1_bwd.cu the variant is built with.
    defines: tuple[str, ...]
    #: The parts of K3 it switches off (``full``: its whole work). "pool"
    #: is the windows' max and first match and the dz2 routing,
    #: "first_match" the max and first-match search alone, "update" each
    #: later tile's reductions into the CTA's partial row.
    parts_off: tuple[str, ...]


#: The variants, named as the JAX probe names its modes, with K3's own
#: parts added.
VARIANTS: dict[str, Variant] = {
    "full": Variant((), ("conv1_1", "conv1_2", "pool", "dw2", "dy1", "dw1", "update")),
    "skip_fm": Variant(("K3_SKIP_FM",), ("first_match",)),
    "skip_pool": Variant(("K3_SKIP_POOL",), ("pool",)),
    "skip_conv2": Variant(("K3_SKIP_CONV2",), ("conv1_2",)),
    "grads_only": Variant(("K3_SKIP_CONV2", "K3_SKIP_POOL"), ("conv1_2", "pool")),
    "skip_dw2": Variant(("K3_SKIP_DW2",), ("dw2",)),
    "skip_dy1": Variant(("K3_SKIP_DY1",), ("dy1",)),
    "skip_dw1": Variant(("K3_SKIP_DW1",), ("dw1",)),
    "skip_update": Variant(("K3_SKIP_UPDATE",), ("update",)),
    "recompute_only": Variant(("K3_RECOMPUTE_ONLY",), ("pool", "dw2", "dy1", "dw1", "update")),
}

#: K3's tile geometry (csrc/block1_bwd.cu): pooled rows and columns per
#: tile, y1 positions recomputed per tile, conv1_2's rows as issued to
#: mma (255 y2 positions in 16 tiles of 16), owned positions rounded up
#: to 16 (dW2's and dW1's depth, dy1's rows), dW1's 27 rows padded to 32.
TILE_P, TILE_Q = 5, 6
Y1_PER_TILE = 17 * 19
Y2_ROWS = 256
OWNED_PAD = 128
DW1_ROWS = 32

NOTE = ("The parts overlap inside a CTA (its phases share barriers, shared memory and the "
        "SM's issue slots; the next tile's x and dy loads run under conv1_1, the partial row's "
        "reductions under dy1), so the savings need not add up to full's time.")

#: Launches of the variants made by :func:`block1_bwd_parts` (plain runs
#: not counted). No main path runs them.
launches = 0


def _defines(variant: str) -> tuple[str, ...]:
    if variant not in VARIANTS:
        raise ValueError(f"unknown K3 variant {variant!r}; expected one of {list(VARIANTS)}")
    return VARIANTS[variant].defines


def route_to_corner_plain(y2: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The pool's backward when every window's first match is its position
    (0, 0), as ``skip_fm`` routes (the JAX probe's constant first match):
    pooled (P, Q) sends dy to y2 (2P - 1, 2Q - 1), dropped where that is
    the pool's padding (P = 0 or Q = 0). No two windows share a corner,
    so each y2 position takes at most one gradient, in y2's dtype."""
    b, f, h, w = y2.shape
    oh, ow = dy.shape[2:]
    acc = torch.zeros(b, f, h + 2, w + 2, dtype=y2.dtype, device=y2.device)
    acc[..., 0:2 * oh:2, 0:2 * ow:2] = dy.to(y2.dtype)
    return acc[..., 1:h + 1, 1:w + 1]


def block1_bwd_parts_plain(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    dy: torch.Tensor, variant: str,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the ``variant`` build of K3 computes, in plain PyTorch, with
    :func:`~em_adapt_torch.ops.block1.block1_bwd_plain`'s arguments and
    results ((dw1, db1, dw2, db2), f32, OIHW) and its rounding points:

    - ``full``: K3's function, ``block1_bwd_plain`` to the bit;
    - ``skip_fm``: dz2 from :func:`route_to_corner_plain`;
    - ``skip_pool``: dz2 := y2 (dy is neither fetched nor read);
    - ``skip_conv2``: y2 := y1, then as ``full``;
    - ``grads_only``: y2 := y1 and dz2 := y2, so dz2 = y1;
    - ``skip_dw2``, ``skip_dw1``: that leaf 0, the rest as ``full``;
    - ``skip_dy1``: dz1 = 0, so dw1 = db1 = 0;
    - ``recompute_only``: db1 = sum of y1, db2 = sum of y2, dw1 = dw2 = 0.

    ``skip_update`` has none: its result depends on the tile-to-CTA map."""
    _defines(variant)
    if variant == "skip_update":
        raise ValueError("skip_update is timing-only: its result depends on the tile-to-CTA map")
    dt = x.dtype
    y1 = k23.conv1_plain(x, w1, b1)
    w2c = w2.to(dt).float()
    if variant in ("skip_conv2", "grads_only"):
        y2 = y1
    else:
        y2 = F.relu(F.conv2d(y1.float(), w2c, padding=1) + b2.float()[None, :, None, None]).to(dt)
    f32 = dict(dtype=torch.float32, device=x.device)
    if variant == "recompute_only":
        return (torch.zeros(w1.shape, **f32), y1.float().sum((0, 2, 3)),
                torch.zeros(w2.shape, **f32), y2.float().sum((0, 2, 3)))
    if variant in ("skip_pool", "grads_only"):
        dz2 = y2.float()
    else:
        routed = (route_to_corner_plain(y2, dy) if variant == "skip_fm"
                  else k23.pool_route_plain(y2, dy.to(dt)))
        dz2 = torch.where(y2 > 0, routed, 0).float()
    db2 = dz2.sum((0, 2, 3))
    if variant == "skip_dw2":
        dw2 = torch.zeros(w2.shape, **f32)
    else:
        dw2 = torch.nn.grad.conv2d_weight(y1.float(), w2.shape, dz2, padding=1)
    if variant == "skip_dy1":
        dz1 = torch.zeros(y1.shape, **f32)
    else:
        dy1 = torch.nn.grad.conv2d_input(y1.shape, w2c, dz2, padding=1)
        dz1 = torch.where(y1 > 0, dy1, 0)
    db1 = dz1.sum((0, 2, 3))
    if variant == "skip_dw1":
        dw1 = torch.zeros(w1.shape, **f32)
    else:
        dw1 = torch.nn.grad.conv2d_weight(x.float(), w1.shape, dz1.to(dt).float(), padding=1)
    return dw1, db1, dw2, db2


def block1_bwd_parts(
    x: torch.Tensor, dy: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
    b2: torch.Tensor, variant: str,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``block1_bwd``'s arguments and results, through the ``variant``
    build of ``csrc/block1_bwd.cu`` on a CUDA tensor (``full`` is K3's own
    library) and :func:`block1_bwd_parts_plain` on a CPU tensor."""
    defines = _defines(variant)
    if k23.check_bwd_args(x, dy, w1) == "cpu":
        return block1_bwd_parts_plain(x, w1, b1, w2, b2, dy, variant)
    grads = k23.launch_bwd(x, dy, w1, b1, w2, b2, defines)
    global launches
    launches += 1
    return grads


def part_flops(b: int, h: int) -> dict[str, tuple[int, int]]:
    """Per part of K3 at batch b, h x h: (FLOP the kernel executes, FLOP
    the function needs). Executed counts follow K3's tiles (5,346 at B=6,
    321^2): conv1_1 at 323 y1 positions a tile, conv1_2, dW2, dy1 and dW1
    at the shapes issued to mma (padding included). The needed ones sum to
    K3's operation count with the recompute. The pool, the first match and
    the updates do no products."""
    oh = (h + 1) // 2
    tiles = b * -(-oh // TILE_P) * -(-oh // TILE_Q)
    px = b * h * h
    f = 64
    return {
        "conv1_1": (2 * Y1_PER_TILE * 27 * f * tiles, 2 * 27 * f * px),
        "conv1_2": (2 * Y2_ROWS * 576 * f * tiles, 2 * 576 * f * px),
        "pool": (0, 0),
        "first_match": (0, 0),
        "dw2": (2 * 576 * f * OWNED_PAD * tiles, 2 * 576 * f * px),
        "dy1": (2 * OWNED_PAD * f * 576 * tiles, 2 * 576 * f * px),
        "dw1": (2 * DW1_ROWS * f * OWNED_PAD * tiles, 2 * 27 * f * px),
        "update": (0, 0),
    }


def _floor_ms(part: str, executed: int) -> float:
    rate = SIMT_OPS_PER_S if part == "conv1_1" else BF16_TENSOR_OPS_PER_S
    return executed / rate * 1e3


def probe_inputs(b: int, h: int, device):
    """The JAX probe's inputs (its l.59-66): ``np.random.default_rng(0)``,
    x = N(0, 1) * 10, w1 = N * 0.1, w2 = N * 0.05, zero biases, dy = N(0,
    1), x, w and dy in bf16; drawn in its NHWC/HWIO shapes, laid out NCHW
    and OIHW. Returns (x, dy, w1, b1, w2, b2) on ``device``."""
    g = np.random.default_rng(0)
    oh = (h + 1) // 2
    bf = torch.bfloat16
    x = torch.from_numpy(g.normal(size=(b, h, h, 3)).astype(np.float32) * 10).to(bf)
    w1 = torch.from_numpy(g.normal(size=(3, 3, 3, 64)) * 0.1).to(bf)
    w2 = torch.from_numpy(g.normal(size=(3, 3, 64, 64)) * 0.05).to(bf)
    dy = torch.from_numpy(g.normal(size=(b, oh, oh, 64))).to(bf)
    b1, b2 = torch.zeros(64), torch.zeros(64)
    out = (x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2), w1.permute(3, 2, 0, 1), b1,
           w2.permute(3, 2, 0, 1), b2)
    return tuple(t.contiguous().to(device) for t in out)


def build_variants() -> dict[str, Path]:
    """Every variant's library, one nvcc per variant, all started together."""
    from em_adapt_torch.utils import build

    with cf.ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = pool.map(lambda v: build.build("block1_bwd", v.defines), VARIANTS.values())
        return dict(zip(VARIANTS, paths))


def ptxas_report(log: str, kernel: str = "block1_bwd_kernel") -> dict:
    """Registers, spill stores and loads, and static shared memory that
    ``ptxas -v`` reports for the function whose name holds ``kernel``."""
    out, current = {}, ""
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)", line)
        if m:
            current = m.group(1)
        if kernel not in current:
            continue
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            out["spill_stores"], out["spill_loads"] = int(m.group(1)), int(m.group(2))
        if m := re.search(r"Used (\d+) registers", line):
            out["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out["static_smem"] = int(s.group(1)) if s else 0
    if "registers" not in out or "spill_stores" not in out:
        raise RuntimeError(f"no ptxas report of {kernel} in the build log:\n{log}")
    return out


def variant_reports(paths: dict[str, Path]) -> dict[str, dict]:
    """Per variant: its library, ptxas's report and its SASS's HMMA count."""
    from em_adapt_torch.utils import build

    with cf.ThreadPoolExecutor(len(paths)) as pool:  # one cuobjdump per library, together
        hmma = dict(zip(paths, pool.map(lambda p: build.sass_count(p, "HMMA"), paths.values())))
    reports = {}
    for name, path in paths.items():
        log = build.build_logs.get(("block1_bwd", VARIANTS[name].defines), "")
        reports[name] = dict(library=path.name, **ptxas_report(log), hmma=hmma[name])
    return reports


def time_variants(device, b: int, iters: int, reps: int = 5, warmup: int = 3) -> dict[str, float]:
    """Each variant's milliseconds per launch (the partial-sum reduction
    included) at b x 321^2 on :func:`probe_inputs`: ``iters`` back-to-back
    launches between CUDA events, median of ``reps`` such runs, the
    variants taken in turn within each round so that all see the card
    alike. Each variant is launched ``warmup + reps * iters`` times."""
    args = probe_inputs(b, 321, device)
    runs = {name: (lambda name=name: block1_bwd_parts(*args, name)) for name in VARIANTS}
    for fn in runs.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in VARIANTS}
    for _ in range(reps):
        for name, fn in runs.items():
            times[name].append(cuda_ms_per_launch(fn, iters, reps=1, warmup=0))
    return {name: statistics.median(t) for name, t in times.items()}


def records(reports: dict[str, dict], ms: dict[str, float], b: int, h: int = 321) -> list[dict]:
    """One record per variant: time, saving against ``full``, share of
    it, ptxas's report, HMMA count, and the products of the parts it
    switches off (executed FLOP, needed FLOP, floor of the executed FLOP
    at the card's peak)."""
    flops = part_flops(b, h)
    out = []
    for name, (defines, off) in VARIANTS.items():
        executed = sum(flops[p][0] for p in off)
        out.append(dict(
            variant=name, defines=list(defines), batch=b, size=h,
            ms=ms[name], ms_saved=ms["full"] - ms[name], share_of_full=ms[name] / ms["full"],
            **reports[name], parts_off=list(off), flop_executed=executed,
            flop_needed=sum(flops[p][1] for p in off),
            floor_ms=sum(_floor_ms(p, flops[p][0]) for p in off),
        ))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=6)
    parser.add_argument("--iters", type=int, default=100, help="back-to-back launches per run")
    args = parser.parse_args(argv)

    from em_adapt_torch.device import resolve_device

    device = resolve_device(None)  # raises without a card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    reports = variant_reports(build_variants())
    ms = time_variants(device, args.batch, args.iters)
    print(card, flush=True)
    for record in records(reports, ms, args.batch):
        print(json.dumps(record), flush=True)
    print(NOTE, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
