"""K3 against another version of its own source, element by element, on the card.

    git show <commit>:em_adapt_torch/csrc/block1_bwd.cu > build/block1_bwd_other.cu
    python -m em_adapt_torch.tools.compare_block1_bwd_builds [--time] build/block1_bwd_other.cu

Run from the repository root. The other source (any version of
``csrc/block1_bwd.cu`` with the same C interface) is compiled with K3's own
nvcc flags into ``build/``; both libraries then run on the K3 cases of
``chip_smoke.py::check_block1_bwd`` (the same seeds), plus B=1, 161^2, and
the tool prints per case and leaf how many of the f32 elements differ in
their bits, the largest difference, and how many of the other build's
values are subnormal (a sum that ``red.global.add.f32``, which flushes
subnormals, would change). The last line is the total of differing
elements. With ``--time`` both builds then run in turns at B=6, 321x321
(7 rounds of 100 back-to-back launches between CUDA events each), and
the tool prints one JSON line per build with the median, least and
largest. Without a CUDA card it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from em_adapt_torch.ops import block1 as k23
from em_adapt_torch.utils import build

#: chip_smoke.py's K3 cases (name, batch, size, kind; seed 10 * size + batch),
#: and B=1, 161^2, where CTAs with one tile and with two run side by side.
CASES = (("B=6 321x321", 6, 321, "he"), ("B=6 321x321 ties", 6, 321, "ties"),
         ("B=1 33x33", 1, 33, "he"), ("B=2 41x41 large bias", 2, 41, "large bias"),
         ("B=2 33x33 ties", 2, 33, "ties"), ("B=1 65x65", 1, 65, "he"),
         ("B=1 161x161", 1, 161, "he"), ("B=1 161x161 ties", 1, 161, "ties"))


def build_other(source: Path, name: str = "block1_bwd",
                defines: tuple[str, ...] = ()) -> tuple[ctypes.CDLL, str]:
    """The library built from ``source``, another version of
    ``csrc/<name>.cu``, with the kernels' nvcc flags and ``-D`` for each of
    ``defines``, its launch function typed as ``ops.block1`` (or, for
    ``estep``, ``ops.estep_kernel``) types it; and nvcc's report."""
    flags = build._flags(tuple(defines))
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    tag = "".join(f"+{d}" for d in defines)
    target = build.BUILD_DIR / f"lib{name}_other{tag}-{digest}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *flags, "-o", str(target), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA build of {source} failed ({proc.returncode}):\n{proc.stdout}")
    lib = ctypes.CDLL(str(target))
    if name == "estep":
        from em_adapt_torch.ops.estep_kernel import type_library

        return type_library(lib), proc.stdout
    fn, pointers = k23._LAUNCH[name]
    p, i = ctypes.c_void_p, ctypes.c_int
    getattr(lib, fn).argtypes = [p] * pointers + [i] * 3 + [p]
    getattr(lib, fn).restype = i
    return lib, proc.stdout


def run_other(lib: ctypes.CDLL, x, dy, w1, b1, w2, b2):
    """One launch of the other build, with ``ops.block1.launch_bwd``'s
    arguments and buffers."""
    b, _, h, w = x.shape
    w1c, b1c, w2c, b2c = k23._card_args("block1_bwd", x, w1, b1, w2, b2)
    f32 = dict(dtype=torch.float32, device=x.device)
    out = (torch.empty(64, 3, 3, 3, **f32), torch.empty(64, **f32),
           torch.empty(64, 64, 3, 3, **f32), torch.empty(64, **f32))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    partials = torch.empty(sms, k23.BWD_PARTIAL_FLOATS, **f32)
    err = lib.em_block1_bwd_launch(
        x.data_ptr(), dy.data_ptr(), w1c.data_ptr(), b1c.data_ptr(), w2c.data_ptr(),
        b2c.data_ptr(), *(t.data_ptr() for t in out), partials.data_ptr(), b, h, w,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"the other build's launch failed ({err})")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("source", type=Path, help="the other version of csrc/block1_bwd.cu")
    parser.add_argument("--time", action="store_true",
                        help="time the other build beside K3 at B=6, 321x321")
    args = parser.parse_args(argv)

    from em_adapt_torch.device import card_info, resolve_device

    device = resolve_device(None)  # raises without a card
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke

    lib, log = build_other(args.source)
    print("other build: " + " ".join(
        line.strip() for line in log.splitlines() if "registers" in line or "spill" in line))
    total = 0
    for name, b, h, kind in CASES:
        case = chip_smoke.bwd_case(np.random.default_rng(10 * h + b), b, h, kind, device)
        new = k23.block1_bwd(*case)
        old = run_other(lib, *case)
        torch.cuda.synchronize()
        texts = []
        for leaf, n, o in zip(("dw1", "db1", "dw2", "db2"), new, old):
            differ = int((n.view(torch.int32) != o.view(torch.int32)).sum())
            tiny = float(torch.finfo(torch.float32).tiny)
            subnormal = int(((o != 0) & (o.abs() < tiny)).sum())
            total += differ
            texts.append(f"{leaf}: {differ} of {n.numel()} elements differ (max|diff| "
                         f"{float((n - o).abs().max()):.3e}; {subnormal} subnormal in the other)")
        print(f"{name}: " + "; ".join(texts), flush=True)
    print(f"differing elements in all: {total}")
    if args.time:
        from em_adapt_torch.utils.timing import cuda_ms_per_launch

        case = chip_smoke.bwd_case(np.random.default_rng(6), 6, 321, "he", device)
        runs = {"production": lambda: k23.block1_bwd(*case),
                str(args.source): lambda: run_other(lib, *case)}
        times = {spec: [] for spec in runs}
        for _ in range(7):
            for spec, run in runs.items():
                times[spec].append(cuda_ms_per_launch(run, launches=100, reps=1, warmup=3))
        for spec, t in times.items():
            print(json.dumps({"build": spec, "batch": 6, "size": 321, "ms": statistics.median(t),
                              "min": min(t), "max": max(t)}), flush=True)
        print(card_info(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
