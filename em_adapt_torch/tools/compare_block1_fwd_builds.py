"""K2 against other builds of its own source on the card: bits and time.

    git show <commit>:em_adapt_torch/csrc/block1_fwd.cu > build/block1_fwd_other.cu
    python -m em_adapt_torch.tools.compare_block1_fwd_builds build/block1_fwd_other.cu
    python -m em_adapt_torch.tools.compare_block1_fwd_builds --time \\
        build/block1_fwd_other.cu build/block1_fwd_parts.cu:K2_SKIP_FETCH ...

Run from the repository root. Each build is a SOURCE (any version of
``csrc/block1_fwd.cu`` with the same C interface) compiled with K2's own
nvcc flags, and ``-D`` for each comma-separated macro after a colon, into
``build/`` by ``compare_block1_bwd_builds.build_other``; the tool prints
ptxas's registers and spills and the HMMA count of each. A build with no
macro runs beside the production K2 on the cases of
``chip_smoke.py::check_block1`` (``K2_CASES``, the same seeds), and the
tool prints per case how many of the bf16 outputs differ in their bits and
the largest difference; the last such line is the total, and the exit code
is 1 when it is not 0. A build with macros (a copy of the source with
parts switched off at compile time) computes another function and is only
timed. With ``--time``, every build and the production K2 run in turns at
B=6, 321x321: one JSON line each with the median, least and largest of 7
rounds of 100 back-to-back launches between CUDA events. Without a CUDA
card it raises.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

from em_adapt_torch.ops import block1 as k2
from em_adapt_torch.tools.compare_block1_bwd_builds import build_other
from em_adapt_torch.utils.timing import cuda_ms_per_launch


def parse_build(spec: str) -> tuple[Path, tuple[str, ...]]:
    """``SOURCE[:MACRO,MACRO...]`` -> (the source, its macros)."""
    source, _, macros = spec.partition(":")
    return Path(source), tuple(m for m in macros.split(",") if m)


def run_other(lib, x, w1, b1, w2, b2) -> torch.Tensor:
    """One launch of another build, with ``ops.block1``'s arguments."""
    b, _, h, w = x.shape
    w1c, b1c, w2c, b2c = k2._card_args("block1_fused", x, w1, b1, w2, b2)
    out = torch.empty(b, 64, (h + 1) // 2, (w + 1) // 2, dtype=torch.bfloat16, device=x.device)
    err = lib.em_block1_fwd_launch(
        x.data_ptr(), w1c.data_ptr(), b1c.data_ptr(), w2c.data_ptr(), b2c.data_ptr(),
        out.data_ptr(), b, h, w, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"the other build's launch failed ({err})")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("builds", nargs="+", metavar="SOURCE[:MACRO,...]",
                        help="other versions of csrc/block1_fwd.cu, with their -D macros")
    parser.add_argument("--time", action="store_true",
                        help="time every build beside the production K2 at B=6, 321x321")
    args = parser.parse_args(argv)

    from em_adapt_torch.device import card_info, resolve_device

    device = resolve_device(None)  # raises without a card
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke
    from em_adapt_torch.tools.bench_block1_bwd_parts import ptxas_report
    from em_adapt_torch.utils import build

    specs = [parse_build(s) for s in args.builds]
    with cf.ThreadPoolExecutor(len(specs)) as pool:  # one nvcc per build, together
        libs = list(pool.map(lambda s: build_other(s[0], "block1_fwd", s[1]), specs))
    print(card_info(), flush=True)
    for spec, (lib, log) in zip(args.builds, libs):
        r = ptxas_report(log, "block1_fwd_kernel")
        print(f"build {spec}: ptxas {r['registers']} registers, {r['spill_stores']} B spill "
              f"stores, {r['spill_loads']} B spill loads; "
              f"{build.sass_count(Path(lib._name), 'HMMA')} HMMA in its SASS", flush=True)
    total = 0
    for spec, (source, macros), (lib, _) in zip(args.builds, specs, libs):
        if macros:
            continue
        for name, b, h, large in chip_smoke.K2_CASES:
            case = chip_smoke.block1_case(np.random.default_rng(10 * h + b), b, h, large, device)
            new = k2.block1_fused(*case)
            old = run_other(lib, *case)
            torch.cuda.synchronize()
            differ = int((new.view(torch.int16) != old.view(torch.int16)).sum())
            total += differ
            print(f"{spec} {name}: {differ} of {new.numel()} bf16 outputs differ from the "
                  f"production K2 (max|diff| {float((new.float() - old.float()).abs().max()):.3e})",
                  flush=True)
    if any(not macros for _, macros in specs):
        print(f"differing elements in all: {total}", flush=True)
    if args.time:
        case = chip_smoke.block1_case(np.random.default_rng(6), 6, 321, False, device)
        runs = {spec: (lambda lib=lib: run_other(lib, *case))
                for spec, (lib, _) in zip(args.builds, libs)}
        runs["production"] = lambda: k2.block1_fused(*case)
        times = {spec: [] for spec in runs}
        for _ in range(7):
            for spec, run in runs.items():
                times[spec].append(cuda_ms_per_launch(run, launches=100, reps=1, warmup=3))
        for spec, t in times.items():
            print(json.dumps({"build": spec, "ms": statistics.median(t), "min": min(t),
                              "max": max(t)}), flush=True)
        print(card_info(), flush=True)
    return int(total != 0)


if __name__ == "__main__":
    raise SystemExit(main())
