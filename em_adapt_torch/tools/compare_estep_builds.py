"""K1 against other builds of its own source on the card: bits and time.

    git show <commit>:em_adapt_torch/csrc/estep.cu > build/estep_other.cu
    python -m em_adapt_torch.tools.compare_estep_builds build/estep_other.cu
    python -m em_adapt_torch.tools.compare_estep_builds --time build/estep_other.cu \\
        em_adapt_torch/csrc/estep.cu:K1_DIGIT_BITS=2 em_adapt_torch/csrc/estep.cu:K1_DIGIT_BITS=5

Run from the repository root. Each build is a SOURCE (any version of
``csrc/estep.cu`` with the same C interface) compiled with K1's own nvcc
flags, and ``-D`` for each comma-separated macro after a colon, into
``build/`` by ``compare_block1_bwd_builds.build_other``; the tool prints
ptxas's registers and spills for each of its three instances (1, 2 and 4
pixels a thread). Every build computes the same function, so each runs
beside the production K1 on ``chip_smoke.py::k1_cases`` (the cases of
``check_estep``: ``realistic_batch`` at B=6 and B=30, the single-class
case, the five goldens, the edge cases), and the tool prints per build
and case how many thresholds and how many outputs differ in their bits;
the last such line is the total, and the exit code is 1 when it is not
0 (the thread count is the same in every build, so the block sums keep
their order and the outputs their bits). A case larger than a build
takes (65x65 in a build whose image is one CTA) is skipped for that
build, and the tool says so.

With ``--time``, every build and the production K1 run in turns at B=6
and B=30 in two tag regimes: ``realistic_batch`` (background and 1-3
classes an image) and ``all_tags`` (every pixel's label drawn from all
21 classes, as ``SyntheticVOC`` draws them, so every image does all 105
visits). For each it prints one JSON line with the median, least and
largest of 7 rounds of 100 back-to-back launches between CUDA events;
torch.profiler's device time per launch (mean of 50); its fixed cost,
the profiler's device time of the same call on all-void labels (no
visit runs; back-to-back events would time the host's enqueue there);
the cost of one present visit, (device time - fixed cost) / the
busiest image's present visits; and its dependent block rounds per
present visit, from ``em_estep_digit_bits`` (a source without it
bisects: 31). Without a CUDA card it raises.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

from em_adapt_torch.ops import estep_kernel as k1
from em_adapt_torch.tools.compare_block1_bwd_builds import build_other
from em_adapt_torch.tools.compare_block1_fwd_builds import parse_build
from em_adapt_torch.utils.timing import cuda_ms_per_launch

def all_tags(rng: np.random.Generator, b: int, hw: int = 41, c: int = 21):
    """Score maps whose every image carries all ``c`` tags: each pixel's
    label drawn from all classes."""
    scores = rng.normal(size=(b, hw, hw, c)).astype(np.float32) * 3.0
    label = rng.integers(0, c, size=(b, hw, hw)).astype(np.float32)
    orders = np.stack([rng.permutation(np.arange(1, c)) for _ in range(5)]).astype(np.int32)
    return scores, label, orders


def digit_bits(lib) -> int:
    """The round width a library was built with (1: a bisection)."""
    if not hasattr(lib, "em_estep_digit_bits"):
        return 1
    lib.em_estep_digit_bits.restype = ctypes.c_int
    return lib.em_estep_digit_bits()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("builds", nargs="+", metavar="SOURCE[:MACRO=VALUE,...]",
                        help="other versions of csrc/estep.cu, with their -D macros")
    parser.add_argument("--time", action="store_true",
                        help="time every build beside the production K1 at B=6 and B=30")
    args = parser.parse_args(argv)

    from em_adapt_torch.device import card_info, resolve_device

    device = resolve_device(None)  # raises without a card
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke
    from em_adapt_torch.tools.bench_block1_bwd_parts import ptxas_report
    from em_adapt_torch.utils import build

    specs = [parse_build(s) for s in args.builds]
    with cf.ThreadPoolExecutor(len(specs) + 1) as pool:  # one nvcc per build, together
        production = pool.submit(build.build, "estep")
        libs = list(pool.map(lambda s: build_other(s[0], "estep", s[1]), specs))
        production.result()
    print(card_info(), flush=True)
    logs = [("production", k1._lib(), build.build_logs[("estep", ())])]
    logs += [(spec, lib, log) for spec, (lib, log) in zip(args.builds, libs)]
    for spec, lib, log in logs:
        # A build with cluster instances reports both of each width.
        kinds = [(" one CTA", "Lb0E"), (" cluster", "Lb1E")] if "Lb1E" in log else [("", "")]
        for kind, tag in kinds:
            reports = [ptxas_report(log, f"estep_kernelILi{ppt}E{tag}") for ppt in (1, 2, 4)]
            print(f"build {spec}{kind}: {digit_bits(lib)} bits a round, "
                  f"{k1.search_rounds(digit_bits(lib))} rounds a present visit; ptxas (1, 2, 4 "
                  f"pixels a thread) {[r['registers'] for r in reports]} registers, "
                  f"{[r['spill_stores'] for r in reports]} B spill stores, "
                  f"{[r['spill_loads'] for r in reports]} B spill loads", flush=True)

    total = 0
    cases = [(name, *chip_smoke.k1_inputs(scores, label, orders, device, **kw))
             for name, scores, label, orders, kw, _ in chip_smoke.k1_cases()]
    for spec, (lib, _) in zip(args.builds, libs):
        for name, kargs, kw in cases:
            if kargs[0].shape[2] > lib.em_estep_max_pixels():
                print(f"{spec} {name}: skipped, {kargs[0].shape[2]} pixels an image exceed "
                      f"the build's {lib.em_estep_max_pixels()}", flush=True)
                continue
            out, th = k1.estep_kernel(*kargs, **kw)
            out_o, th_o = k1.launch(lib, *kargs, **kw)
            torch.cuda.synchronize()
            th_differ = int((th.view(torch.int32) != th_o.view(torch.int32)).sum())
            out_differ = int((out.view(torch.int32) != out_o.view(torch.int32)).sum())
            total += th_differ + out_differ
            print(f"{spec} {name}: {th_differ} of {th.numel()} thresholds and {out_differ} of "
                  f"{out.numel()} outputs differ from the production K1", flush=True)
    print(f"differing thresholds and outputs in all: {total}", flush=True)

    if args.time:
        runs = {spec: lib for spec, (lib, _) in zip(args.builds, libs)}
        runs["production"] = k1._lib()
        for regime, make in (("realistic_batch", chip_smoke.realistic_batch),
                             ("all_tags", all_tags)):
            for b in (6, 30):
                scores, label, orders = make(np.random.default_rng(b), b)
                kargs, kw = chip_smoke.k1_inputs(scores, label, orders, device,
                                                 **chip_smoke.K1_RECIPE)
                void = (kargs[0], torch.full_like(kargs[1], 255), *kargs[2:])
                present = chip_smoke.present_visits(label, orders)
                times = {spec: [] for spec in runs}
                for _ in range(7):
                    for spec, lib in runs.items():
                        times[spec].append(cuda_ms_per_launch(
                            lambda lib=lib: k1.launch(lib, *kargs, **kw),
                            launches=100, reps=1, warmup=3))
                for spec, lib in runs.items():
                    prof_ms, fixed_ms = (chip_smoke.profiled_kernel_ms(
                        lambda lib=lib, a=a: k1.launch(lib, *a, **kw), "estep_kernel",
                        launches=50) for a in (kargs, void))
                    visit_us = (None if prof_ms is None or fixed_ms is None
                                else (prof_ms - fixed_ms) / max(present) * 1e3)
                    print(json.dumps({
                        "build": spec, "regime": regime, "batch": b,
                        "ms": statistics.median(times[spec]), "min": min(times[spec]),
                        "max": max(times[spec]), "prof_ms": prof_ms, "fixed_ms": fixed_ms,
                        "visit_us": visit_us, "busiest_visits": max(present),
                        "rounds_per_visit": k1.search_rounds(digit_bits(lib))}), flush=True)
        print(card_info(), flush=True)
    return int(total != 0)


if __name__ == "__main__":
    raise SystemExit(main())
