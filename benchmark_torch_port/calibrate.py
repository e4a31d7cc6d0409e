"""The readings that the limits of a cell's comparison are set from.

    python3 benchmark_torch_port/calibrate.py --workload <cell> \\
        --seeds <n> [<n> ...] [--control] [--fault NAME] [--seconds S] \\
        [--out PATH]

For each seed, in one process: a run of the cell's window kind (set-up,
a window of ``--seconds``, the comparison) and its readings; with
``--control`` also the control's readings (the reference computed in
fp8, put in the program's place, against the reference in float32); with
``--fault`` the run has that fault planted (``faults.py``). One JSON
line a seed on standard output, and all of them in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault", default=None)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(harness.REPO))
    import faults

    device = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds:
        ctx = harness.Context(workload=args.workload, seed=seed, seconds=args.seconds,
                              trace=False, device=device)
        driver = harness.load_module(f"drivers/{ctx.spec['driver']}.py")
        undo = faults.plant(args.fault) if args.fault else None
        try:
            out = driver.run(ctx)
        finally:
            if undo is not None:
                undo()
        row = {"seed": seed, "fault": args.fault, "program": out["readings"],
               "e2e": out["e2e"], "peak": out["memory_peak_bytes"]}
        if args.control:
            row["control"] = driver.control_readings(ctx)
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "card": torch.cuda.get_device_name(device),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
