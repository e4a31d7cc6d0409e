"""Run one cell of the benchmark of ``em_adapt_torch`` on the card.

    python3 benchmark_torch_port/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Loads the cell (``workloads/<cell>.json``), runs its window kind
(``drivers/<kind>.py``): set-up, a window of ``--seconds``, with
``--trace 1`` a short traced span, then the comparison with the plain
reference. Prints the numbers compared beside their limits as the last
lines of standard error, and one JSON object as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` last. Exits 2
without a card (or with fewer than the cell asks for), without the port,
or when a forbidden module was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402


def per_layer(bench: dict, cell: str, records: dict) -> dict:
    """The cell's per-layer metrics that found something to read."""
    out = {}
    for m in harness.cell_metrics(bench, cell, "per_layer"):
        value = harness.load_module(f"metrics/{m['name']}.py").read(records)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(bench: dict, cell: str, out: dict, trace: bool, device_rec: dict):
    """(the result's JSON object, the lines for standard error) of a run:
    the numbers compared beside their limits come last in both."""
    records = out["records"]
    if trace:
        metrics = per_layer(bench, cell, records)
    else:
        units = {m["name"]: m["unit"] for m in harness.cell_metrics(bench, cell, "end_to_end")}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in out["e2e"].items() if k in units}
    result = {"correct": harness.checks_correct(out["checks"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device_rec}
    tr = records.get("trace")
    if trace and tr:
        device_rec["busy_s"] = tr["busy_s"]
        device_rec["window_s"] = tr["window_s"]
        result["breakdown"] = harness.breakdown(tr)
    compared = {name for name, _, _ in out["checks"]}
    info = {k: v for k, v in out.get("readings", {}).items() if k not in compared}
    lines = [f"readings: {json.dumps(info)}", f"end-to-end: {json.dumps(out['e2e'])}"]
    lines += [f"check {name}: {value!r} limit {limit!r}" for name, value, limit in out["checks"]]
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in out["checks"]}
    return result, lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    harness.set_cache_dirs()
    with open(harness.REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"error: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"error: the cell needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(harness.REPO))
    try:
        import em_adapt_torch  # noqa: F401
    except ImportError as e:
        print(f"error: the port em_adapt_torch is not in this checkout: {e}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = harness.Context(workload=args.workload, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=device)
    driver = harness.load_module(f"drivers/{ctx.spec['driver']}.py")
    out = driver.run(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"error: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 2
    device_rec = harness.device_info(device, cell["chips"], out["memory_peak_bytes"])
    result, lines = result_line(bench, args.workload, out, bool(args.trace), device_rec)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
