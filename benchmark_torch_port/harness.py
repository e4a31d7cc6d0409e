"""What every window kind shares: the files a cell is made of, the
configuration, the feed of device-resident batches, the reduction of a
profiler trace, the comparison's readings and the result's last line.

Everything a cell needs is found by its name: ``workloads/<cell>.json``
names its configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), its window kind (``drivers/<name>.py``) and the
limits of its comparison; ``metrics/<name>.py`` reads one per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
#: Python's compiled bytecode and the CUDA driver's kernel cache, at fixed
#: paths in the checkout (the port builds its CUDA kernels itself, under
#: ``build/em_adapt_torch``).
CACHE = REPO / "build" / "bench_torch_port"
#: Top-level modules that no run may load: the JAX package, JAX, and the
#: scripts that drive it.
FORBIDDEN = ("jax", "jaxlib", "flax", "em_adapt_tpu", "chip_smoke", "bench")


def set_cache_dirs() -> None:
    """Point the caches a run writes into the checkout; set before torch is
    imported. Python's compiled bytecode: where the interpreter's own
    site-packages keep none, every process would compile PyTorch's modules
    from source again (about 8 s of a run's set-up); and the CUDA driver's
    cache of kernels it compiles from PTX."""
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")


def seconds_since_process_start() -> float:
    """Seconds since this process started (Linux's /proc; 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def load_json(rel: str) -> dict:
    with open(BENCH / rel) as f:
        return json.load(f)


def load_module(rel: str):
    """A Python file under the benchmark, by its path (names hold dots)."""
    path = BENCH / rel
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one (the whole
    name, so ``em_adapt_torch`` is not ``em_adapt_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The cell's end-to-end (``kind="end_to_end"``) or per-layer metrics
    from BENCHMARK.json: those whose ``workloads`` list the cell (an
    end-to-end metric with no list is every cell's)."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


class Context:
    """One run: its arguments, its cell's files and the device."""

    #: Overrides applied after the cell's own (the CPU tests' smaller
    #: sizes); with any, the configuration's stated numbers are not checked.
    extra_overrides: tuple[str, ...] = ()

    def __init__(self, *, workload: str, seed: int, seconds: float, trace: bool, device):
        self.workload = workload
        self.spec = load_json(f"workloads/{workload}.json")
        self.config = load_json(f"configs/{self.spec['config']}.json")
        self.traffic = load_json(f"traffic/{self.spec['traffic']}.json")
        self.limits = self.spec.get("limits", {})
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def mark(self, stage: str, sync: bool = False) -> None:
        """Log how far set-up has come since the process started (after
        the card has run what was queued, with ``sync``)."""
        if sync and self.device is not None and self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        self.log(f"set-up: {stage} done at {seconds_since_process_start():.2f} s")

    def experiment_config(self, fixed: tuple[str, ...] = ()):
        """The port's ``ExperimentConfig`` as ``train --preset`` builds it:
        the configuration's preset, the traffic's preset (a batching such as
        the folded batch of 30), their overrides, then the window kind's."""
        from em_adapt_torch.__main__ import train_presets
        from em_adapt_torch.config import ExperimentConfig, apply_overrides

        presets = train_presets()
        overrides = [*presets[self.config["preset"]]]
        if self.traffic.get("preset"):
            overrides += presets[self.traffic["preset"]]
        overrides += [*self.config.get("overrides", []), *self.traffic.get("overrides", []),
                      *fixed, *self.extra_overrides]
        cfg = apply_overrides(ExperimentConfig(), overrides)
        if not self.extra_overrides:  # the configuration's file states what runs
            for group in ("model", "data"):
                for key, want in self.config.get(group, {}).items():
                    got = getattr(getattr(cfg, group), key)
                    got = list(got) if isinstance(got, tuple) else got
                    if got != want:
                        raise ValueError(f"{self.spec['config']}: {group}.{key} runs as {got!r}, "
                                         f"the configuration's file states {want!r}")
        return cfg


class Feed:
    """Batches of a device-resident pool in turn from ``start``, until
    ``limit`` batches were given or ``seconds`` (after the first batch) have
    passed; then ``extra`` batches more. ``on_first`` is called as the first
    batch is taken, ``on_deadline(given)`` once the seconds have passed, and
    ``on_end`` before the feed ends after its ``extra`` batches."""

    def __init__(self, pool: list, start: int, *, limit: int | None = None,
                 seconds: float | None = None, on_first=None, extra: int = 0,
                 on_deadline=None, on_end=None):
        self.pool, self.i, self.limit, self.seconds = pool, start, limit, seconds
        self.on_first, self.given, self.t0 = on_first, 0, None
        self.extra, self.on_deadline, self.on_end, self.over = extra, on_deadline, on_end, None

    def __iter__(self):
        return self

    def __next__(self):
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
            if self.on_first is not None:
                self.on_first()
        elif self.seconds is not None and self.over is None and now - self.t0 >= self.seconds:
            self.over = self.given
            if self.on_deadline is not None:
                self.on_deadline(self.given)
        if self.over is not None and self.given >= self.over + self.extra:
            if self.on_end is not None:
                self.on_end()
            raise StopIteration
        if self.limit is not None and self.given >= self.limit:
            raise StopIteration
        batch = self.pool[self.i % len(self.pool)]
        self.i += 1
        self.given += 1
        return batch


def p95(values: list[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value with at least
    95% of the values at or below it."""
    vals = sorted(values)
    return vals[max(0, math.ceil(0.95 * len(vals)) - 1)]


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger; over the leaves ``keep`` names (default: all)."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - r) / max(r, med) for k, r in ref.items()
            if keep is None or k in keep}


def leaf_gap(prog: dict, ref: dict, keep=None, worst: bool = True) -> tuple[float, str]:
    """The worst of :func:`leaf_gaps` and its leaf; with ``worst=False``
    their median."""
    gaps = leaf_gaps(prog, ref, keep)
    bad = [k for k, g in gaps.items() if not math.isfinite(g)]
    if bad:
        return math.inf, bad[0]
    if not worst:
        return statistics.median(gaps.values()), ""
    name = max(gaps, key=lambda k: (gaps[k], k))
    return gaps[name], name


# -- the profiler's trace ----------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


def read_trace(prof, window: str) -> dict:
    """The device's work inside the host span named ``window`` of a
    ``torch.profiler`` run: each kernel's (and copy's) total seconds and
    launches, the union of their intervals (busy), the span's length, and
    the idle gaps between them, each named by what the host was doing."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == window
             and e.get("cat") in ("user_annotation", "cpu_op")]
    if not spans:
        return {}
    w = spans[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                 for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    kernels: dict[str, list] = {}
    busy, gaps, cursor = 0.0, [], w0
    for s, t, name in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (t - s) / 1e6
        k[1] += 1
        if s > cursor:
            gaps.append((cursor, s))
        busy += max(0.0, t - max(s, cursor))
        cursor = max(cursor, t)
    if cursor < w1:
        gaps.append((cursor, w1))
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
            for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("tid") == w.get("tid") and e.get("pid") == w.get("pid")
            and e["name"] != window]
    named: dict[str, float] = {}
    for s, t in gaps:
        mid = 0.5 * (s + t)
        inner = [h for h in host if h[0] <= mid < h[1]]
        label = max(inner)[2] if inner else "host (no traced call)"
        named[label] = named.get(label, 0.0) + (t - s) / 1e6
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "idle_by_host": named}


def kernel_time(trace: dict, patterns, exclude=()) -> tuple[float, int]:
    """(seconds, launches) of the trace's kernels whose name holds one of
    ``patterns`` and none of ``exclude``."""
    total, count = 0.0, 0
    for name, (s, n) in trace.get("kernels", {}).items():
        if any(p in name for p in patterns) and not any(x in name for x in exclude):
            total += s
            count += n
    return total, count


def breakdown(trace: dict) -> dict:
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(trace["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:160], s] for name, (s, _) in ops],
            "idle_gaps": [[name[:160], s] for name, s in gaps]}


# -- the result ----------------------------------------------------------------

def checks_correct(checks: list[tuple[str, float, float | None]]) -> bool:
    return bool(checks) and all(limit is not None and math.isfinite(value) and value <= limit
                                for _, value, limit in checks)


def device_info(device, count: int, peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(peak)}
