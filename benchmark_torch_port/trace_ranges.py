"""Readings of a ``torch.profiler`` trace that ``harness.read_trace`` does
not keep: the device time of the work launched inside a host range (a
``record_function`` range, matched to its kernels by the trace's
correlation ids), and the device's idle at the two ends of the traced
span. Both read the events of ``export_chrome_trace`` in one pass each."""

from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile

import harness

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Saved:
    """A profiler's trace, exported once (a profiler saves its trace only
    once): ``events``, and ``export_chrome_trace``, which copies the saved
    file, for ``harness.read_trace``. A context manager that removes the
    file."""

    def __init__(self, prof):
        fd, self.path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            self.events = json.load(f)["traceEvents"]

    def export_chrome_trace(self, path: str) -> None:
        shutil.copyfile(self.path, path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        os.remove(self.path)


def _span(events: list[dict], window: str) -> tuple[float, float] | None:
    """(start, end) in µs of the host span named ``window``."""
    for e in events:
        if (e.get("ph") == "X" and e.get("name") == window
                and e.get("cat") in ("user_annotation", "cpu_op")):
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return None


def range_device_s(events: list[dict], name: str, window: str) -> float | None:
    """Seconds of device work (kernels, copies, memsets) launched while a
    host range ``name`` that starts inside the span ``window`` was open:
    the launches (runtime and driver calls) inside the ranges give the
    correlation ids of the device events summed. None where the trace has
    no such span or range."""
    span = _span(events, window)
    if span is None:
        return None
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("ph") == "X" and e.get("name") == name
                    and e.get("cat") == "user_annotation" and span[0] <= float(e["ts"]) < span[1])
    if not ranges:
        return None
    starts = [s for s, _ in ranges]
    launched = set()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in LAUNCH_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        i = bisect.bisect_right(starts, float(e["ts"])) - 1
        if corr is not None and i >= 0 and float(e["ts"]) < ranges[i][1]:
            launched.add(corr)
    return sum(float(e.get("dur", 0)) for e in events
               if e.get("ph") == "X" and e.get("cat") in harness.DEVICE_CATS
               and e.get("args", {}).get("correlation") in launched) / 1e6


def edge_idle_s(events: list[dict], window: str) -> tuple[float, float] | None:
    """(seconds from the span's start to its first device event, seconds
    from its last device event's end to the span's end); None where the
    span holds no device event."""
    span = _span(events, window)
    if span is None:
        return None
    first, last = None, None
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in harness.DEVICE_CATS:
            continue
        s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if t <= span[0] or s >= span[1]:
            continue
        first = s if first is None else min(first, s)
        last = t if last is None else max(last, t)
    if first is None:
        return None
    return max(0.0, first - span[0]) / 1e6, max(0.0, span[1] - last) / 1e6
