"""What the port's own spans and counters recorded in the run's process
(``em_adapt_torch/utils/tracing.py``): the entries of the window and of
the traced span. Host times come from the window, which ran with no
profiler (whose recording of every operator would slow the host); device
times from the traced span's stage event pairs. Each function returns None
where the ring does not hold what it reads: a checkout without the
recorder, a run with no traced entry, or a ring that dropped part of the
window."""

from __future__ import annotations


def ring() -> list[dict] | None:
    """The recorder's entries, oldest first; None without the recorder."""
    try:
        from em_adapt_torch.utils import tracing
    except ImportError:
        return None
    return tracing.entries()


def _first_traced(entries: list[dict], kind: str) -> int | None:
    return next((i for i, e in enumerate(entries) if e["traced"] and e["kind"] == kind), None)


def train_window(r: dict) -> list[dict] | None:
    """The window's steps: the ``r["steps"]`` untraced train entries just
    before the first traced one (the step in which the profiler started)."""
    entries = ring() if r.get("kind") == "train" and r.get("steps") else None
    first = _first_traced(entries, "train") if entries else None
    n = r.get("steps", 0)
    if first is None or first < n:
        return None
    window = entries[first - n:first]
    if any(e["kind"] != "train" or e["traced"] for e in window):
        return None
    return window


def train_traced(r: dict) -> list[dict] | None:
    """The traced span's steps: the last ``r["trace_steps"]`` traced train
    entries."""
    entries = ring() if r.get("kind") == "train" and r.get("trace_steps") else None
    traced = [e for e in entries or () if e["traced"] and e["kind"] == "train"]
    k = r.get("trace_steps", 0)
    return traced[-k:] if k and len(traced) >= k else None


def eval_traced(r: dict) -> list[dict] | None:
    """The traced pass: the last traced eval entry."""
    entries = ring() if r.get("kind") == "eval" else None
    traced = [e for e in entries or () if e["traced"] and e["kind"] == "eval"]
    return traced[-1:] or None


def eval_window(r: dict) -> list[dict] | None:
    """The window's passes: the untraced eval entries just before the
    traced pass whose images sum to ``r["images"]``."""
    entries = ring() if r.get("kind") == "eval" and r.get("images") else None
    first = _first_traced(entries, "eval") if entries else None
    if first is None:
        return None
    images, start = 0, first
    while images < r["images"] and start > 0:
        e = entries[start - 1]
        if e["kind"] != "eval" or e["traced"]:
            return None
        images += e["images"]
        start -= 1
    return entries[start:first] if images == r["images"] else None


def host_ms(entries: list[dict] | None, *names: str, per_image: bool = False) -> float | None:
    """Host ms under ``names`` an entry (or an image), over ``entries``."""
    if not entries or not any(n in e["host_ns"] for e in entries for n in names):
        return None
    ms = sum(e["host_ns"].get(n, 0) for e in entries for n in names) / 1e6
    return ms / sum(e["images"] for e in entries) if per_image else ms / len(entries)


def counter_ms(entries: list[dict] | None, name: str) -> float | None:
    """The nanosecond counter ``name``'s increments an entry, in ms."""
    if not entries or any(name not in e["counters"] for e in entries):
        return None
    return sum(e["counters"][name] for e in entries) / 1e6 / len(entries)


def device_ms(entries: list[dict] | None, name: str, per_image: bool = False) -> float | None:
    """Device ms of the stage span ``name`` (its event pairs) an entry (or
    an image), over ``entries``; None where an entry has no such pair."""
    if not entries:
        return None
    total = 0.0
    for e in entries:
        pairs = [s["device_ms"] for s in e["spans"] if s["name"] == name and "device_ms" in s]
        if not pairs:
            return None
        total += sum(pairs)
    images = sum(e["images"] for e in entries)
    return total / images if per_image else total / len(entries)
