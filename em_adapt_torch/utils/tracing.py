"""The port's spans and counters: where a training step or an evaluation
pass spends its time, by stage.

A span is a context manager, ``with span(name):``. A root span
(:class:`root`) opens an *entry*: one ``Trainer.fit`` step, or one
``Evaluator.confusion_voc`` pass with the card CRF; every span opened
while it is open adds to that entry, whichever thread opens it (the
autograd engine's, for the mesh's exchanges in a backward pass). Spans
work at two levels:

* always on: the span adds its ``time.perf_counter_ns()`` duration and one
  call to its entry's sum under its name. No profiler call and no CUDA
  call is made;
* traced, while a ``torch.profiler`` records: the span also enters
  ``torch.profiler.record_function(name)``, so that it shows in the
  profiler's trace, stamps its start with ``time.time_ns()`` (the clock of
  a Chrome trace's ``ts + baseTimeNanoseconds``), and a stage span
  (``stage=True``) records a CUDA event pair on the current stream at its
  bounds. Its record (name, id, parent's id, start, events) is kept in its
  entry. The stamp precedes the annotation's start in the trace by a few
  µs; the first annotation of a profiling session, by up to about 0.1 ms
  (the profiler's own set-up inside the call).

The level is probed once an entry, when its root opens: every span of the
entry takes the entry's level, so a profiler that starts inside an entry
traces the entries after it. A span outside any entry probes for itself.

The counters (:func:`waited`) count the program's explicit waits on the
card, per entry and in process-wide totals. Closed entries go to a ring of
the last :data:`RING` (:func:`entries`, oldest first); the events' elapsed
times are read there, so the caller synchronizes the card first.
"""

from __future__ import annotations

import collections
import threading
import time

import torch

#: Entries the ring keeps: a 40-s window of about 2,100 steps with room.
RING = 8192
#: The process-wide counters and what each counts.
COUNTERS = {
    "host_waits": "the program's explicit waits on the card",
    "host_wait_ns": "nanoseconds in those waits",
}

_clock = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled
_lock = threading.Lock()
_counters = dict.fromkeys(COUNTERS, 0)
_ring: collections.deque = collections.deque(maxlen=RING)
_open = None  # the open entry
_next_seq = 0  # the ``seq`` of the next entry
_top = None  # the innermost open traced span's record


def waited(ns: int) -> None:
    """Count one explicit wait on the card of ``ns`` nanoseconds, in the
    open entry and the totals."""
    e = _open
    with _lock:
        _counters["host_waits"] += 1
        _counters["host_wait_ns"] += ns
        if e is not None:
            e.waits += 1
            e.wait_ns += ns


def counters() -> dict:
    """The counters' totals since the process started."""
    return dict(_counters)


class Entry:
    """One root span's record: ``kind``, ``id``, ``seq`` (its place among
    all entries of the process), ``images``, ``level`` (whether its spans
    are traced: a profiler recorded when it opened), ``traced`` (whether
    one recorded at its end), ``host`` (each span name's host ns and
    calls), its waits and their ns, and ``spans`` (its traced spans'
    records). ``host`` holds only strings and tuples of numbers, which the
    garbage collector stops tracking, so a full ring does not lengthen the
    collector's passes."""

    __slots__ = ("kind", "id", "seq", "images", "level", "traced", "host", "spans", "nspans",
                 "waits", "wait_ns", "dropped")

    def __init__(self, kind: str, id: int, images: int, level: bool):
        global _next_seq
        self.kind, self.id, self.images, self.level = kind, id, images, level
        # A module global, not a class attribute: storing into a class
        # invalidates the interpreter's attribute caches for the class.
        self.seq = _next_seq
        _next_seq += 1
        self.traced = self.dropped = False
        self.host: dict[str, tuple[int, int]] = {}
        self.spans: list[dict] = []
        self.nspans = 1  # the root is span 0
        self.waits = self.wait_ns = 0

    def drop(self) -> None:
        """Keep this entry out of the ring (a step that took no batch)."""
        self.dropped = True

    def add(self, name: str, ns: int) -> None:
        """Add one call of ``ns`` nanoseconds under ``name``."""
        t = self.host.get(name)
        self.host[name] = (ns, 1) if t is None else (t[0] + ns, t[1] + 1)

    def as_dict(self) -> dict:
        """The entry as plain data, the traced spans' device ms resolved."""
        spans = []
        for s in self.spans:
            ev = s.pop("events", None)
            if ev is not None:
                s["device_ms"] = ev[0].elapsed_time(ev[1])
            spans.append(dict(s))
        return {"kind": self.kind, "id": self.id, "seq": self.seq, "images": self.images,
                "traced": self.traced, "host_ns": {k: v[0] for k, v in self.host.items()},
                "calls": {k: v[1] for k, v in self.host.items()},
                "counters": {"host_waits": self.waits, "host_wait_ns": self.wait_ns},
                "spans": spans}


def _annotate(rec: dict, stage: bool):
    """The traced level's work at a span's start: the profiler's range
    (returned, entered), the start's stamp and a stage's start event."""
    # The first annotation of a process resolves the profiler's operator
    # (a few hundred µs); it must not fall between the stamp and the
    # annotation's start.
    torch.ops.profiler._record_function_enter_new  # noqa: B018
    fn = torch.profiler.record_function(rec["name"])
    rec["start_ns"] = time.time_ns()
    fn.__enter__()
    if stage and torch.cuda.is_initialized():
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        rec["events"] = (start, torch.cuda.Event(enable_timing=True))
    return fn


def _close(rec: dict, fn) -> None:
    ev = rec.get("events")
    if ev is not None:
        ev[1].record()
    fn.__exit__(None, None, None)


class span:
    """``with span(name, stage=False):`` times the block into the open
    entry (see the module's docstring); ``ns`` is its duration after it
    closes. Its level is fixed when it is made."""

    __slots__ = ("name", "stage", "t0", "ns")

    def __new__(cls, name: str, stage: bool = False):
        e = _open
        self = object.__new__(_Traced if (_profiling() if e is None else e.level) else span)
        self.name = name
        self.stage = stage
        return self

    def __enter__(self):
        self.t0 = _clock()
        return self

    def __exit__(self, typ, value, tb) -> None:
        self.ns = ns = _clock() - self.t0
        e = _open
        if e is not None:  # Entry.add, inline: the always-on level's one path
            host, name = e.host, self.name
            t = host.get(name)
            host[name] = (ns, 1) if t is None else (t[0] + ns, t[1] + 1)


class _Traced(span):
    """A span at the traced level."""

    __slots__ = ("rec", "fn", "up")

    def __enter__(self):
        global _top
        e = _open
        rec = {"name": self.name}
        if e is not None:
            rec["id"] = e.nspans
            e.nspans += 1
            rec["parent"] = 0 if _top is None else _top.get("id", 0)
        self.rec, self.up, _top = rec, _top, rec
        self.fn = _annotate(rec, self.stage)
        self.t0 = _clock()
        return self

    def __exit__(self, typ, value, tb) -> None:
        global _top
        self.ns = ns = _clock() - self.t0
        _close(self.rec, self.fn)
        _top = self.up
        e = _open
        if e is not None:
            e.spans.append(self.rec)
            e.add(self.name, ns)


class root:
    """``with root(name, kind, id, images=0) as entry:`` opens an entry
    (:class:`Entry`, yielded) and times the block as its span 0; the entry
    goes to the ring when the block ends, unless ``entry.drop()`` was
    called. A root inside an open entry is a plain span of it."""

    __slots__ = ("name", "kind", "id", "images", "inner", "rec", "fn", "up", "t0")

    def __init__(self, name: str, kind: str, id: int, images: int = 0):
        self.name, self.kind, self.id, self.images = name, kind, id, images

    def __enter__(self) -> Entry:
        global _open, _top
        if _open is not None:
            self.inner = span(self.name).__enter__()
            return _open
        self.inner = None
        e = _open = Entry(self.kind, self.id, self.images, _profiling())
        if e.level:
            self.rec = rec = {"name": self.name, "id": 0, "parent": None}
            self.up, _top = _top, rec
            self.fn = _annotate(rec, False)
        self.t0 = _clock()
        return e

    def __exit__(self, typ, value, tb) -> None:
        global _open, _top
        if self.inner is not None:
            self.inner.__exit__(typ, value, tb)
            return
        ns = _clock() - self.t0
        e = _open
        if e.level:
            _close(self.rec, self.fn)
            _top = self.up
            e.spans.append(self.rec)
        e.add(self.name, ns)
        _open = None
        if not e.dropped:
            e.traced = _profiling()
            _ring.append(e)


def entries() -> list[dict]:
    """The ring's entries, oldest first, as plain data
    (:meth:`Entry.as_dict`); a traced stage span's ``device_ms`` is read
    from its events, which the card must have run."""
    return [e.as_dict() for e in list(_ring)]


def next_seq() -> int:
    """The ``seq`` that the next entry will take."""
    return _next_seq


def host_seconds(since: int, names) -> dict:
    """Seconds of host time under each of ``names``, summed over the ring's
    entries from ``since`` (:func:`next_seq`) on and the open entry."""
    chosen = [e for e in list(_ring) if e.seq >= since]
    if _open is not None:
        chosen.append(_open)
    return {n: sum(e.host[n][0] for e in chosen if n in e.host) / 1e9 for n in names}


def clear() -> None:
    """Empty the ring and zero the counters (the tests' fresh start)."""
    _ring.clear()
    with _lock:
        for k in _counters:
            _counters[k] = 0
