"""The per-layer metrics that read the port's own spans and counters
(``spans.py`` and its readers): on a synthetic ring each returns the
window's or the traced span's mean, and None where the ring does not hold
what it reads or the checkout has no recorder."""

import sys

import pytest

import harness
import spans

STAGES = ("forward", "estep", "backward", "optim")
HOST_TRAIN = {f"step.{s}_host_ms": f"step.{s}" for s in STAGES}
DEVICE_TRAIN = {f"step.{s}_device_ms": f"step.{s}" for s in STAGES}


def entry(kind, traced, images, host=None, counters=None, device=()):
    return {"kind": kind, "id": 0, "seq": 0, "images": images, "traced": traced,
            "host_ns": dict(host or {}), "calls": {}, "counters": dict(counters or {}),
            "spans": [{"name": n, "id": i + 1, "parent": 0, "start_ns": 0, "device_ms": ms}
                      for i, (n, ms) in enumerate(device)]}


def train_ring():
    """Two warm-up steps, a window of four, the profiler's settling step
    and a traced span of two."""
    warm = [entry("train", False, 6, {f"step.{s}": 99e6 for s in STAGES},
                  {"host_wait_ns": 99e6}) for _ in range(2)]
    window = [entry("train", False, 6, {f"step.{s}": ms * 1e6 for s in STAGES},
                    {"host_wait_ns": 2 * ms * 1e6}) for ms in (1, 2, 3, 4)]
    settle = [entry("train", True, 6, device=[(f"step.{s}", 50.0) for s in STAGES])]
    traced = [entry("train", True, 6, device=[(f"step.{s}", ms) for s in STAGES])
              for ms in (10.0, 20.0)]
    return warm + window + settle + traced


def eval_ring():
    """A warm-up pass, a window of two passes of 24 images and the traced
    pass, whose CRF ran in two chunks."""
    host = {"eval.load": 24e6, "eval.preprocess": 48e6, "eval.forward": 12e6}
    return ([entry("eval", False, 24, {k: 1e9 for k in host})]
            + [entry("eval", False, 24, host) for _ in range(2)]
            + [entry("eval", True, 24, device=[("crf.refine", 30.0), ("crf.refine", 18.0)])])


TRAIN = {"kind": "train", "steps": 4, "trace_steps": 2}
EVAL = {"kind": "eval", "images": 48}
WANT = {**{m: 2.5 for m in HOST_TRAIN}, "loop.host_wait_ms": 5.0,
        **{m: 15.0 for m in DEVICE_TRAIN}, "eval.preprocess_host_ms_per_image": 3.0,
        "eval.forward_host_ms_per_image": 0.5, "crf.refine_device_ms_per_image": 2.0}


def reader(name):
    return harness.load_module(f"metrics/{name}.py")


def records_and_ring(name):
    return (TRAIN, train_ring()) if name.startswith(("step.", "loop.")) else (EVAL, eval_ring())


@pytest.mark.parametrize("name", list(WANT))
def test_reader_gives_the_mean_of_its_window_or_span(name, monkeypatch):
    records, ring = records_and_ring(name)
    monkeypatch.setattr(spans, "ring", lambda: ring)
    assert reader(name).read(records) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", list(WANT))
def test_reader_finds_nothing_where_the_ring_lacks_it(name, monkeypatch):
    """No traced entry, a ring that dropped the window's first entries, a
    record of another kind, and a checkout without the recorder."""
    records, ring = records_and_ring(name)
    untraced = [e for e in ring if not e["traced"]]
    monkeypatch.setattr(spans, "ring", lambda: untraced)
    assert reader(name).read(records) is None
    if name in HOST_TRAIN or name == "loop.host_wait_ms" or "host_ms_per_image" in name:
        wrapped = ring[-4:] if records is TRAIN else ring[-2:]
        monkeypatch.setattr(spans, "ring", lambda: wrapped)
        assert reader(name).read(records) is None
    monkeypatch.setattr(spans, "ring", lambda: ring)
    assert reader(name).read({**records, "kind": "other"}) is None
    assert reader(name).read({}) is None
    monkeypatch.undo()
    # A checkout without the recorder: its import fails.
    import em_adapt_torch.utils

    monkeypatch.delattr(em_adapt_torch.utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "em_adapt_torch.utils.tracing", None)
    assert spans.ring() is None
    assert reader(name).read(records) is None


def test_eval_window_must_sum_to_the_window_images(monkeypatch):
    monkeypatch.setattr(spans, "ring", eval_ring)
    assert len(spans.eval_window(EVAL)) == 2
    assert spans.eval_window({**EVAL, "images": 30}) is None
    assert spans.eval_window({**EVAL, "images": 96}) is None  # more than the ring holds


def test_readers_read_the_recorder_itself():
    """The recorder's own entries: a window of untraced steps, then steps
    traced under a CPU profiler (without device times)."""
    from torch.profiler import ProfilerActivity, profile

    from em_adapt_torch.utils import tracing

    tracing.clear()
    for step, ms in enumerate((1, 2, 3, 4)):
        with tracing.root("fit.step", "train", step, images=6) as e:
            with tracing.span("step.forward", stage=True):
                pass
            e.host["step.forward"] = (ms * 1e6, 1)
    with profile(activities=[ProfilerActivity.CPU]):
        for step in range(4, 7):
            with tracing.root("fit.step", "train", step, images=6):
                with tracing.span("step.forward", stage=True):
                    pass
    records = {"kind": "train", "steps": 3, "trace_steps": 2}
    assert reader("step.forward_host_ms").read(records) == pytest.approx(3.0)
    assert len(spans.train_traced(records)) == 2
    assert reader("step.forward_device_ms").read(records) is None  # no CUDA events here
    tracing.clear()
