"""PyTorch port: the spans and counters of ``utils/tracing.py``. A CPU
``fit`` makes one entry a step with each span of the step, an evaluation
pass one entry with its stages; entries and spans carry their ids; the
ring keeps the newest; spans reach the profiler's trace on its clock only
while it records, at the level their entry opened with."""

import collections
import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from em_adapt_torch import config as pcfg  # noqa: E402
from em_adapt_torch.data.pipeline import SyntheticVOC, batch_iterator  # noqa: E402
from em_adapt_torch.eval.predict import Evaluator  # noqa: E402
from em_adapt_torch.models.deeplab import DeepLabLargeFOV  # noqa: E402
from em_adapt_torch.train import trainer as trainer_mod  # noqa: E402
from em_adapt_torch.train.trainer import STAGES, Trainer  # noqa: E402
from em_adapt_torch.utils import tracing  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

torch.set_num_threads(2)

MODEL = dict(num_classes=4, input_size=(33, 33), fc6_channels=8, width_multiplier=0.125,
             init_scheme="he")
FIT_SPANS = {"fit.step", "fit.next_batch", "fit.loss_check", *STAGES}
EVAL_SPANS = {"eval.pass", "eval.load", "eval.preprocess", "eval.forward", "eval.post",
              "crf.refine", "eval.to_host", "eval.confusion"}


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _fit(tmp_path, steps=2, log_every=500, log_fn=None):
    cfg = pcfg.ExperimentConfig(
        model=pcfg.ModelConfig(**MODEL),
        data=pcfg.DataConfig(input_size=(33, 33), num_workers=1, prefetch=0),
        estep=pcfg.EStepConfig(num_iter=2),
        optim=pcfg.OptimConfig(accum_steps=1, base_lr=0.01),
        train=pcfg.TrainConfig(batch_size=2, epochs=1, seed=0, log_every_steps=log_every),
        checkpoint=pcfg.CheckpointConfig(save_dir=str(tmp_path), save_every_steps=0,
                                         snapshot_on_lr_drop=False))
    trainer = Trainer(cfg, device="cpu", steps_per_epoch=4)
    state = trainer.init_state()
    data = batch_iterator(SyntheticVOC(8, 4), cfg.data, batch_size=2, seed=0)
    return trainer.fit(state, data, num_steps=steps, log_fn=log_fn)


class TinyVOC:
    """Five small images of different sizes, labels with a void band."""

    sizes = [(40, 50), (33, 44), (48, 37), (45, 45), (30, 52)]

    def __len__(self):
        return len(self.sizes)

    def load_raw(self, i):
        h, w = self.sizes[i]
        g = np.random.default_rng(77 + i)
        img = g.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        label = g.integers(0, 4, size=(h, w)).astype(np.uint8)
        label[: h // 8] = 255
        return img, label


def _evaluator():
    cfg = pcfg.ExperimentConfig(
        model=pcfg.ModelConfig(**MODEL),
        eval=pcfg.EvalConfig(crf_impl="tpu", crf_bucket=(48, 56), crf_buckets=(),
                             crf_iterations=1, use_crf=True, batch_size=2))
    torch.manual_seed(0)
    return Evaluator(cfg, DeepLabLargeFOV(cfg.model))


def test_fit_makes_one_entry_a_step_with_each_span(tmp_path, monkeypatch):
    """Two CPU steps: two train entries (ids the steps, two images each),
    every span of the step in each, the stages' host time within the
    step's launch ``seconds``, and one ``host_waits`` for each read of
    ``LateLossReader`` (the last, after the loop, outside any entry)."""
    reads = []
    read = trainer_mod.LateLossReader.read
    monkeypatch.setattr(trainer_mod.LateLossReader, "read",
                        lambda self, slot: reads.append(slot) or read(self, slot))
    records = _fit(tmp_path)
    got = tracing.entries()
    assert [(e["kind"], e["id"], e["images"], e["traced"]) for e in got] == [
        ("train", 0, 2, False), ("train", 1, 2, False)]
    for e, r in zip(got, records):
        assert set(e["host_ns"]) == FIT_SPANS
        assert all(e["calls"][s] == 1 for s in STAGES)
        stages = sum(e["host_ns"][s] for s in STAGES)
        assert 0 < stages <= r["seconds"] * 1e9
        assert e["host_ns"]["fit.step"] >= stages
        assert e["spans"] == []  # untraced: no span records
    assert [e["counters"]["host_waits"] for e in got] == [0, 1]
    assert tracing.counters()["host_waits"] == len(reads) == 2
    assert got[1]["counters"]["host_wait_ns"] > 0


def test_record_wait_seconds_is_the_pull_span(tmp_path):
    """A step record's ``wait_seconds`` is its entry's ``fit.next_batch``
    time: one clock for both."""
    records = _fit(tmp_path, steps=3)
    got = tracing.entries()
    assert len(got) == len(records) == 3
    for e, r in zip(got, records):
        assert e["calls"]["fit.next_batch"] == 1
        assert r["wait_seconds"] == e["host_ns"]["fit.next_batch"] / 1e9 > 0


def test_fit_log_window_carries_host_waits_and_stage_seconds(tmp_path):
    """The log record gains ``host_waits``, ``host_wait_seconds`` and
    ``stage_seconds`` (each stage's host seconds over the window's steps);
    the keys it had stay."""
    logs = []
    _fit(tmp_path, steps=3, log_every=1, log_fn=logs.append)
    assert len(logs) == 3
    for rec in logs:
        assert {"window_seconds", "window_steps", "wait_seconds", "estep_launches",
                "block1_fwd_launches", "block1_bwd_launches"} <= set(rec)
        assert set(rec["stage_seconds"]) == set(STAGES)
        assert 0 < sum(rec["stage_seconds"].values()) <= rec["window_seconds"]
        assert rec["host_wait_seconds"] > 0
    # Each window's check reads its one step's loss (the log's own read of
    # the norms falls between the count and the next window's start).
    assert [rec["host_waits"] for rec in logs] == [1, 1, 1]
    # Each window is its own step: its stage seconds are that entry's.
    entries = tracing.entries()
    for rec, e in zip(logs, entries):
        assert rec["stage_seconds"] == pytest.approx(
            {s: e["host_ns"][s] / 1e9 for s in STAGES})


def test_full_sync_is_a_span_and_a_wait_of_the_same_ns(monkeypatch):
    """On a card ``full_sync`` is the span ``fit.sync`` and one wait whose
    ns are the span's (the synchronize stubbed: no card here); on the CPU
    it is neither."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    with tracing.root("fit.step", "train", 0):
        trainer_mod.full_sync(torch.device("cpu"))
        trainer_mod.full_sync(torch.device("cuda", 0))
    (e,) = tracing.entries()
    assert e["calls"]["fit.sync"] == 1 == e["counters"]["host_waits"]
    assert e["counters"]["host_wait_ns"] == e["host_ns"]["fit.sync"]


def test_eval_pass_is_an_entry_with_its_stages():
    """``_confusion_voc_device`` on the CPU: one eval entry a pass, id the
    pass, its images counted, each span of the pass, ``crf.refine`` once a
    bucket batch; the labels' copy to the host is no wait on the CPU."""
    ev = _evaluator()
    ds = TinyVOC()
    ev.confusion_voc(ds)
    ev._confusion_voc_device(ds, 2)
    got = tracing.entries()
    assert [(e["kind"], e["id"], e["images"]) for e in got] == [("eval", 0, 5), ("eval", 1, 5)]
    for e in got:
        assert set(e["host_ns"]) == EVAL_SPANS
        assert e["calls"]["eval.load"] == e["calls"]["eval.preprocess"] == 5
        assert e["calls"]["eval.forward"] == e["calls"]["crf.refine"] == 3
        assert e["host_ns"]["eval.post"] >= e["host_ns"]["crf.refine"]
        assert e["counters"]["host_waits"] == 0


def test_spans_carry_their_entry_and_parent_ids():
    """Traced records: the root is span 0 with no parent; each span names
    its parent's id; entries count up their ``seq``."""
    with cpu_profile():
        with tracing.root("r", "train", 7, images=3) as entry:
            with tracing.span("a"):
                with tracing.span("b"):
                    pass
            with tracing.span("c"):
                pass
        with tracing.root("r", "train", 8):
            pass
    first, second = tracing.entries()
    assert (first["id"], first["images"], second["id"]) == (7, 3, 8)
    assert first["traced"] and second["traced"]
    assert second["seq"] == first["seq"] + 1 == entry.seq + 1
    by_name = {s["name"]: s for s in first["spans"]}
    assert (by_name["r"]["id"], by_name["r"]["parent"]) == (0, None)
    assert by_name["a"]["parent"] == 0 and by_name["c"]["parent"] == 0
    assert by_name["b"]["parent"] == by_name["a"]["id"]
    assert len({s["id"] for s in first["spans"]}) == 4
    assert first["calls"] == {"r": 1, "a": 1, "b": 1, "c": 1}


def test_a_root_inside_an_entry_is_one_of_its_spans_and_a_drop_keeps_none():
    with tracing.root("fit.step", "train", 0):
        with tracing.span("fit.eval"):
            with tracing.root("eval.pass", "eval", 0) as inner:
                with tracing.span("eval.load"):
                    pass
    with tracing.root("fit.step", "train", 1) as dropped:
        dropped.drop()
    (only,) = tracing.entries()
    assert inner.kind == "train" and only["kind"] == "train"
    assert set(only["host_ns"]) == {"fit.step", "fit.eval", "eval.pass", "eval.load"}
    assert tracing._open is None  # the inner root left the entry open, then the outer closed it


def test_ring_keeps_the_newest_entries_oldest_first():
    for i in range(tracing.RING + 5):
        with tracing.root("fit.step", "train", i):
            pass
    got = tracing.entries()
    assert len(got) == tracing.RING
    assert (got[0]["id"], got[-1]["id"]) == (5, tracing.RING + 4)
    assert [e["seq"] for e in got] == sorted(e["seq"] for e in got)
    assert tracing.next_seq() == got[-1]["seq"] + 1


def test_a_profiler_started_inside_an_entry_traces_the_entries_after_it():
    """An entry takes the level the profiler had when its root opened:
    one opened before the profiler starts keeps its spans untraced and is
    ``traced`` (a profiler recorded at its end); the next is traced with
    its records; one opened after the profiler stops is neither."""
    prof = cpu_profile()
    with tracing.root("r", "train", 0):
        with tracing.span("early", stage=True):
            prof.start()
        with tracing.span("late", stage=True):
            pass
    with tracing.root("r", "train", 1):
        with tracing.span("s", stage=True):
            pass
    prof.stop()
    with tracing.root("r", "train", 2):
        with tracing.span("s", stage=True):
            pass
    switched, on, off = tracing.entries()
    assert switched["traced"] and switched["spans"] == []
    assert set(switched["calls"]) == {"r", "early", "late"}
    assert on["traced"] and {s["name"] for s in on["spans"]} == {"r", "s"}
    # No CUDA here: a stage span records no events and reads no device time.
    assert all("device_ms" not in s for s in on["spans"])
    assert not off["traced"] and off["spans"] == []


def test_a_span_outside_an_entry_is_traced_alone():
    """A span with no open entry (the mesh's exchanges outside ``fit``)
    adds to no entry; it enters the profiler's range only while one
    records."""
    with tracing.span("space_exchange") as plain:
        pass
    with cpu_profile() as prof:
        with tracing.span("space_exchange") as traced:
            pass
    assert type(plain) is tracing.span and type(traced) is not tracing.span
    assert plain.ns >= 0 and traced.ns >= 0
    assert tracing.entries() == []
    names = {e.name for e in prof.events()}
    assert "space_exchange" in names


def test_profiler_shows_each_span_on_the_trace_clock(tmp_path):
    """Under ``torch.profiler`` (CPU activity) each span is a
    ``user_annotation`` event, and its ``time.time_ns()`` start lies within
    100 µs of the event's ``ts + baseTimeNanoseconds / 1000``. A first
    annotation outside the entry opens the session's annotations: the
    first of a profiling session starts up to about 0.1 ms after its
    stamp."""
    with cpu_profile() as prof:
        torch.ones(64).sum()
        with tracing.span("warm"):
            pass
        with tracing.root("fit.step", "train", 0):
            for name in ("fit.next_batch", "step.forward", "step.backward"):
                with tracing.span(name, stage=True):
                    torch.ones(64).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = int(doc.get("baseTimeNanoseconds", 0)) / 1000
    events = {e["name"]: e for e in doc["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"}
    (entry,) = tracing.entries()
    assert [r["name"] for r in entry["spans"]] == [
        "fit.next_batch", "step.forward", "step.backward", "fit.step"]
    for rec in entry["spans"]:
        assert rec["name"] in events
        ts = float(events[rec["name"]]["ts"]) + base_us
        assert abs(rec["start_ns"] / 1000 - ts) < 100, rec["name"]


def test_no_profiler_call_without_a_profiler(tmp_path, monkeypatch):
    """With no profiler recording, a CPU ``fit`` and an evaluation pass
    enter no ``record_function``; under a profiler every span enters
    one."""
    calls = collections.Counter()
    real = torch.profiler.record_function

    def counted(name, *a, **kw):
        calls[name] += 1
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    _fit(tmp_path)
    _evaluator().confusion_voc(TinyVOC())
    assert not calls
    with cpu_profile():
        with tracing.root("fit.step", "train", 0):
            with tracing.span("step.forward", stage=True):
                pass
    assert calls == {"fit.step": 1, "step.forward": 1}


def test_waits_add_up_across_threads():
    """Eight threads count waits with a short switch interval: no
    increment is lost."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                tracing.waited(3)

        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert tracing.counters() == {"host_waits": 8 * 2000, "host_wait_ns": 8 * 2000 * 3}
