"""A small CPU run of each window kind gives a result line with the
contract's keys, and the readings of a sound run are small."""

import json
import math

import pytest

import harness
import run as run_mod
from conftest import small_ctx

BENCH_JSON = json.loads((harness.REPO / "BENCHMARK.json").read_text())
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CPU_DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


@pytest.mark.parametrize("cell", ["train-321-fold30", "train-513-b6x5", "eval-513-voc-crf"])
def test_small_cpu_run_prints_the_contract_keys(cell):
    ctx = small_ctx(cell)
    out = harness.load_module(f"drivers/{ctx.spec['driver']}.py").run(ctx)
    result, lines = run_mod.result_line(BENCH_JSON, cell, out, False, dict(CPU_DEVICE))
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert set(result) == set(KEYS) | {"checks"}
    line = json.loads(json.dumps(result))  # one JSON object, as printed
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(BENCH_JSON, cell, "end_to_end")}
    # The CPU has no device trace: the p95 of CUDA events is the card's.
    assert set(line["metrics"]) == want - {"train_step_ms_p95"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == set(ctx.limits)
    assert lines[-len(ctx.limits):] == [
        f"check {n}: {line['checks'][n]['value']!r} limit {line['checks'][n]['limit']!r}"
        for n in line["checks"]]
    for name, value, _ in out["checks"]:
        assert math.isfinite(value), name


def test_traced_result_reads_the_per_layer_metrics():
    """--trace 1's metrics come from the per-layer readers; on the CPU
    only those that need no device trace find something to read."""
    ctx = small_ctx("train-321-fold30")
    out = harness.load_module("drivers/train.py").run(ctx)
    result, _ = run_mod.result_line(BENCH_JSON, "train-321-fold30", out, True, dict(CPU_DEVICE))
    assert set(result["metrics"]) == {"step.mfu", "loop.launch_ms"}
    assert "breakdown" not in result


def test_feed_stops_at_its_limit_and_its_deadline():
    pool = [0, 1, 2]
    assert list(harness.Feed(pool, 1, limit=4)) == [1, 2, 0, 1]
    started = []
    feed = harness.Feed(pool, 0, seconds=0.0, on_first=lambda: started.append(1))
    assert list(feed) == [0] and started == [1]


def test_feed_runs_on_past_its_deadline_for_the_traced_span():
    """With ``extra``, the window's deadline is marked by ``on_deadline``
    (with the batches given so far) and ``extra`` batches follow before
    ``on_end``."""
    calls = []
    feed = harness.Feed([0, 1, 2], 0, seconds=0.0, extra=3,
                        on_deadline=lambda given: calls.append(("deadline", given)),
                        on_end=lambda: calls.append(("end",)))
    assert list(feed) == [0, 1, 2, 0]
    assert calls == [("deadline", 1), ("end",)]


def test_idle_share_reads_the_window_by_the_traced_steps_device_time():
    """The device's busy seconds a traced step over the window's seconds a
    step: 50 ms of device work in a 60-ms step is a sixth idle."""
    idle = harness.load_module("metrics/device.idle_share.train.py")
    records = {"kind": "train", "window_s": 6.0, "steps": 100, "trace_steps": 10,
               "trace": {"busy_s": 0.5, "window_s": 0.9}}
    assert idle.read(records) == pytest.approx(100.0 / 6)
    assert idle.read({**records, "trace": None}) is None


def test_p95_is_the_nearest_rank():
    assert harness.p95(list(range(1, 101))) == 95
    assert harness.p95([5.0]) == 5.0
    assert harness.p95(list(range(1, 21))) == 19


def test_leaf_gap_is_taken_against_the_larger_of_the_leaf_and_the_median():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-6}
    prog = {"a": 1.1, "b": 2.0, "c": 2e-6}
    gap, leaf = harness.leaf_gap(prog, ref)
    assert leaf == "a" and gap == pytest.approx(0.1)
    assert harness.leaf_gap(prog, ref, keep={"b"})[0] == 0.0
