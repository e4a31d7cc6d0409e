"""``crf.filter_device_ms_per_image``: K4's kernels in the traced pass's
reduced trace over the traced pass's images, and None where the pass ran
none of them (a checkout without K4), where nothing was traced, or in a
record of another kind."""

import pytest

import harness
import spans


def reader():
    return harness.load_module("metrics/crf.filter_device_ms_per_image.py")


def traced_pass(images):
    return [{"kind": "eval", "id": 0, "seq": 0, "images": images, "traced": True,
             "host_ns": {}, "calls": {}, "counters": {}, "spans": []}]


TRACE = {"window_s": 3.0, "busy_s": 1.0, "idle_by_host": {}, "kernels": {
    "void (anonymous namespace)::crf_filter_walk<float4>(float const*, float*)": (0.30, 50),
    "(anonymous namespace)::crf_filter_slab(float const*, float*)": (0.06, 22),
    "void at::native::elementwise_kernel<128, 2>(int)": (0.50, 400)}}


def test_reads_k4_time_over_the_traced_images(monkeypatch):
    monkeypatch.setattr(spans, "ring", lambda: traced_pass(24))
    assert reader().read({"kind": "eval", "trace": TRACE}) == pytest.approx(1e3 * 0.36 / 24)


def test_finds_nothing_without_k4_or_a_trace(monkeypatch):
    monkeypatch.setattr(spans, "ring", lambda: traced_pass(24))
    parent = {**TRACE, "kernels": {k: v for k, v in TRACE["kernels"].items()
                                   if "crf_filter" not in k}}
    assert reader().read({"kind": "eval", "trace": parent}) is None
    assert reader().read({"kind": "eval", "trace": None}) is None
    assert reader().read({"kind": "train", "trace": TRACE}) is None
    monkeypatch.setattr(spans, "ring", lambda: None)
    assert reader().read({"kind": "eval", "trace": TRACE}) is None
