"""The cells ``train-r101-321-fold30`` and ``eval-321-fixed`` at a CPU's
size: their windows give a result line with the contract's keys and
small readings; the ResNet reference, weights and work against the
port and the published table."""

import json
import math

import pytest
import torch

import harness
import run as run_mod
import weights_r101
import work_r101
from reference import deeplab_v2 as ref

BENCH_JSON = json.loads((harness.REPO / "BENCHMARK.json").read_text())
CPU_DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
#: DeepLab-v2 ResNet-101 at a CPU's size: every block, width 1/32 (whose
#: 8-channel convs take a smaller step than the published widths'), in
#: float32, in which the program is the reference up to rounding.
SMALL_R101 = ("model.width_multiplier=0.03125", "model.input_size=(33,33)",
              "train.batch_size=2", "data.train_label_size=(5,5)", "optim.base_lr=1e-4",
              "model.compute_dtype=float32")
SMALL_FIXED = ("model.width_multiplier=0.125", "model.fc6_channels=32",
               "model.input_size=(33,33)", "eval.batch_size=2", "model.compute_dtype=float32",
               "model.block1_impl=xla")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: oneDNN's threads cost more than they save on
    8-channel convolutions."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ctx(cell: str, extra: tuple, **traffic):
    ctx = harness.Context(workload=cell, seed=2 ** 31 + 29, seconds=0.3, trace=False,
                          device=torch.device("cpu"))
    ctx.extra_overrides = extra
    ctx.traffic.update(traffic)
    return ctx


@pytest.mark.parametrize("cell,extra,traffic", [
    ("train-r101-321-fold30", SMALL_R101, {"pool_batches": 4, "warmup_steps": 3}),
    ("eval-321-fixed", SMALL_FIXED, {"pool_batches": 3, "pass_batches": 7, "compare_batches": 2}),
])
def test_small_cpu_run_prints_the_contract_keys(cell, extra, traffic):
    ctx = _ctx(cell, extra, **traffic)
    out = harness.load_module(f"drivers/{ctx.spec['driver']}.py").run(ctx)
    result, lines = run_mod.result_line(BENCH_JSON, cell, out, False, dict(CPU_DEVICE))
    line = json.loads(json.dumps(result))
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(BENCH_JSON, cell, "end_to_end")}
    assert set(line["metrics"]) == want - {"train_step_ms_p95"}
    assert set(line["checks"]) == set(ctx.limits)
    for name, value, _ in out["checks"]:
        assert math.isfinite(value), name
    readings = out["readings"]
    assert readings["logits_gap"] < 1e-4
    if cell.startswith("train"):
        # A weak label at an E-step threshold may flip between two float32
        # computations of the same logits: on a 5x5 score map one pixel moves
        # the loss by about 1e-3 and the gradients by percent, so only the
        # loss is held here (tests/test_torch_resnet.py holds the gradients
        # on the program's own labels).
        assert readings["loss_gap"] < 1e-2
        assert out["records"]["model"] == "deeplab_v2_resnet101"
    else:
        assert readings["confusion_gap"] == 0 and readings["label_gap"] == 0
        assert readings["label_considered_share"] > 0.5


def test_reference_matches_the_port_and_counts_the_published_parameters():
    from em_adapt_torch.config import ModelConfig
    from em_adapt_torch.models.registry import get_model

    assert sum(k * k * cin * cout + (cout if bias else 0)
               for _, k, cin, cout, _, _, bias in ref.layers()) == 43_943_188
    cfg = ModelConfig(name="deeplab_v2_resnet101", width_multiplier=1 / 32)
    params = weights_r101.make("reference", 5, torch.device("cpu"), width=1 / 32)
    image = torch.randint(0, 256, (2, 41, 41, 3), generator=torch.Generator().manual_seed(1),
                          dtype=torch.uint8)
    weights_r101.calibrate(params, image)
    model = get_model(cfg.name)(cfg).load_params(weights_r101.hwio(params))
    with torch.no_grad():
        ours = ref.forward(params, params.frozen, image)
        port = model(image)
    assert ours.shape == (2, 6, 6, 21)
    assert float((port - ours).norm() / ours.norm()) < 1e-5


def test_work_counts_the_layer_table():
    assert work_r101.train_flops(321, 321, 30) == 13_509_813_680_640
    assert work_r101.forward_flops(321, 321, 1) == 150_271_617_408
    assert work_r101.layer_resolutions(513, 513)[-1][4:] == (65, 65)
    res = {name: (oh, ow) for name, _, _, _, oh, ow in work_r101.layer_resolutions(321, 321)}
    assert res["conv1"] == (161, 161) and res["res2c_branch2c"] == (81, 81)
    assert res["res3a_branch2a"] == res["res5c_branch2c"] == res["fc1_voc12_c3"] == (41, 41)
    n = work_r101.norm_elements(321, 321, 1)
    assert n["conv"] == 96_964_032 and n["adds"] < n["act"] < n["conv"]


def test_resnet_metrics_read_only_the_resnet_cell():
    reader = harness.load_module("metrics/resnet.norm_roofline.py")
    trace = {"kernels": {"void at::native::vectorized_elementwise_kernel<4>": (0.2, 100),
                         "sm90_xmma_fprop_implicit_gemm": (0.5, 10)},
             "busy_s": 0.7, "window_s": 0.7, "idle_by_host": {}}
    r = {"kind": "train", "model": "deeplab_v2_resnet101", "trace": trace, "trace_steps": 10,
         "input_size": (321, 321), "batch": 30, "num_classes": 21}
    bound = work_r101.norm(321, 321, 30)["bound_s"]
    assert reader.read(r) == pytest.approx(100 * bound / 0.02)
    assert harness.load_module("metrics/resnet.norm_device_ms.py").read(r) == pytest.approx(20.0)
    assert reader.read({**r, "model": None}) is None


def _trace_events():
    """A traced span of two steps: res4's range launches two kernels a
    step, a kernel of another stage runs between, the card idles inside
    the range."""
    x = lambda name, cat, ts, dur, **args: {"ph": "X", "name": name, "cat": cat, "ts": ts,
                                            "dur": dur, "args": args}
    out = [x("bench.window", "user_annotation", 100, 900)]
    for step in (0, 400):
        out += [x("resnet.res4", "user_annotation", 150 + step, 100),
                x("cudaLaunchKernel", "cuda_runtime", 160 + step, 5, correlation=step + 1),
                x("cuLaunchKernelEx", "cuda_driver", 200 + step, 5, correlation=step + 2),
                x("cudaLaunchKernel", "cuda_runtime", 300 + step, 5, correlation=step + 3),
                x("gemm", "kernel", 170 + step, 20, correlation=step + 1),
                x("elementwise_kernel", "kernel", 260 + step, 10, correlation=step + 2),
                x("other", "kernel", 310 + step, 50, correlation=step + 3)]
    return out + [x("resnet.res4", "user_annotation", 2000, 100)]  # after the span


def test_trace_ranges_read_a_ranges_own_kernels_and_the_spans_edges():
    import trace_ranges

    class Profile:  # a profiler saves its trace once
        saved = False

        def export_chrome_trace(self, path):
            assert not self.saved, "Trace is already saved."
            self.saved = True
            with open(path, "w") as f:
                json.dump({"traceEvents": _trace_events()}, f)

    with trace_ranges.Saved(Profile()) as saved:
        read = harness.read_trace(saved, "bench.window")
        events = saved.events
    assert read["busy_s"] == pytest.approx(160 / 1e6) and read["window_s"] == pytest.approx(9e-4)
    assert trace_ranges.range_device_s(events, "resnet.res4", "bench.window") == (
        pytest.approx(2 * 30 / 1e6))
    assert trace_ranges.range_device_s(events, "resnet.res5", "bench.window") is None
    assert trace_ranges.range_device_s(events, "resnet.res4", "bench.other") is None
    head, tail = trace_ranges.edge_idle_s(events, "bench.window")
    assert head == pytest.approx(70 / 1e6) and tail == pytest.approx(240 / 1e6)
    reader = harness.load_module("metrics/resnet.res4_forward_device_ms.py")
    r = {"kind": "train", "trace_steps": 2,
         "trace": {"range_device_s": {"resnet.res4": 60 / 1e6}}}
    assert reader.read(r) == pytest.approx(0.03)
    assert reader.read({**r, "trace": {"range_device_s": {"resnet.res4": None}}}) is None
    assert reader.read({**r, "trace": None}) is None


def test_a_run_whose_training_goes_non_finite_reads_as_not_correct(monkeypatch):
    driver = harness.load_module("drivers/train_r101.py")

    def unhealthy(ctx):
        raise RuntimeError("training unhealthy at step 9: non-finite loss: nan")

    monkeypatch.setattr(driver.base, "run", unhealthy)
    ctx = _ctx("train-r101-321-fold30", SMALL_R101)
    out = driver.run(ctx)
    result, lines = run_mod.result_line(BENCH_JSON, "train-r101-321-fold30", out, False,
                                        dict(CPU_DEVICE))
    assert result["correct"] is False and result["failed"] == 1
    assert set(result["checks"]) == set(ctx.limits)
    assert "non-finite" in out["readings"]["diverged"]

    def broken(ctx):
        raise RuntimeError("another fault")

    monkeypatch.setattr(driver.base, "run", broken)
    with pytest.raises(RuntimeError, match="another fault"):
        driver.run(ctx)
