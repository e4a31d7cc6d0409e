"""Every file of the benchmark loads, and BENCHMARK.json keeps to the
contract's names, units, sources and shapes."""

import json
import re

import pytest

import harness

BENCH_JSON = json.loads((harness.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH_JSON["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH_JSON) == {"command", "paths", "run_seconds", "configs", "workloads",
                               "end_to_end", "per_layer"}
    assert BENCH_JSON["paths"] == ["benchmark_torch_port"]
    assert BENCH_JSON["command"] == ["python3", "benchmark_torch_port/run.py"]
    assert 1 <= BENCH_JSON["run_seconds"] <= 51
    assert len(json.dumps(BENCH_JSON)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_and_agree(cell):
    entry = next(w for w in BENCH_JSON["workloads"] if w["name"] == cell)
    ctx = harness.Context(workload=cell, seed=1, seconds=1, trace=False, device=None)
    assert ctx.spec["name"] == cell
    assert (ctx.spec["config"], ctx.spec["traffic"], ctx.spec["chips"], ctx.spec["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert (harness.BENCH / "drivers" / f"{ctx.spec['driver']}.py").is_file()
    assert ctx.traffic["name"] == entry["traffic"]
    assert set(ctx.limits) and all(isinstance(v, (int, float)) for v in ctx.limits.values())
    assert entry["chips"] == 1 and len(entry["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_config_builds_as_its_file_states(cell):
    ctx = harness.Context(workload=cell, seed=1, seconds=1, trace=False, device=None)
    cfg = ctx.experiment_config()  # raises where the file and the run disagree
    assert cfg.model.width_multiplier == 1.0 and cfg.model.fc6_channels == 4096


@pytest.mark.parametrize("config", BENCH_JSON["configs"], ids=lambda c: c["name"])
def test_configs(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((harness.REPO / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == []
    assert config["source"].startswith("https://")
    assert any(w["config"] == config["name"] for w in BENCH_JSON["workloads"])


def test_names_units_and_sources():
    names = [m["name"] for m in BENCH_JSON["end_to_end"] + BENCH_JSON["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH_JSON["configs"]]
    names += [w["traffic"] for w in BENCH_JSON["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(CELLS)) == len(CELLS)
    for m in BENCH_JSON["end_to_end"] + BENCH_JSON["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH_JSON["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH_JSON["end_to_end"]} == {
        "train_images_per_s", "train_step_ms_p95", "eval_images_per_s", "setup_s"}


def test_every_per_layer_metric_has_a_reader_and_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH_JSON["end_to_end"]}
    layers = {}
    for m in BENCH_JSON["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        reader = harness.load_module(f"metrics/{m['name']}.py")
        assert reader.read({}) is None  # nothing to read: nothing reported
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = {m["name"] for m in harness.cell_metrics(BENCH_JSON, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH_JSON, cell, "per_layer")
