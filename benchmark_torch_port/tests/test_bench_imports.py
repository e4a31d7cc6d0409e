"""Nothing a run loads has jax, jaxlib, flax, em_adapt_tpu, chip_smoke or
bench as its top-level name, and the run refuses to report if it did."""

import re
import subprocess
import sys
import textwrap

import pytest

import harness

RUN_SMALL = textwrap.dedent("""
    import sys
    sys.path[:0] = [{bench!r}, {repo!r}, {tests!r}]
    import harness
    harness.set_cache_dirs()
    import torch
    torch.set_num_threads(2)
    from conftest import small_ctx
    ctx = small_ctx({cell!r})
    harness.load_module("drivers/" + ctx.spec["driver"] + ".py").run(ctx)
    import run
    print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}))
    print("FORBIDDEN", harness.forbidden_modules())
""")


@pytest.mark.parametrize("cell", ["train-321-b6x5", "eval-513-voc-crf"])
def test_a_run_loads_no_forbidden_module(cell):
    code = RUN_SMALL.format(bench=str(harness.BENCH), repo=str(harness.REPO),
                            tests=str(harness.BENCH / "tests"), cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(harness.BENCH))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("LOADED", "FORBIDDEN")))
    assert lines["FORBIDDEN"] == "[]"
    assert "em_adapt_torch" in lines["LOADED"]


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "em_adapt_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_no_source_of_the_benchmark_imports_them():
    names = "|".join(harness.FORBIDDEN)
    pattern = re.compile(rf"^\s*(import|from)\s+({names})(\s|\.|$)", re.M)
    for path in harness.BENCH.rglob("*.py"):
        if path.parent.name != "tests":
            assert not pattern.search(path.read_text()), path
