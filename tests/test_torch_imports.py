"""The PyTorch port stands alone: no module of em_adapt_torch (nor
chip_smoke.py) imports JAX or anything of em_adapt_tpu, or needs Pillow or
scipy to be imported, and chip_smoke.py refuses to run, printing no
result, without a card or without the port."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import em_adapt_torch
names = ["em_adapt_torch"] + [
    m.name for m in pkgutil.walk_packages(em_adapt_torch.__path__, "em_adapt_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None and m.startswith(("em_adapt_tpu", "jax", "optax"))
)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15  # every module was imported


def test_port_imports_without_pillow_or_scipy():
    """Pillow and scipy are imported only where files are read or written:
    every module of the port, and chip_smoke.py, import without them."""
    probe = 'import sys; sys.modules["PIL"] = sys.modules["scipy"] = None\n' + _PROBE
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 16


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )


def test_chip_smoke_refuses_without_a_card():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run for real")
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_refuses_without_the_port(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
