"""PyTorch port: the host dense CRF (``em_adapt_torch/eval/crf.py``) and
its native lattice binding (``eval/permutohedral.py``) against the JAX
package's on shared numpy inputs."""

import ctypes
import threading

import numpy as np
import pytest

from em_adapt_torch.config import EvalConfig
from em_adapt_torch.eval import crf as pcrf
from em_adapt_torch.eval import permutohedral as plat
from em_adapt_torch.utils import build
from em_adapt_tpu.config import EvalConfig as JaxEvalConfig
from em_adapt_tpu.eval import crf as jcrf
from tests.test_crf import _two_region_case


@pytest.mark.parametrize("method,h,w", [("grid", 40, 52), ("exact", 20, 24),
                                        ("permutohedral", 40, 52)])
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_crf_matches_jax(method, h, w, seed):
    """Every host method against the JAX package's dense_crf, two
    iterations, to 1e-6 (the same numpy/scipy arithmetic and the same
    native source)."""
    probs, rgb = _two_region_case(seed=seed, h=h, w=w, c=4)
    got = pcrf.dense_crf(probs, rgb, EvalConfig(), method=method, num_iterations=2)
    want = jcrf.dense_crf(probs, rgb, JaxEvalConfig(), method=method, num_iterations=2)
    assert got.shape == (h, w, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_auto_runs_the_lattice_and_closes_it(monkeypatch):
    """"auto" picks the lattice where it builds: one lattice per call,
    reused by every iteration and closed after it, also when an iteration
    raises."""
    probs, rgb = _two_region_case(seed=2)
    before = plat.lattices_built
    auto = pcrf.dense_crf(probs, rgb, num_iterations=3)
    assert plat.lattices_built == before + 1
    np.testing.assert_array_equal(
        auto, pcrf.dense_crf(probs, rgb, num_iterations=3, method="permutohedral"))
    closed = []
    real_close = plat.PermutohedralLattice.close
    monkeypatch.setattr(plat.PermutohedralLattice, "close",
                        lambda self: (closed.append(1), real_close(self)))
    monkeypatch.setattr(pcrf, "_gaussian_filter_xy",
                        lambda *a: (_ for _ in ()).throw(RuntimeError("boom")))
    with pytest.raises(RuntimeError, match="boom"):
        pcrf.dense_crf(probs, rgb, method="permutohedral")
    assert closed


def test_unknown_method_is_refused():
    probs, rgb = _two_region_case()
    with pytest.raises(ValueError, match="method='lattice'"):
        pcrf.dense_crf(probs, rgb, method="lattice")


def test_filter_constant_field_is_identity():
    """The lattice keeps a constant field (tests/test_permutohedral_native.py)."""
    feats = np.random.default_rng(0).normal(size=(200, 5)).astype(np.float32)
    out = plat.permutohedral_filter(np.full((200, 3), 7.5, np.float32), feats)
    np.testing.assert_allclose(out, 7.5, rtol=1e-5)


def test_rejects_mismatched_sizes():
    lat = plat.PermutohedralLattice(np.zeros((10, 3), np.float32))
    try:
        with pytest.raises(ValueError, match="lattice N"):
            lat.filter(np.zeros((9, 2), np.float32))
    finally:
        lat.close()


def test_init_rejects_bad_dims():
    lib = plat._load()
    feats = np.zeros((4, 3), np.float32)
    ptr = feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    assert lib.emadapt_permutohedral_init(ptr, 0, 3) is None  # n <= 0
    assert lib.emadapt_permutohedral_init(ptr, 4, 0) is None  # d <= 0
    assert lib.emadapt_permutohedral_init(ptr, 4, 99) is None  # d too big


def test_lattice_reuse_equals_fresh_lattices_and_jax():
    """One lattice filtering several value fields gives what a fresh
    lattice per field gives, and what the JAX package's binding gives."""
    from em_adapt_tpu.eval.permutohedral import permutohedral_filter as jax_filter

    g = np.random.default_rng(1)
    feats = g.normal(size=(300, 5)).astype(np.float32) * 2
    fields = [g.uniform(size=(300, c)).astype(np.float32) for c in (1, 4, 21)]
    lat = plat.PermutohedralLattice(feats)
    try:
        reused = [lat.filter(v) for v in fields]
    finally:
        lat.close()
    lat.close()  # a second close is a no-op
    for v, got in zip(fields, reused):
        np.testing.assert_array_equal(got, plat.permutohedral_filter(v, feats))
        np.testing.assert_allclose(got, jax_filter(v, feats), rtol=0, atol=1e-6)


def test_library_is_built_under_build_not_native():
    """The binding loads the g++ build named by its source, its flags and
    the host CPU, under build/em_adapt_torch; it never runs make."""
    assert plat.available()
    path = build.build_host("permutohedral")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libpermutohedral-")
    assert "-march=native" in build.CXX_FLAGS and "-fopenmp" in build.CXX_FLAGS


def test_concurrent_builds_rename_into_place(tmp_path, monkeypatch):
    """Several builds at once (as test workers run them) each compile to a
    file of their own and rename it into place: one library, no temp file
    left, loadable."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def one():
        try:
            paths.append(build.build_host("permutohedral"))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    lib = ctypes.CDLL(str(paths[0]))
    assert all(hasattr(lib, f"emadapt_permutohedral_{f}") for f in ("init", "filter", "free"))


def test_a_failed_build_is_cached_and_auto_falls_back_to_the_grid(monkeypatch):
    calls = []

    def broken(name):
        calls.append(name)
        raise RuntimeError("g++ build of native/permutohedral.cpp failed")

    monkeypatch.setattr(plat, "_lib", None)
    monkeypatch.setattr(plat, "_load_error", None)
    monkeypatch.setattr(build, "build_host", broken)
    assert not plat.available() and not plat.available()
    assert calls == ["permutohedral"] and "failed" in str(plat.load_error())
    probs, rgb = _two_region_case()
    np.testing.assert_array_equal(pcrf.dense_crf(probs, rgb, num_iterations=2),
                                  pcrf.dense_crf(probs, rgb, num_iterations=2, method="grid"))


def test_a_compiler_without_openmp_links_pytorchs(tmp_path, monkeypatch):
    """Where g++ cannot link -fopenmp (no libgomp.spec), the library is
    compiled with -fopenmp and linked against the libgomp that PyTorch
    ships: parallel still, and the lattice filters as the normal build's."""
    if build._torch_openmp() is None:
        pytest.skip("this PyTorch ships no libgomp")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    real, cmds = build._run, []

    def no_spec(cmd):
        cmds.append(cmd)
        if "-fopenmp" in cmd and "-shared" in cmd:
            return build.subprocess.CompletedProcess(
                cmd, 1, "g++: fatal error: cannot read spec file 'libgomp.spec'")
        return real(cmd)

    monkeypatch.setattr(build, "_run", no_spec)
    path = build.build_host("permutohedral")
    assert len(cmds) == 3 and "-c" in cmds[1] and str(build._torch_openmp()) in cmds[2]
    needed = build.subprocess.run(["ldd", str(path)], capture_output=True, text=True).stdout
    assert build._torch_openmp().name in needed  # parallel, on PyTorch's runtime
    feats = np.random.default_rng(2).normal(size=(500, 5)).astype(np.float32)
    vals = np.random.default_rng(3).uniform(size=(500, 3)).astype(np.float32)
    monkeypatch.setattr(plat, "_lib", None)
    monkeypatch.setattr(plat, "_load_error", None)
    monkeypatch.setattr(build, "build_host", lambda name: path)
    got = plat.permutohedral_filter(vals, feats)
    monkeypatch.setattr(plat, "_lib", None)
    monkeypatch.undo()
    np.testing.assert_array_equal(got, plat.permutohedral_filter(vals, feats))
