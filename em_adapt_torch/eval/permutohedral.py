"""ctypes binding of the native permutohedral-lattice Gaussian filter.

The port's copy of ``em_adapt_tpu/eval/permutohedral.py``: the library is
``native/permutohedral.cpp`` (the lattice behind the reference's denseCRF,
reference readme.md:40-44), built by ``utils/build.py::build_host`` with
``g++`` under ``build/em_adapt_torch/`` (never by ``make`` in
``native/``), and exposes

    permutohedral_filter(values [N, C], features [N, D]) -> [N, C]

approximating sum_j exp(-0.5 ||f_i - f_j||^2) v_j / (same with v=1) for
unit-std features. A failed build or load is cached: ``available()`` is
asked once per image.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_load_error: Exception | None = None
#: Lattices built since the process started (``chip_smoke.py`` reads it to
#: tell that the host CRF ran on the lattice).
lattices_built = 0


def _load() -> ctypes.CDLL:
    global _lib, _load_error
    with _lock:
        if _load_error is not None:
            raise _load_error
        if _lib is None:
            try:
                _lib = _load_locked()
            except Exception as e:
                _load_error = e
                raise
    return _lib


def _load_locked() -> ctypes.CDLL:
    """Build if needed, dlopen, and declare the C interface (its symbols
    are touched here, so a library without them fails now, cached)."""
    from em_adapt_torch.utils.build import build_host

    lib = ctypes.CDLL(str(build_host("permutohedral")))
    lib.emadapt_permutohedral_init.restype = ctypes.c_void_p
    lib.emadapt_permutohedral_init.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # features [n, d]
        ctypes.c_int32,  # n
        ctypes.c_int32,  # d
    ]
    lib.emadapt_permutohedral_filter.restype = ctypes.c_int
    lib.emadapt_permutohedral_filter.argtypes = [
        ctypes.c_void_p,  # lattice
        ctypes.POINTER(ctypes.c_float),  # values [n, c]
        ctypes.POINTER(ctypes.c_float),  # out [n, c]
        ctypes.c_int32,  # n
        ctypes.c_int32,  # c
    ]
    lib.emadapt_permutohedral_free.restype = None
    lib.emadapt_permutohedral_free.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """True if the library builds and loads on this host."""
    try:
        _load()
        return True
    except (OSError, RuntimeError, AttributeError):
        return False


def load_error() -> Exception | None:
    """Why the library did not build or load (None if it did, or was not
    tried yet)."""
    return _load_error


class PermutohedralLattice:
    """A lattice built once from unit-std features [N, D]; ``filter`` runs
    normalized Gaussian filtering of values [N, C] over it (the homogeneous
    channel is appended here). Mean-field inference reuses one lattice for
    all its iterations."""

    def __init__(self, features: np.ndarray):
        global lattices_built
        self._lib = _load()
        features = np.ascontiguousarray(features, np.float32)
        self.n, self.d = features.shape
        self._handle = self._lib.emadapt_permutohedral_init(
            features.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), self.n, self.d)
        if not self._handle:
            raise RuntimeError(f"permutohedral init failed (n={self.n}, d={self.d})")
        with _lock:
            lattices_built += 1

    def filter(self, values: np.ndarray) -> np.ndarray:
        values = np.ascontiguousarray(values, np.float32)
        n, c = values.shape
        if n != self.n:
            raise ValueError(f"values N={n} != lattice N={self.n}")
        homog = np.concatenate([values, np.ones((n, 1), np.float32)], axis=1)
        out = np.empty_like(homog)
        rc = self._lib.emadapt_permutohedral_filter(
            self._handle,
            homog.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, c + 1)
        if rc != 0:
            raise RuntimeError(f"permutohedral filter failed with code {rc}")
        return out[:, :-1] / np.maximum(out[:, -1:], 1e-12)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.emadapt_permutohedral_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def permutohedral_filter(values: np.ndarray, features: np.ndarray) -> np.ndarray:
    """One-shot :class:`PermutohedralLattice` filter."""
    lat = PermutohedralLattice(features)
    try:
        return lat.filter(values)
    finally:
        lat.close()
