"""ctypes binding of the native (host C++) E-step, ``native/estep.cpp``.

The port's own copy of ``em_adapt_tpu/ops/estep_native.py``: the same C
interface (``emadapt_estep``, its argument order and its error codes 1-5),
with the library built by ``utils/build.py::build_host`` with ``g++``
into ``build/em_adapt_torch/`` (never by ``make`` in ``native/``). It
runs on the host's cores (OpenMP over the images) on numpy arrays, so on
the card ``estep_labels(impl="native")`` copies the scores to the host
and the labels back: a host sync by design, the round trip the
reference paid every step (reference deeplab.py:120).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lock = threading.Lock()
_lib = None

#: ``emadapt_estep``'s error codes (native/estep.cpp).
REASONS = {
    1: "null pointer",
    2: "invalid sizes",
    3: "invalid class orders",
    4: "percentile out of range",
    5: "allocation failure",
}


def _load() -> ctypes.CDLL:
    """Build if needed, dlopen and type the C interface, once."""
    global _lib
    with _lock:
        if _lib is None:
            from em_adapt_torch.utils.build import build_host

            lib = ctypes.CDLL(str(build_host("estep")))
            lib.emadapt_estep.restype = ctypes.c_int
            lib.emadapt_estep.argtypes = [
                ctypes.POINTER(ctypes.c_float),  # scores
                ctypes.POINTER(ctypes.c_float),  # out
                ctypes.POINTER(ctypes.c_int32),  # labels
                ctypes.c_int32,  # B
                ctypes.c_int32,  # H
                ctypes.c_int32,  # W
                ctypes.c_int32,  # C
                ctypes.POINTER(ctypes.c_int32),  # orders
                ctypes.c_int32,  # num_iter
                ctypes.c_int32,  # suppress
                ctypes.c_float,  # margin
                ctypes.c_double,  # bg_p (double: k = int(HW*p) must
                ctypes.c_double,  # fg_p  truncate exactly like the oracle)
            ]
            _lib = lib
    return _lib


def estep_native(
    scores: np.ndarray,
    label: np.ndarray,
    orders: np.ndarray,
    *,
    bg_p: float = 0.4,
    fg_p: float = 0.2,
    num_iter: int = 5,
    suppress_others: bool = True,
    margin_others: float = 1e-5,
) -> np.ndarray:
    """The adaptive E-step on the host: scores [B,H,W,C], label [B,H,W],
    orders [num_iter, C-1]; returns the biased [B,H,W,C] f32 map
    (out-of-place). Raises RuntimeError with the library's reason when it
    returns an error code."""
    lib = _load()
    scores = np.ascontiguousarray(scores, np.float32)
    b, h, w, c = scores.shape
    labels = np.ascontiguousarray(label, np.int32).reshape(b, h, w)
    orders = np.ascontiguousarray(orders, np.int32)
    if orders.shape != (num_iter, c - 1):
        raise ValueError(
            f"orders must have shape (num_iter={num_iter}, C-1={c - 1}), got {orders.shape}"
        )
    out = np.empty_like(scores)
    rc = call(lib, scores, out, labels, orders, b, h, w, c, num_iter, suppress_others,
              margin_others, bg_p, fg_p)
    if rc != 0:
        raise RuntimeError(
            f"emadapt_estep failed with code {rc} ({REASONS.get(rc, 'unknown')})"
        )
    return out


def call(lib: ctypes.CDLL, scores, out, labels, orders, b: int, h: int, w: int, c: int,
         num_iter: int, suppress_others: bool, margin_others: float, bg_p: float,
         fg_p: float) -> int:
    """One raw ``emadapt_estep`` call on numpy arrays (None passes a null
    pointer); its return code."""
    def ptr(a, ct):
        return None if a is None else a.ctypes.data_as(ctypes.POINTER(ct))

    return lib.emadapt_estep(
        ptr(scores, ctypes.c_float), ptr(out, ctypes.c_float), ptr(labels, ctypes.c_int32),
        b, h, w, c, ptr(orders, ctypes.c_int32), num_iter, 1 if suppress_others else 0,
        margin_others, bg_p, fg_p,
    )
