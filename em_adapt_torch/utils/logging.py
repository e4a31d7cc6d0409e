"""Structured metric logging.

A copy of ``em_adapt_tpu/utils/logging.py``: each record goes to stdout
as one aligned line and, with a path, to a JSONL file for tooling. The
train loop's records carry loss, lr, images/sec, the E-step's µs/image
(measured once at start, ``TrainConfig.calibrate_estep``, and stamped
into every record) and, with periodic eval (``TrainConfig.eval_every_steps``),
``val_metric`` records.

Values: 0-d tensors and numpy scalars become numbers (integer dtypes stay
ints), vectors become lists, containers are converted inside. A 0-d CUDA
tensor is copied to the host here, which waits for the device: the log
cadence's sync. Non-finite floats go into the JSONL as the strings
"nan", "inf" and "-inf" (bare NaN tokens are not JSON).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import torch


def scalarize(v):
    """``v`` with tensors and numpy values turned into Python numbers and
    lists, inside dicts, lists and tuples too."""
    if isinstance(v, dict):
        return {k: scalarize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [scalarize(x) for x in v]
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, torch.Tensor):
        if v.ndim:
            return v.tolist()
        integral = not v.is_floating_point() and not v.is_complex() and v.dtype != torch.bool
        return int(v) if integral else float(v)
    if np.ndim(v) == 0 and hasattr(v, "__float__"):
        if hasattr(v, "dtype") and np.issubdtype(v.dtype, np.integer):
            return int(v)
        return float(v)
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


def _finite(v):
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    if isinstance(v, list):
        return [_finite(x) for x in v]
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    return v


class MetricLogger:
    def __init__(self, jsonl_path: str | None = None, stream=None):
        self.stream = stream or sys.stdout
        self._fh = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._fh = open(jsonl_path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, metrics: dict, prefix: str = "train") -> None:
        rec = {"t": round(time.time() - self._t0, 3), "prefix": prefix}
        rec.update({k: scalarize(v) for k, v in metrics.items()})
        parts = [f"[{prefix}]"]
        for k, v in rec.items():
            if k == "prefix":
                continue
            parts.append(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}")
        print(" ".join(parts), file=self.stream, flush=True)
        if self._fh:
            self._fh.write(json.dumps({k: _finite(v) for k, v in rec.items()}) + "\n")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __call__(self, metrics: dict) -> None:
        self.log(metrics)
