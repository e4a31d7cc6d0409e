"""Import a reference TF1 ``tf.train.Saver`` checkpoint as parameters.

The counterpart of ``em_adapt_tpu/models/tf_import.py``. The reference
ships ``tf.train.Saver`` checkpoints of its trainable variables only
(reference network.py:100-102), created by ``tf.get_variable`` at top
scope (the surrounding ``tf.name_scope`` does not reach variable names,
reference deeplab.py:51-107, :152-167): the keys are flat
``<layer>_weights`` / ``<layer>_bias`` (``conv1_1_weights`` ...
``fc8_bias``), the kernels HWIO, the layout of ``{layer: {"w", "b"}}``
that ``DeepLabLargeFOV.load_params`` takes. ``eval/export.py``'s
``export_params_npy`` goes the other way. TensorFlow is imported inside
:func:`load_tf_checkpoint_params` only, as a checkpoint reader.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from em_adapt_torch.config import ModelConfig
from em_adapt_torch.models.deeplab import layer_specs, require_vgg


def load_tf_checkpoint_params(prefix: str, cfg: ModelConfig) -> dict[str, dict[str, np.ndarray]]:
    """Read a reference TF1 checkpoint into ``{layer: {"w": HWIO, "b"}}``
    float32 numpy.

    ``prefix`` is the Saver prefix (e.g. ``saver/norm-24000``: the path
    without the ``.index`` / ``.data-*`` suffixes, what
    ``tf.train.Saver.restore`` takes, reference network.py:106). Every
    layer of ``layer_specs(cfg)`` must be there with its HWIO shape: a
    missing variable raises KeyError naming it, a wrong shape ValueError
    with both shapes (e.g. a 21-class checkpoint under
    ``model.num_classes=4``).
    """
    require_vgg(cfg, "TF1 checkpoint import (import-tf)")
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError("import-tf needs tensorflow on the host to read the checkpoint "
                          "(used only as a reader)") from e

    reader = tf.train.load_checkpoint(prefix)
    shape_map = reader.get_variable_to_shape_map()
    params: dict[str, dict[str, np.ndarray]] = {}
    for name, kh, kw, cin, cout, _rate in layer_specs(cfg):
        got: dict[str, np.ndarray] = {}
        for suffix, want_shape in (("weights", (kh, kw, cin, cout)), ("bias", (cout,))):
            var = f"{name}_{suffix}"
            if var not in shape_map:
                have = ", ".join(sorted(shape_map)) or "<empty>"
                raise KeyError(
                    f"variable {var!r} not found in checkpoint {prefix!r} "
                    f"(is it a reference em-adapt Saver checkpoint? available: {have})"
                )
            tensor = np.asarray(reader.get_tensor(var), np.float32)
            if tensor.shape != want_shape:
                raise ValueError(
                    f"{var}: checkpoint shape {tensor.shape} != expected {want_shape} (HWIO) "
                    f"— does the ModelConfig (num_classes={cfg.num_classes}, "
                    f"fc6_channels={cfg.fc6_channels}) match the checkpoint's training config?"
                )
            got["w" if suffix == "weights" else "b"] = tensor
        params[name] = got
    return params


def params_l2(params: dict[str, dict[str, Any]]) -> float:
    """The sum of squares over every leaf: the reference prints it before
    and after a restore as a fingerprint of the loaded weights (reference
    deeplab.py:230-234); ``import-tf`` prints it for the same reason."""
    return float(sum(float(np.square(np.asarray(leaf)).sum())
                     for layer in params.values() for leaf in layer.values()))
