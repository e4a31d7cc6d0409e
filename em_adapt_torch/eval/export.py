"""Serialized inference programs (``torch.export``) and the reference's
``init.npy``.

The counterpart of ``em_adapt_tpu/eval/export.py``. The reference
registers graph collections so that a reloaded TF metagraph can be driven
without the model-building code (reference network.py:97-98,
deeplab.py:221); the JAX package serializes its jitted predict as
StableHLO; the port serializes it with ``torch.export``: predict(images)
-> (softmax of the upsampled logits, labels) at one fixed input shape,
the weights in the program, loadable by any process that has this
module, without the model's code.

Block 1 in bf16 on the card (``model.block1_impl`` "auto" or "pallas")
is K2, registered as the operator ``em_adapt::block1_fwd``
(``ops/block1.py``): the exported graph holds it as a node, and the
loaded program launches K2 where it runs, as the JAX artifact carries
its Pallas kernel. The int8 model (``eval/quantize.py``) exports the
same way: its s8 convolutions are ``aten._int_mm`` nodes, block 1
included, and it has no K2 node. A program exported on the card runs on
the card only: loading it where there is none raises.
"""

from __future__ import annotations

import io
import itertools

import numpy as np
import torch

from em_adapt_torch.config import ExperimentConfig
from em_adapt_torch.device import set_precision
from em_adapt_torch.models.convert import to_jax_params
from em_adapt_torch.models.deeplab import require_vgg
from em_adapt_torch.ops import block1  # noqa: F401  registers em_adapt::block1_fwd

#: The operator of K2 as it appears in an exported graph's nodes.
BLOCK1_OP = "em_adapt.block1_fwd.default"


class _Predict(torch.nn.Module):
    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        up, labels = self.model.predict(images)
        return torch.softmax(up, dim=-1), labels


def export_program(cfg: ExperimentConfig, model: torch.nn.Module,
                   batch_size: int | None = None) -> torch.export.ExportedProgram:
    """predict(images) -> (probs [B,H,W,C] f32, labels [B,H,W] int64) of
    ``model`` as it stands (its weights, device and dtype), exported for
    images [B, H, W, 3] f32, preprocessed (BGR, mean-subtracted), at B =
    ``batch_size or cfg.eval.batch_size`` and (H, W) =
    ``cfg.model.input_size``."""
    h, w = cfg.model.input_size
    b = batch_size or cfg.eval.batch_size
    set_precision(cfg.model.compute_dtype)
    device = next(itertools.chain(model.parameters(), model.buffers())).device
    images = torch.zeros(b, h, w, 3, dtype=torch.float32, device=device)
    was_training = model.training
    model.eval()
    predict = _Predict(model)
    try:
        with torch.no_grad():
            # One real call first: the resize grids (ops/resize.py) are
            # cached per size and device, and the trace must find real
            # tensors there, which it keeps as constants of the program.
            predict(images)
            return torch.export.export(predict, (images,))
    finally:
        model.train(was_training)


def export_predict_fn(cfg: ExperimentConfig, model: torch.nn.Module,
                      batch_size: int | None = None) -> bytes:
    """:func:`export_program`, serialized with ``torch.export.save``
    (write the bytes to a ``.pt2`` file)."""
    buf = io.BytesIO()
    torch.export.save(export_program(cfg, model, batch_size), buf)
    return buf.getvalue()


def load_predict_fn(blob: bytes):
    """The serialized program as a callable(images) -> (probs, labels),
    run without gradients. An input of another shape than the exported one
    raises. Float32 convolutions run in true float32 here too, as in the
    live model (``device.set_precision``)."""
    set_precision()
    module = torch.export.load(io.BytesIO(blob)).module()

    def predict(images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            return module(images)

    return predict


def export_params_npy(model_or_params, path: str) -> None:
    """Write the parameters in the reference's ``init.npy`` format,
    ``{layer: {"w": HWIO f32, "b": [C] f32}}`` (reference
    deeplab.py:126-129, :160-167), from a model or such a tree.
    ``model.init_model_path`` (and the JAX package's
    ``load_caffe_init``) read it back; every layer is in the file bit for
    bit, fc8 included, though an init.npy consumer re-initializes fc8 by
    contract. Written through a file object, so that no ".npy" is
    appended to ``path``. DeepLab-LargeFOV's layout only."""
    if isinstance(model_or_params, torch.nn.Module):
        require_vgg(model_or_params.cfg, "the npy interchange (export --format npy)")
        params = to_jax_params(model_or_params)
    else:
        params = model_or_params
    tree = {layer: {k: np.asarray(v, np.float32) for k, v in leaves.items()}
            for layer, leaves in params.items()}
    with open(path, "wb") as f:
        np.save(f, np.asarray(tree, dtype=object), allow_pickle=True)
