"""Model registry: the architecture ``ModelConfig.name`` names.

The counterpart of ``em_adapt_tpu/models/registry.py``: the reference
hardcodes one architecture (ADAPT, reference deeplab.py:12), and the
registry lets another segmentation backbone slot in behind the same
trainer, evaluator and exporter. Two are registered:
``deeplab_largefov`` (VGG-16 DeepLab-LargeFOV, ``models/deeplab.py``) and
``deeplab_v2_resnet101`` (DeepLab-v2 ResNet-101 with ASPP-L,
``models/resnet.py``). :func:`~em_adapt_torch.models.deeplab.build_model`
looks the name up.

A registered class is an ``nn.Module`` built as ``cls(cfg, plan=None)``
whose ``forward(x, *, train, generator, masks, shard, strip)`` maps NHWC
images to f32 NHWC logits at ceil(H / ``output_stride``), with
``predict``, ``weight_l2``, ``load_params``, a ``plan`` attribute, the
static ``init_params(generator, cfg, init_model)`` and ``HEAD``, the
classifier head's layer names (``train/optim.py``'s LR groups).
"""

from __future__ import annotations

import importlib

_REGISTRY: dict[str, type] = {}
#: The modules that register the built-in architectures, imported at the
#: first lookup of a name not yet registered.
BUILTIN = ("em_adapt_torch.models.deeplab", "em_adapt_torch.models.resnet")


def register_model(name: str):
    """Class decorator: register the model class under ``name``."""
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def get_model(name: str):
    """The model class registered under ``name``; raises KeyError naming
    the registered ones."""
    if name not in _REGISTRY:
        for module in BUILTIN:
            importlib.import_module(module)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
