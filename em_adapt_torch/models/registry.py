"""Model registry: the architecture ``ModelConfig.name`` names.

The counterpart of ``em_adapt_tpu/models/registry.py``: the reference
hardcodes one architecture (ADAPT, reference deeplab.py:12), and the
registry lets another segmentation backbone slot in behind the same
trainer, evaluator and exporter. :func:`~em_adapt_torch.models.deeplab.build_model`
looks the name up.
"""

from __future__ import annotations

_REGISTRY: dict[str, type] = {}


def register_model(name: str):
    """Class decorator: register the model class under ``name``."""
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def get_model(name: str):
    """The model class registered under ``name``; raises KeyError naming
    the registered ones."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
