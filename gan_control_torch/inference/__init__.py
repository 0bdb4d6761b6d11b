"""Inference entry points: ``Inference``, ``Controller``, serving
(``ServingController``, ``load_exported_serving``/``ExportedServing``) and
group interpolation.

The names are imported on first use, so that importing
``gan_control_torch.inference.exported`` (model-code-free serving) loads
no model module through this package.
"""

import importlib

_EXPORTS = {
    "Inference": "inference",
    "Controller": "controller",
    "ServingController": "serving",
    "ServingRequest": "serving",
    "ExportedServing": "exported",
    "load_exported_serving": "exported",
    "interpolate_by_group": "interpolation",
    "save_gif": "interpolation",
    "slerp": "interpolation",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
