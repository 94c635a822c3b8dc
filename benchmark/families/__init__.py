"""Model families: a configuration file's keys, read into `Dims`."""

from __future__ import annotations

import importlib

from ..reference.common import Dims


def dims(config: dict) -> Dims:
    """`Dims` of a configuration file, by its ``model_type``
    (``families/<model_type>.py``)."""
    mod = importlib.import_module(f"{__name__}.{config['model_type']}")
    return mod.dims(config)
