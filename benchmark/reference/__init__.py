"""Plain PyTorch references of the benchmark's configurations.

Each family's equations are frozen here in float32 with TF32 off
(`common.exact_f32`), written from the published model description, in the
parameter layout the benchmark draws its weights in. Nothing here imports
the program: the reference is handed the same weights and tokens, and works
out again whatever the program derived from them.
"""

import importlib


def family(name: str):
    """The reference module of a model family (``reference/<name>.py``)."""
    return importlib.import_module(f"{__name__}.{name}")
