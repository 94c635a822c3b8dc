"""Weights of the JAX RL modules <-> state dicts of the port's modules.

The RL counterpart of ``models/convert.py``. The JAX modules keep their
parameters as a pytree, ``{"torso": [{"w", "b"}, ...], "pi": {"w", "b"},
"vf": {"w", "b"}}`` (or ``"q"`` for the Q network), which the learners hand
to the env runners as numpy leaves (``get_weights``). The port's modules
name the same tensors ``torso.{i}.w``, ``pi.b`` and so on, in the same
layout, so the mapping only renames: the same weights pass learner ->
runner, and JAX <-> port, unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_from_jax(nested: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX pytree with numpy (or array-like) leaves -> the module's
    state dict of f32 CPU tensors."""
    state: Dict[str, torch.Tensor] = {}
    for name, value in nested.items():
        layers = enumerate(value) if isinstance(value, (list, tuple)) else [
            (None, value)]
        for i, layer in layers:
            prefix = name if i is None else f"{name}.{i}"
            for leaf, array in layer.items():
                state[f"{prefix}.{leaf}"] = torch.from_numpy(
                    np.array(array, dtype=np.float32))
    return state


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """A module's state dict -> the JAX pytree layout with numpy f32
    leaves: the inverse of `params_from_jax`."""
    nested: Dict[str, Any] = {}
    for key, tensor in state.items():
        array = tensor.detach().to("cpu", torch.float32).numpy().copy()
        parts = key.split(".")
        if len(parts) == 3:                 # torso.{i}.{leaf}
            name, i, leaf = parts
            layers = nested.setdefault(name, [])
            while len(layers) <= int(i):
                layers.append({})
            layers[int(i)][leaf] = array
        else:                               # {head}.{leaf}
            name, leaf = parts
            nested.setdefault(name, {})[leaf] = array
    return nested
