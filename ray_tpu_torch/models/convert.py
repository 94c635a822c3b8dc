"""Parameters of the JAX model -> state dict of the PyTorch model.

The JAX model (``ray_tpu/models/gpt.py``, ``GPT.init``) stacks each block
parameter over layers as ``[L, ...]``; the port keeps every per-layer
tensor in the same layout, so the mapping only unstacks (MoE's ``router``,
``w_up``, ``w_gate`` and ``w_down`` keep their expert axis).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_from_jax(params: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """`params`: the JAX pytree with numpy arrays as leaves (``{"tok_embed",
    "blocks": {name: [L, ...]}, "norm_f", ...}``) -> a state dict for
    `ray_tpu_torch.models.GPT(config)` (``load_state_dict``)."""
    L = config.n_layers
    state: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        if name == "blocks":
            continue
        state[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    for name, stacked in params["blocks"].items():
        stacked = np.asarray(stacked, dtype=np.float32)
        if stacked.shape[0] != L:
            raise ValueError(f"blocks/{name} has leading dim "
                             f"{stacked.shape[0]}, expected n_layers={L} "
                             "(pipeline stage-stacked params are not "
                             "supported)")
        for i in range(L):
            state[f"blocks.{i}.{name}"] = torch.from_numpy(stacked[i].copy())
    return state
