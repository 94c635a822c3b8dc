"""Parameters of the JAX model -> state dict of the PyTorch model, and full
state dicts to and from a model's shards on a mesh.

The JAX model (``ray_tpu/models/gpt.py``, ``GPT.init``) stacks each block
parameter over layers as ``[L, ...]``; the port keeps every per-layer
tensor in the same layout, so the mapping only unstacks (MoE's ``router``,
``w_up``, ``w_gate`` and ``w_down`` keep their expert axis). On a process
mesh a model holds shards (its tp slice, cut again over fsdp by FSDP2):
`load_full_state_dict` puts full tensors into them, `full_state_dict` puts
them back together.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ..parallel.mesh import AXIS_TP
from ..parallel.sharding import gather_params, shard_params


def params_from_jax(params: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """`params`: the JAX pytree with numpy arrays as leaves (``{"tok_embed",
    "blocks": {name: [L, ...]}, "norm_f", ...}``) -> the full state dict of
    `ray_tpu_torch.models.GPT(config)` (``load_state_dict`` without a mesh,
    `load_full_state_dict` on any)."""
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


def load_full_state_dict(model, state: Mapping[str, torch.Tensor]) -> None:
    """Full tensors (every parameter's logical shape, as `params_from_jax`
    gives them) -> `model`'s parameters: on a process mesh, this rank's
    shards of them (its tp slice by the model's rules, then FSDP2's part of
    that); without one, the whole tensors. Every rank passes the same
    full tensors; nothing is sent between ranks."""
    own = dict(model.named_parameters())
    if set(state) != set(own):
        raise ValueError(f"state names differ from the model's: missing "
                         f"{sorted(set(own) - set(state))}, unexpected "
                         f"{sorted(set(state) - set(own))}")
    if not model.sums_over_ranks:
        model.load_state_dict(state)
        return
    local = shard_params(state, model.param_logical_axes(), model.mesh,
                         model.rules.only(AXIS_TP))
    with torch.no_grad():
        for name, p in own.items():
            t = local[name].to(device=p.device, dtype=p.dtype)
            if isinstance(p, DTensor):
                t = distribute_tensor(t, p.device_mesh, p.placements,
                                      src_data_rank=None).to_local()
                p = p.to_local()
            p.copy_(t)


def full_state_dict(model, tensors: Mapping[str, torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """The full tensors of `model`'s parameters (or of `tensors`, the same
    names with the same layout: its gradients), put back together from the
    shards of every rank on a process mesh. A collective: every rank of the
    mesh calls it, and every rank gets the full tensors."""
    if tensors is None:
        tensors = dict(model.named_parameters())
    with torch.no_grad():
        out = {n: (t.full_tensor() if isinstance(t, DTensor) else t).detach()
               for n, t in tensors.items()}
        if not model.sums_over_ranks:
            return out
        return gather_params(out, model.param_logical_axes(), model.mesh,
                             model.rules.only(AXIS_TP))
