"""Parameters of the JAX model -> state dict of the PyTorch model, and full
state dicts to and from a model's shards on a mesh.

The JAX model (``ray_tpu/models/gpt.py``, ``GPT.init``) stacks each block
parameter over layers as ``[L, ...]``, or over stages and layers as ``[P,
L/P, ...]`` on a mesh with pp > 1; the port keeps every per-layer tensor
in the same layout, so the mapping only unstacks (MoE's ``router``,
``w_up``, ``w_gate`` and ``w_down`` keep their expert axis). On a process
mesh a model holds shards (its tp and ep slice, cut again over fsdp by
FSDP2; on a pipeline stage only its blocks): `load_full_state_dict` puts
full tensors into them, `full_state_dict` puts them back together.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ..parallel.mesh import AXIS_EP, AXIS_TP
from ..parallel.sharding import gather_params, shard_params

# dimensions of one layer's slice of each block parameter (the experts'
# with their expert axis)
_LAYER_NDIM = {"norm1": 1, "norm2": 1, "bias1": 1, "bias2": 1, "wq": 3,
               "wk": 3, "wv": 3, "wo": 3, "router": 2}


def params_from_jax(params: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """`params`: the JAX pytree with numpy arrays as leaves (``{"tok_embed",
    "blocks": {name: [L, ...]}, "norm_f", ...}``; on a JAX mesh with pp > 1
    each block leaf is stage-stacked, ``[P, L/P, ...]``, and is flattened
    to ``[L, ...]`` first) -> the full state dict of
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
        ndim = _LAYER_NDIM.get(name, 3 if config.n_experts > 0 else 2)
        if stacked.ndim == ndim + 2:          # [P, L/P, ...]
            stacked = stacked.reshape(-1, *stacked.shape[2:])
        if stacked.ndim != ndim + 1 or stacked.shape[0] != L:
            raise ValueError(f"blocks/{name} has shape {stacked.shape}, "
                             f"expected [n_layers={L}, ...] or [pp, "
                             f"n_layers / pp, ...] over {ndim}-d layers")
        for i in range(L):
            state[f"blocks.{i}.{name}"] = torch.from_numpy(stacked[i].copy())
    return state


def load_full_state_dict(model, state: Mapping[str, torch.Tensor]) -> None:
    """Full tensors (every parameter's logical shape, as `params_from_jax`
    gives them) -> `model`'s parameters: on a process mesh, this rank's
    shards of them (on a pipeline stage its blocks, its tp and ep slice by
    the model's rules, then FSDP2's part of that); without one, the whole
    tensors. Every rank passes the same full tensors; nothing is sent
    between ranks."""
    own = dict(model.named_parameters())
    every = set(model.param_logical_axes())
    if set(state) != every:
        raise ValueError(f"state names differ from the model's: missing "
                         f"{sorted(every - set(state))}, unexpected "
                         f"{sorted(set(state) - every)}")
    if not model.sums_over_ranks:
        model.load_state_dict(state)
        return
    local = shard_params({n: state[n] for n in own},
                         model.own_logical_axes(), model.mesh,
                         model.rules.only(AXIS_TP, AXIS_EP))
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
    shards of every rank on a process mesh, the blocks of every pipeline
    stage included (the parameters outside the blocks are this rank's). A
    collective: every rank of the mesh calls it, and every rank gets the
    full tensors."""
    import torch.distributed as dist

    if tensors is None:
        tensors = dict(model.named_parameters())
    with torch.no_grad():
        out = {n: (t.full_tensor() if isinstance(t, DTensor) else t).detach()
               for n, t in tensors.items()}
        if not model.sums_over_ranks:
            return out
        out = gather_params(out, model.own_logical_axes(), model.mesh,
                            model.rules.only(AXIS_TP, AXIS_EP))
        pipe = model._pipe
        if pipe is None:
            return out
        # every stage holds its L/P blocks in the same order: block j of
        # stage s is layer s * L/P + j
        per = model.config.n_layers // pipe.size
        (stage,) = pipe.stages
        for name in [n for n in out if n.startswith("blocks.")]:
            _, layer, rest = name.split(".", 2)
            t = out.pop(name).contiguous()
            parts = [torch.empty_like(t) for _ in range(pipe.size)]
            dist.all_gather(parts, t, group=pipe.group)
            for s, part in enumerate(parts):
                out[f"blocks.{int(layer) - stage * per + s * per}.{rest}"] = part
        return {n: out[n] for n in model.param_logical_axes()}
