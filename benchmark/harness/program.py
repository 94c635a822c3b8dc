"""The system under test, ray_tpu_torch, as the benchmark drives it: a
configuration's `Dims` read into the port's `GPTConfig`, the benchmark's
weights loaded into the port's model, its train step and optimizer. The
harness reaches the program through this module (and the trainer's
entry point); the reference never does."""

from __future__ import annotations

from typing import Dict, Optional

from ..families import port_kwargs
from ..reference.common import Dims
from . import weights

# the port's norms take no eps: RMSNorm computes with 1e-6, LayerNorm 1e-5
PORT_NORM_EPS = {"rmsnorm": 1e-6, "layernorm": 1e-5}


def gpt_config(d: Dims):
    """The port's GPTConfig of `d`, with the family's `port_kwargs` added
    to it. A family may not replace a setting taken here from the
    configuration, and a key GPTConfig lacks fails there."""
    import torch
    from ray_tpu_torch.models.gpt import GPTConfig

    if d.norm_eps != PORT_NORM_EPS[d.norm]:
        raise ValueError(f"the port's {d.norm} takes eps "
                         f"{PORT_NORM_EPS[d.norm]}, the configuration "
                         f"states {d.norm_eps}")
    kw = dict(
        vocab_size=d.vocab, n_layers=d.n_layers, d_model=d.d_model,
        n_heads=d.n_heads, n_kv_heads=d.n_kv_heads, d_ff=d.d_ff,
        max_seq_len=d.max_positions,
        activation="swiglu" if d.activation == "swiglu" else "gelu",
        norm=d.norm, positions=d.positions,
        rope_theta=d.rope_theta or 10000.0,
        tie_embeddings=d.tie_embeddings, dtype=torch.bfloat16,
        param_dtype=torch.float32, remat=True, remat_policy="dots",
        z_loss=d.z_loss)
    extra = port_kwargs(d)
    fixed = sorted(kw.keys() & extra.keys())
    if fixed:
        raise ValueError(f"the {d.family} family's port_kwargs set {fixed}, "
                         "which the configuration fixes")
    return GPTConfig(**kw, **extra)


def _local(p):
    from torch.distributed.tensor import DTensor
    return p.to_local() if isinstance(p, DTensor) else p


def build_model(d: Dims, seed: int, device, mesh=None):
    """The port's GPT of `d` holding the benchmark's weights of `seed`:
    every parameter of the port drawn, in the family's layout, at the
    port's shape."""
    import torch
    from ray_tpu_torch.models import GPT

    model = GPT(gpt_config(d), device=device, seed=0, mesh=mesh)
    params = dict(model.named_parameters())
    drawn = set()
    with torch.no_grad():
        for group in weights.draw_groups(d, seed, device):
            for name, w in group.items():
                if name not in params:
                    raise ValueError(f"{name}: the benchmark drew it, the "
                                     "port has no such parameter")
                local = _local(params[name])
                if local.shape != w.shape:
                    raise ValueError(f"{name}: the port holds "
                                     f"{tuple(local.shape)}, the benchmark "
                                     f"drew {tuple(w.shape)}")
                local.copy_(w)
                drawn.add(name)
    if drawn != set(params):
        raise ValueError("the port holds parameters the benchmark does not "
                         f"draw: {sorted(set(params) - drawn)}")
    return model


def optimizer(opt: dict):
    from ray_tpu_torch.models.training import Optimizer
    return Optimizer(learning_rate=opt["learning_rate"],
                     schedule=opt["schedule"],
                     weight_decay=opt["weight_decay"], b1=opt["b1"],
                     b2=opt["b2"], eps=opt["eps"],
                     grad_clip=opt["grad_clip"])


def first_grad_norms(state, b1: float) -> Dict[str, float]:
    """Each leaf's norm of the gradient the optimizer took in at its first
    update, worked out from its first moment: mu = (1 - b1) g."""
    mu = state.opt_state["mu"]
    return {n: float(m.float().norm()) / (1 - b1) for n, m in mu.items()}


def change_norms(model, d: Dims, seed: int, device) -> Dict[str, float]:
    """Each leaf's norm of its change from the weights the seed drew."""
    import torch

    params = dict(model.named_parameters())
    out = {}
    with torch.no_grad():
        for group in weights.draw_groups(d, seed, device):
            for name, w in group.items():
                out[name] = float((_local(params[name]).float() - w).norm())
    return out


def mesh_for(entry: str, device_type: str) -> Optional[object]:
    """The trainer's gang holds its card through a one-rank process mesh
    (FSDP2 over dp x fsdp); the bare step runs without one."""
    if entry != "trainer":
        return None
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    return build_mesh(MeshSpec(dp=1, fsdp=1), device_type=device_type)
