"""Mixture-of-experts FFN, on one device or on a mesh.

Counterpart of ``ray_tpu/models/moe.py``: top-k routing with
capacity-bounded dense dispatch. Token -> (expert, slot) assignment becomes
one-hot dispatch and combine tensors, and the expert work three batched
products over a leading expert axis.

On a process mesh (`MoEMesh`) the numbers are those of JAX's global
computation under GSPMD. Each rank holds its rows and columns of the batch
(dp x fsdp x sp), replicated over ep and tp, and E/ep experts whose mlp
axis is split over tp. The capacity comes from the global token count and
the slots from a cumsum over the global order (the routing choices
gathered over the batch group), so slots and `fits` are exactly JAX's.
Each rank builds its local dispatch and combine [T_local, E/ep, C], sums
its part of the expert buffers over the batch group, runs its experts on
its f columns and sums their outputs over tp, and its partial combine over
ep (`ray_tpu_torch.parallel.expert_parallel`). The load-balance loss is
each rank's share of the global one.

The products without a batch dimension (router, dispatch, combine) run as
2-D ``torch.mm``, the per-expert ones as ``torch.bmm``: the model's "dots"
checkpoint policy saves exactly the ``aten.mm`` outputs, as JAX's
``dots_with_no_batch_dims_saveable`` saves those three products and
recomputes the per-expert ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.expert_parallel import (copy_to_ep, gather_over_batch,
                                        reduce_from_ep, sum_over_batch)
from ..parallel.tensor_parallel import copy_to_tp, reduce_from_tp


@dataclasses.dataclass(frozen=True)
class MoEMesh:
    """What `moe_ffn` needs of a process mesh: the batch group (dp x fsdp x
    sp) with this rank's row and column block of the global batch, the ep
    group with this rank's place on it, and the tp group."""

    batch_group: Any
    n_rows: int      # row blocks: dp x fsdp
    n_cols: int      # column blocks: sp
    row: int
    col: int
    ep_group: Any
    ep_size: int
    ep_rank: int
    tp_group: Any

    @classmethod
    def from_mesh(cls, mesh) -> "MoEMesh":
        shape, coords = mesh.shape, mesh.coords
        return cls(batch_group=mesh.batch_group,
                   n_rows=shape["dp"] * shape["fsdp"], n_cols=shape["sp"],
                   row=coords["dp"] * shape["fsdp"] + coords["fsdp"],
                   col=coords["sp"], ep_group=mesh.group("ep"),
                   ep_size=shape["ep"], ep_rank=coords["ep"],
                   tp_group=mesh.group("tp"))


def _one_hot(values: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of `values` over `n` classes by comparison, as
    ``jax.nn.one_hot``: a value outside [0, n) gives a zero row (slots past
    the capacity do), where ``F.one_hot`` raises."""
    classes = torch.arange(n, device=values.device, dtype=values.dtype)
    return (values[..., None] == classes).float()


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert: capacity_factor x the even share of the
    top_k * n_tokens choices, truncated as Python's ``int`` does."""
    return max(1, int(capacity_factor * top_k * n_tokens / n_experts))


def top_k_experts(probs: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the `k` largest `probs` per row, in
    ``jax.lax.top_k``'s order: ties go to the lower index (a stable
    descending sort, first k taken; ``torch.topk`` promises no order)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
          n_slots: int) -> Dict[str, torch.Tensor]:
    """Router of `moe_ffn` with `n_slots` per expert (`capacity`):
    x [T, D] -> f32 ``probs`` [T, E], renormalised
    ``gate_vals`` [T, K] (0 where dropped), ``expert_idx`` [T, K],
    ``onehot`` [T, K, E], ``slot`` [T, K] (f32) and ``fits`` [T, K]."""
    e = router_w.shape[-1]
    n_tokens = x.shape[0]
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)   # [T, E]
    gate_vals, expert_idx = top_k_experts(probs, top_k)           # [T, K]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    onehot = _one_hot(expert_idx, e)                              # [T, K, E]
    slot = _slots(onehot)
    fits = slot < n_slots
    return {"probs": probs, "gate_vals": gate_vals * fits,   # drop overflow
            "expert_idx": expert_idx, "onehot": onehot, "slot": slot,
            "fits": fits}


def _slots(onehot: torch.Tensor) -> torch.Tensor:
    """onehot [T, K, E] -> the slot [T, K] (f32) of each (token, k) in its
    expert's buffer; priority: every k=0 choice first, then k=1, each in
    token order (an f32 cumsum, exact up to 2**24 choices)."""
    n_tokens, top_k, e = onehot.shape
    flat = onehot.transpose(0, 1).reshape(top_k * n_tokens, e)
    pos = torch.cumsum(flat, dim=0) - flat                        # [K*T, E]
    pos = pos.reshape(top_k, n_tokens, e).transpose(0, 1)         # [T, K, E]
    return (pos * onehot).sum(-1)                                 # [T, K]


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_up: torch.Tensor,
            w_gate: torch.Tensor, w_down: torch.Tensor, *, top_k: int = 2,
            capacity_factor: float = 1.25, dtype=torch.bfloat16,
            mesh: Optional[MoEMesh] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, D]; router_w: [D, E]; w_up/w_gate: [E, D, F];
    w_down: [E, F, D] -> ([B, S, D] in `dtype`, {"moe_aux_loss",
    "moe_overflow"}), the Switch load-balance loss and the dropped share
    of the (token, k) choices.

    On a `mesh`: x is this rank's [B_local, S_local, D], the expert weights
    its [E/ep, D, F/tp] and [E/ep, F/tp, D] slices; the output is this
    rank's rows and columns, "moe_overflow" the global share and
    "moe_aux_loss" this rank's share of the global loss (the shares sum
    over the batch group to JAX's)."""
    if mesh is not None:
        return _moe_ffn_mesh(x, router_w, w_up, w_gate, w_down, top_k,
                             capacity_factor, dtype, mesh)
    b, s, d = x.shape
    e = router_w.shape[-1]
    n_tokens = b * s
    cap = capacity(n_tokens, e, top_k, capacity_factor)

    xf = x.reshape(n_tokens, d)
    r = route(xf, router_w, top_k, cap)
    onehot, fits = r["onehot"], r["fits"]
    # dispatch [T, E, C]: token t -> (expert, slot); combine adds the gates
    dispatch = (onehot[..., None]
                * _one_hot(r["slot"], cap)[:, :, None, :]
                * fits[..., None, None]).sum(1)
    combine = dispatch * (r["gate_vals"][:, :, None, None]
                          * onehot[..., None]).sum(1)

    ec = e * cap
    expert_in = (dispatch.to(dtype).reshape(n_tokens, ec).t()
                 @ xf.to(dtype)).view(e, cap, d)                  # [E, C, D]
    up = torch.bmm(expert_in, w_up.to(dtype))
    gate = torch.bmm(expert_in, w_gate.to(dtype))
    expert_out = torch.bmm(F.silu(gate) * up, w_down.to(dtype))   # [E, C, D]
    out = combine.to(dtype).reshape(n_tokens, ec) @ expert_out.reshape(ec, d)

    # Switch load-balance loss: E * sum_e(mean prob_e * top-1 fraction_e)
    aux_loss = e * torch.sum(r["probs"].mean(0) * onehot[:, 0, :].mean(0))
    metrics = {"moe_aux_loss": aux_loss,
               "moe_overflow": 1.0 - fits.float().mean()}
    return out.reshape(b, s, d).to(dtype), metrics


def route_on_mesh(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
                  capacity_factor: float, m: MoEMesh
                  ) -> Dict[str, torch.Tensor]:
    """`route` of this rank's tokens x [B_local, S_local, D] on a process
    mesh, with JAX's global capacity and slot order: ``probs``,
    ``gate_vals``, ``expert_idx``, ``onehot``, ``slot`` and ``fits`` of this
    rank's tokens [T_local, ...], the capacity ``n_slots``, and the global
    choices ``onehot_all`` [T, K, E] and ``fits_all`` [T, K] (no grad)."""
    b, s, d = x.shape
    e = router_w.shape[-1]
    n_local = b * s
    n_tokens = n_local * m.n_rows * m.n_cols
    cap = capacity(n_tokens, e, top_k, capacity_factor)
    xf = x.reshape(n_local, d)
    probs = torch.softmax(xf.float() @ router_w.float(), dim=-1)  # [T_l, E]
    gate_vals, expert_idx = top_k_experts(probs, top_k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    onehot = _one_hot(expert_idx, e)                              # [T_l, K, E]

    # the global choices in global token order (row * S + col): the
    # batch group's parts are its (row block, column block) in rank order
    parts = gather_over_batch(expert_idx.view(b, s, top_k), m.batch_group)
    every = (parts.view(m.n_rows, m.n_cols, b, s, top_k)
             .permute(0, 2, 1, 3, 4).reshape(n_tokens, top_k))
    onehot_all = _one_hot(every, e)                               # [T, K, E]
    slot_all = _slots(onehot_all)
    slot = (slot_all.view(m.n_rows * b, m.n_cols * s, top_k)
            [m.row * b:(m.row + 1) * b, m.col * s:(m.col + 1) * s]
            .reshape(n_local, top_k))
    fits = slot < cap
    return {"probs": probs, "gate_vals": gate_vals * fits,   # drop overflow
            "expert_idx": expert_idx, "onehot": onehot, "slot": slot,
            "fits": fits, "n_slots": cap, "onehot_all": onehot_all,
            "fits_all": slot_all < cap}


def _moe_ffn_mesh(x, router_w, w_up, w_gate, w_down, top_k, capacity_factor,
                  dtype, m: MoEMesh):
    """`moe_ffn` on a process mesh; the same ops as on one device where the
    one-device code has them, so that a mesh of one rank gives its numbers."""
    b, s, d = x.shape
    e = router_w.shape[-1]
    e_local = w_up.shape[0]
    if e_local * m.ep_size != e:
        raise ValueError(f"{e_local} experts on each of {m.ep_size} ep "
                         f"ranks, the router has {e}")
    n_local = b * s
    r = route_on_mesh(x, router_w, top_k, capacity_factor, m)
    cap, fits, onehot_all = r["n_slots"], r["fits"], r["onehot_all"]

    # this rank's experts: dispatch and combine [T_l, E/ep, C]
    lo = m.ep_rank * e_local
    mine = r["onehot"][..., lo:lo + e_local]
    dispatch = (mine[..., None]
                * _one_hot(r["slot"], cap)[:, :, None, :]
                * fits[..., None, None]).sum(1)
    gates = copy_to_ep(r["gate_vals"], m.ep_group)
    combine = dispatch * (gates[:, :, None, None] * mine[..., None]).sum(1)

    ec = e_local * cap
    xin = copy_to_ep(x.reshape(n_local, d), m.ep_group)
    expert_in = sum_over_batch(dispatch.to(dtype).reshape(n_local, ec).t()
                               @ xin.to(dtype), m.batch_group)
    expert_in = copy_to_tp(expert_in.view(e_local, cap, d), m.tp_group)
    up = torch.bmm(expert_in, w_up.to(dtype))
    gate = torch.bmm(expert_in, w_gate.to(dtype))
    expert_out = reduce_from_tp(
        torch.bmm(F.silu(gate) * up, w_down.to(dtype)), m.tp_group)
    out = reduce_from_ep(combine.to(dtype).reshape(n_local, ec)
                         @ expert_out.reshape(ec, d), m.ep_group)

    # this rank's share of E * sum_e(mean_T prob_e * top-1 fraction_e):
    # its tokens' probs over the global T, the fraction global (no grad)
    share = r["probs"].mean(0) * (n_local / onehot_all.shape[0])
    aux_loss = e * torch.sum(share * onehot_all[:, 0, :].mean(0))
    metrics = {"moe_aux_loss": aux_loss,
               "moe_overflow": 1.0 - r["fits_all"].float().mean()}
    return out.reshape(b, s, d).to(dtype), metrics
