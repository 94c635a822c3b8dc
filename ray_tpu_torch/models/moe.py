"""Mixture-of-experts FFN on one device.

Counterpart of ``ray_tpu/models/moe.py``: top-k routing with
capacity-bounded dense dispatch. Token -> (expert, slot) assignment becomes
one-hot dispatch and combine tensors, and the expert work three batched
products over a leading expert axis. Expert parallelism (the ``ep`` mesh
axis) is not ported yet.

The products without a batch dimension (router, dispatch, combine) run as
2-D ``torch.mm``, the per-expert ones as ``torch.bmm``: the model's "dots"
checkpoint policy saves exactly the ``aten.mm`` outputs, as JAX's
``dots_with_no_batch_dims_saveable`` saves those three products and
recomputes the per-expert ones.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


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

    # slot of each (token, k) in its expert's buffer; priority: every k=0
    # choice first, then k=1, each in token order
    onehot = _one_hot(expert_idx, e)                              # [T, K, E]
    flat = onehot.transpose(0, 1).reshape(top_k * n_tokens, e)
    pos = torch.cumsum(flat, dim=0) - flat                        # [K*T, E]
    pos = pos.reshape(top_k, n_tokens, e).transpose(0, 1)         # [T, K, E]
    slot = (pos * onehot).sum(-1)                                 # [T, K]
    fits = slot < n_slots
    return {"probs": probs, "gate_vals": gate_vals * fits,   # drop overflow
            "expert_idx": expert_idx, "onehot": onehot, "slot": slot,
            "fits": fits}


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_up: torch.Tensor,
            w_gate: torch.Tensor, w_down: torch.Tensor, *, top_k: int = 2,
            capacity_factor: float = 1.25, dtype=torch.bfloat16
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, D]; router_w: [D, E]; w_up/w_gate: [E, D, F];
    w_down: [E, F, D] -> ([B, S, D] in `dtype`, {"moe_aux_loss",
    "moe_overflow"}), the Switch load-balance loss and the dropped share
    of the (token, k) choices."""
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
