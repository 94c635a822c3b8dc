"""The yardstick's arithmetic: peaks, operations per token, a kernel's
least time. Frozen copies, so that a later change to the program cannot
move them.

The peaks and `live_scores`/`bound_s` copy ``chip_smoke.py``'s
``MFU_PEAK``, ``PEAK_BYTES``, ``live_scores`` and ``bound_ms``; the train
operations per token copy the formula of ``PERF.md`` section 2 (the port's
``flops_per_token``), with S the cell's own sequence length.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..reference.common import Dims

# dense bf16 peak by card (NVIDIA's data sheets, dense, full power limit),
# matched by the first name that the card's name contains
PEAK_FLOPS = (("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("H100", 989e12),
              ("H200", 989e12))
PEAK_BYTES = 3.35e12          # H100 SXM HBM3, bytes/s


def peak_flops(kind: str) -> Optional[float]:
    return next((v for k, v in PEAK_FLOPS if k in kind), None)


def non_embedding_params(d: Dims) -> int:
    D, f, hd = d.d_model, d.d_ff, d.head_dim
    attn = D * d.n_heads * hd + 2 * D * d.n_kv_heads * hd + d.n_heads * hd * D
    mlp = (3 if d.activation == "swiglu" else 2) * D * f
    return d.n_layers * (attn + mlp)


def train_flops_per_token(d: Dims, seq: int) -> float:
    """6 N (non-embedding) + 12 L d S + 6 d V: forward and backward, the
    head counted, recomputation not; every layer attention and a dense MLP
    (a family with other layers counts its own, which `roofline.mfu`
    reads in place of this)."""
    return (6.0 * non_embedding_params(d) + 12.0 * d.n_layers * d.d_model * seq
            + 6.0 * d.d_model * d.vocab)


def live_scores(q_len: int, k_len: int, causal: bool) -> int:
    """(query, key) pairs the mask leaves, per (batch, head)."""
    if not causal:
        return q_len * k_len
    off = k_len - q_len
    if off == 0:
        return q_len * (q_len + 1) // 2
    return sum(min(k_len, max(0, i + off + 1)) for i in range(q_len))


def bound_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """The least time on an H100 SXM: the larger of operations over the
    bf16 peak and bytes over the HBM bandwidth."""
    t_ops, t_bytes = flops / 989e12, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def attention_work(B: int, H: int, Hk: int, Sq: int, Sk: int, D: int,
                   elem: int, causal: bool = True, backward: bool = False
                   ) -> Tuple[float, float]:
    """(operations, bytes) of causal attention's forward, or of its whole
    backward (dQ and dK/dV together): each input read once, each output
    written once, lse and delta as f32 rows. The backward's operations are
    the function's own, 2 D a live (query, key) pair for each of S, dV, dP,
    dQ and dK: a kernel split that computes S or dP twice does more work,
    not more of the function."""
    live = B * H * live_scores(Sq, Sk, causal)
    qb, kb = B * H * Sq * D * elem, B * Hk * Sk * D * elem
    rows = B * H * Sq * 4
    if not backward:
        return 4.0 * D * live, 2 * qb + 2 * kb + rows
    # inputs q, k, v, dO, lse, delta; outputs dQ, dK, dV
    return 10.0 * D * live, 3 * qb + 4 * kb + 2 * rows
