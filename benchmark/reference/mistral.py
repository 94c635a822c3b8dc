"""Mistral-7B (Jiang et al., 2023; ``MistralForCausalLM``) in float32:
pre-RMSNorm blocks of grouped-query causal attention with half-split RoPE
(``rotate_half``, theta rope_theta) and a SwiGLU MLP, a final RMSNorm, an
untied head. The sliding window covers the whole sequence at the
configuration's length (the family module refuses one that does not), so
the mask is the causal one."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import Dims, Precision, causal_attention, norm, proj, \
    run_layers, token_loss_sums


def rope(d: Dims, x, positions):
    """x [B, S, H, hd]: (x1, x2) -> (x1 cos - x2 sin, x1 sin + x2 cos),
    frequencies theta^(-2i / hd)."""
    half = x.shape[-1] // 2
    freqs = d.rope_theta ** (-torch.arange(half, dtype=torch.float32,
                                           device=x.device) * 2 / x.shape[-1])
    ang = positions[:, None].float() * freqs             # [S, half]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def block(d: Dims, p, x, prec: Precision, positions):
    h = norm(d, x, p["norm1"])
    q, k, v = (proj(prec, h, p[w]) for w in ("wq", "wk", "wv"))
    q, k = rope(d, q, positions), rope(d, k, positions)
    a = causal_attention(prec, q, k, v).reshape(*x.shape[:2], -1)
    x = x + proj(prec, a, p["wo"].reshape(-1, d.d_model))
    h = norm(d, x, p["norm2"])
    act = F.silu(proj(prec, h, p["w_gate"])) * proj(prec, h, p["w_up"])
    return x + proj(prec, act, p["w_down"])


def hidden(d: Dims, params, tokens, prec: Precision):
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = params["tok_embed"][tokens]
    x = run_layers(d, block, x, params, prec, positions)
    return norm(d, x, params["norm_f"])


def head(d: Dims, params, h, prec: Precision):
    return proj(prec, h, params["lm_head"])


def loss_sum(d: Dims, params, tokens, prec: Precision):
    return token_loss_sums(d, head(d, params, hidden(d, params, tokens, prec),
                                   prec), tokens)

