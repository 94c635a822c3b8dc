"""GPT-2 (Radford et al., 2019; ``GPT2LMHeadModel``) in float32: learned
positions, pre-LayerNorm blocks of multi-head causal attention and a
tanh-GELU MLP of width 4d, a final LayerNorm, the head tied to the token
embedding. As the configuration states it runs: no dropout, no bias on the
projections (see its ``departures``)."""

from __future__ import annotations

import math

import torch

from .common import Dims, Precision, causal_attention, norm, proj, \
    run_layers, token_loss_sums


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                      * (x + 0.044715 * x.pow(3))))


def block(d: Dims, p, x, prec: Precision, positions):
    h = norm(d, x, p["norm1"], p["bias1"])
    q, k, v = (proj(prec, h, p[w]) for w in ("wq", "wk", "wv"))
    a = causal_attention(prec, q, k, v).reshape(*x.shape[:2], -1)
    x = x + proj(prec, a, p["wo"].reshape(-1, d.d_model))
    h = norm(d, x, p["norm2"], p["bias2"])
    return x + proj(prec, gelu_tanh(proj(prec, h, p["w_up"])), p["w_down"])


def hidden(d: Dims, params, tokens, prec: Precision):
    """tokens [B, S] -> the final LayerNorm's output [B, S, d]."""
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = params["tok_embed"][tokens] + params["pos_embed"][positions]
    x = run_layers(d, block, x, params, prec, positions)
    return norm(d, x, params["norm_f"], params["bias_f"])


def head(d: Dims, params, h, prec: Precision):
    return proj(prec, h, params["tok_embed"].t())


def loss_sum(d: Dims, params, tokens, prec: Precision):
    return token_loss_sums(d, head(d, params, hidden(d, params, tokens, prec),
                                   prec), tokens)

