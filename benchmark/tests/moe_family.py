"""A model family for the tests alone: Mixtral's block (Jiang et al., 2024;
``MixtralForCausalLM``), with a sparse mixture of experts in every layer.
It is never a file of ``families/`` or ``reference/``: a test registers
this one module as both ``benchmark.families.moe_fixture`` and
``benchmark.reference.moe_fixture`` for its own duration, and adds a cell
of it to a temporary checkout, to show that a family whose blocks the
dense layout cannot describe joins the benchmark as new files.

Family: ``dims`` (a `Dims` with the experts), ``TINY``/``TINY_ASSUMED``,
and the three functions `benchmark.families` looks up: ``leaves`` (the
port's MoE names and shapes), ``port_kwargs`` (the port's experts, with
every token kept) and ``train_flops_per_token`` (the active experts).

Reference, in float32 as the other families' (products through `prec`):

- ``h = RMSNorm(x)``, Mistral's grouped-query attention with half-split
  RoPE, ``x += attn``;
- ``h = RMSNorm(x)``; ``p = softmax(h @ W_r)``; ``(g, idx) = top-k(p)``;
  ``g = g / sum(g)``;
- ``x += sum_j g_j W_down[idx_j](silu(W_gate[idx_j] h) * W_up[idx_j] h)``,

as ``MixtralSparseMoeBlock`` computes it, with no jitter. Departures, both
the port's: RMSNorm's eps is 1e-6, and no load-balance loss is trained
(the port's Switch loss counts each token's first choice, Mixtral's all k).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from benchmark.reference.common import (Dims, Precision, causal_attention,
                                        norm, proj, run_layers,
                                        token_loss_sums)
from benchmark.reference.mistral import rope

NAME = "moe_fixture"

# Mixtral-8x7B-v0.1's config.json as the fixture runs it (model_type the
# fixture's name; the two departures above)
CONFIG = {
    "source": "https://huggingface.co/mistralai/Mixtral-8x7B-v0.1/blob/main/config.json",
    "architectures": ["MixtralForCausalLM"],
    "hidden_act": "silu",
    "hidden_size": 4096,
    "initializer_range": 0.02,
    "intermediate_size": 14336,
    "max_position_embeddings": 32768,
    "model_type": NAME,
    "num_attention_heads": 32,
    "num_experts_per_tok": 2,
    "num_hidden_layers": 32,
    "num_key_value_heads": 8,
    "num_local_experts": 8,
    "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0,
    "router_aux_loss_coef": 0.0,
    "router_jitter_noise": 0.0,
    "sliding_window": None,
    "tie_word_embeddings": False,
    "vocab_size": 32000,
    "reduced": ["rms_norm_eps", "router_aux_loss_coef"],
    "published": {"rms_norm_eps": 1e-05, "router_aux_loss_coef": 0.02},
    "assumed": {"seq_len": 4096, "train_batch": 1, "token_ids_below": 32000,
                "z_loss": 0.0},
}

# the CPU tests' size: 4 experts, 2 a token
TINY = dict(hidden_size=64, intermediate_size=96, num_attention_heads=4,
            num_key_value_heads=2, num_hidden_layers=2, vocab_size=256,
            num_local_experts=4, num_experts_per_tok=2)
TINY_ASSUMED = dict(seq_len=64, train_batch=4, token_ids_below=256)


@dataclasses.dataclass(frozen=True)
class MoEDims(Dims):
    n_experts: int
    top_k: int


def dims(c: dict) -> MoEDims:
    a = c["assumed"]
    if c["hidden_act"] != "silu":
        raise ValueError(f"hidden_act {c['hidden_act']!r}: SwiGLU is silu")
    if c["router_aux_loss_coef"] or c["router_jitter_noise"]:
        raise ValueError("the port trains no Mixtral load-balance loss and "
                         "no router jitter: both must be 0")
    window = c.get("sliding_window")
    if window is not None and window < a["seq_len"]:
        raise ValueError(f"sliding_window {window} is shorter than seq_len")
    return MoEDims(family=NAME, d_model=c["hidden_size"],
                   n_layers=c["num_hidden_layers"],
                   n_heads=c["num_attention_heads"],
                   n_kv_heads=c["num_key_value_heads"],
                   head_dim=c["hidden_size"] // c["num_attention_heads"],
                   d_ff=c["intermediate_size"], vocab=c["vocab_size"],
                   seq_len=a["seq_len"], max_positions=a["seq_len"],
                   norm="rmsnorm", norm_eps=c["rms_norm_eps"],
                   activation="swiglu", positions="rope",
                   rope_theta=c["rope_theta"],
                   tie_embeddings=c["tie_word_embeddings"],
                   init_std=c["initializer_range"], z_loss=a["z_loss"],
                   token_ids_below=a["token_ids_below"],
                   n_experts=c["num_local_experts"],
                   top_k=c["num_experts_per_tok"])


def leaves(d: MoEDims):
    D, f, hd, E = d.d_model, d.d_ff, d.head_dim, d.n_experts
    out = [("tok_embed", (d.vocab, D), "normal"), ("norm_f", (D,), "one"),
           ("lm_head", (D, d.vocab), "normal")]
    for i in range(d.n_layers):
        p = f"blocks.{i}."
        out += [(p + "norm1", (D,), "one"), (p + "norm2", (D,), "one"),
                (p + "wq", (D, d.n_heads, hd), "normal"),
                (p + "wk", (D, d.n_kv_heads, hd), "normal"),
                (p + "wv", (D, d.n_kv_heads, hd), "normal"),
                (p + "wo", (d.n_heads, hd, D), "resid"),
                (p + "router", (D, E), "normal"),
                (p + "w_up", (E, D, f), "normal"),
                (p + "w_gate", (E, D, f), "normal"),
                (p + "w_down", (E, f, D), "resid")]
    return out


def port_kwargs(d: MoEDims) -> dict:
    """The port's experts; a capacity factor of E / k gives each expert a
    slot for every token, so none is dropped (Mixtral drops none)."""
    return {"n_experts": d.n_experts, "moe_top_k": d.top_k,
            "moe_capacity_factor": d.n_experts / d.top_k,
            "moe_aux_coeff": 0.0}


def train_flops_per_token(d: MoEDims, seq: int) -> float:
    """6 N_active + 12 L d S + 6 d V: N_active counts attention, the router
    and the k experts a token runs through, of the E each layer holds."""
    D, hd = d.d_model, d.head_dim
    attn = D * d.n_heads * hd + 2 * D * d.n_kv_heads * hd + d.n_heads * hd * D
    active = attn + D * d.n_experts + d.top_k * 3 * D * d.d_ff
    return (6.0 * d.n_layers * active + 12.0 * d.n_layers * D * seq
            + 6.0 * D * d.vocab)


# -- the reference -----------------------------------------------------------

def moe(d: MoEDims, p, h, prec: Precision):
    """h [B, S, D] -> the experts' sum: each token through its top-k
    experts, weighted by its renormalised router probabilities."""
    x = h.reshape(-1, d.d_model)
    probs = torch.softmax(prec.mm(x, p["router"]), dim=-1)
    gate, idx = torch.topk(probs, d.top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(d.n_experts):
        token, j = torch.where(idx == e)
        xe = x[token]
        act = F.silu(prec.mm(xe, p["w_gate"][e])) * prec.mm(xe, p["w_up"][e])
        out = out.index_add(0, token,
                            prec.mm(act, p["w_down"][e]) * gate[token, j, None])
    return out.reshape(h.shape)


def block(d: MoEDims, p, x, prec: Precision, positions):
    h = norm(d, x, p["norm1"])
    q, k, v = (proj(prec, h, p[w]) for w in ("wq", "wk", "wv"))
    q, k = rope(d, q, positions), rope(d, k, positions)
    a = causal_attention(prec, q, k, v).reshape(*x.shape[:2], -1)
    x = x + proj(prec, a, p["wo"].reshape(-1, d.d_model))
    return x + moe(d, p, norm(d, x, p["norm2"]), prec)


def hidden(d: MoEDims, params, tokens, prec: Precision):
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = run_layers(d, block, params["tok_embed"][tokens], params, prec,
                   positions)
    return norm(d, x, params["norm_f"])


def head(d: MoEDims, params, h, prec: Precision):
    return proj(prec, h, params["lm_head"])


def loss_sum(d: MoEDims, params, tokens, prec: Precision):
    return token_loss_sums(d, head(d, params, hidden(d, params, tokens, prec),
                                   prec), tokens)
