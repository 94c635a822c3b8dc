"""What every family's reference shares: sizes, the dense parameter layout,
the precision of the products, attention, the loss and AdamW as optax has
it."""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0      # the largest float8_e4m3fn


@dataclasses.dataclass(frozen=True)
class Dims:
    family: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    seq_len: int
    max_positions: int
    norm: str             # "layernorm" | "rmsnorm"
    norm_eps: float
    activation: str       # "gelu_tanh" | "swiglu"
    positions: str        # "learned" | "rope"
    rope_theta: float
    tie_embeddings: bool
    init_std: float
    z_loss: float
    token_ids_below: int


def leaves(d: Dims) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter, in the order they are drawn:
    the leaves outside the blocks first, then each block's, every block
    attention and a dense MLP (a family with other blocks lists its own,
    `families.leaves`). `init` is "normal" (std init_std), "resid"
    (init_std / sqrt(2 L)), "one" or "zero"."""
    D, f, hd = d.d_model, d.d_ff, d.head_dim
    out = [("tok_embed", (d.vocab, D), "normal"),
           ("norm_f", (D,), "one")]
    if d.positions == "learned":
        out.append(("pos_embed", (d.max_positions, D), "normal"))
    if d.norm == "layernorm":
        out.append(("bias_f", (D,), "zero"))
    if not d.tie_embeddings:
        out.append(("lm_head", (D, d.vocab), "normal"))
    for i in range(d.n_layers):
        p = f"blocks.{i}."
        out += [(p + "norm1", (D,), "one"), (p + "norm2", (D,), "one"),
                (p + "wq", (D, d.n_heads, hd), "normal"),
                (p + "wk", (D, d.n_kv_heads, hd), "normal"),
                (p + "wv", (D, d.n_kv_heads, hd), "normal"),
                (p + "wo", (d.n_heads, hd, D), "resid"),
                (p + "w_up", (D, f), "normal"),
                (p + "w_down", (f, D), "resid")]
        if d.activation == "swiglu":
            out.append((p + "w_gate", (D, f), "normal"))
        if d.norm == "layernorm":
            out += [(p + "bias1", (D,), "zero"), (p + "bias2", (D,), "zero")]
    return out


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude to 448), back in float32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands rounded to fp8; the backward's products
    round theirs too (the gradient and the saved operands)."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g)
        da = torch.matmul(qg, qb.transpose(-1, -2))
        db = torch.matmul(qa.transpose(-1, -2), qg)
        return _unbroadcast(da, qa.shape), _unbroadcast(db, qb.shape)


def _unbroadcast(g: torch.Tensor, shape) -> torch.Tensor:
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


@dataclasses.dataclass(frozen=True)
class Precision:
    """How the reference computes its products: "f32" (float32, TF32 off)
    or "fp8" (each operand rounded to float8 e4m3 first, the product in
    float32): the control, one step below the bf16 the program states."""
    name: str = "f32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return torch.matmul(a, b)
        if self.name == "fp8":
            return _Fp8Matmul.apply(a, b)
        raise ValueError(f"unknown precision {self.name!r}")


F32 = Precision("f32")


def proj(prec: Precision, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., d_in] @ w [d_in, *out] -> [..., *out]."""
    lead, d_in = x.shape[:-1], x.shape[-1]
    out = prec.mm(x.reshape(-1, d_in), w.reshape(d_in, -1))
    return out.reshape(*lead, *w.shape[1:])


def causal_attention(prec: Precision, q, k, v) -> torch.Tensor:
    """Softmax attention with the causal mask. q [B, S, H, hd], k and v
    [B, S, Hk, hd]; query head j reads key head j // (H / Hk)."""
    B, S, H, hd = q.shape
    group = H // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))       # [B, H, S, hd]
    s = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return prec.mm(p, v).transpose(1, 2)                    # [B, S, H, hd]


def norm(d: Dims, x, scale, bias=None):
    if d.norm == "rmsnorm":
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + d.norm_eps) \
            * scale
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).pow(2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + d.norm_eps) * scale + bias


def token_loss_sums(d: Dims, logits: torch.Tensor, tokens: torch.Tensor
                    ) -> torch.Tensor:
    """Sum over the rows' positions of the next-token cross entropy plus
    z_loss x the squared log-sum-exp; a row's final position has no target
    and is left out."""
    logits = logits[:, :-1]
    targets = tokens[:, 1:]
    lse = torch.logsumexp(logits, dim=-1)
    true = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - true).sum() + d.z_loss * lse.pow(2).sum()


Params = Dict[str, torch.Tensor]


def batch_loss_and_grads(model, d: Dims, params: Params, tokens: torch.Tensor,
                         prec: Precision, rows_per_block: int
                         ) -> Tuple[float, Params]:
    """The loss of the batch `tokens` [B, S] (the sum over every row's
    positions, divided by their count) and its gradient, accumulated over
    blocks of `rows_per_block` rows; each layer is recomputed in the
    backward (checkpointed), which leaves the numbers as they are."""
    B, S = tokens.shape
    count = B * (S - 1)
    leaves_ = {n: p.detach().requires_grad_() for n, p in params.items()}
    total = 0.0
    for lo in range(0, B, rows_per_block):
        rows = tokens[lo:lo + rows_per_block]
        loss = model.loss_sum(d, leaves_, rows, prec) / count
        loss.backward()
        total += float(loss.detach())
    return total, {n: p.grad for n, p in leaves_.items()}


def run_layers(d: Dims, block: Callable, x: torch.Tensor, params: Params,
               prec: Precision, positions: torch.Tensor) -> torch.Tensor:
    """Every block over x, each under a checkpoint when gradients are on."""
    for i in range(d.n_layers):
        p = {k[len(f"blocks.{i}."):]: v for k, v in params.items()
             if k.startswith(f"blocks.{i}.")}
        if torch.is_grad_enabled():
            x = checkpoint(block, d, p, x, prec, positions,
                           use_reentrant=False)
        else:
            x = block(d, p, x, prec, positions)
    return x


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's chain(clip_by_global_norm(grad_clip), adamw(lr, b1, b2, eps,
    weight_decay)) at a constant learning rate: the clip scales by
    grad_clip / norm where the norm reaches grad_clip; the bias corrections
    1 - b**count are computed in float32; eps lies outside the square root;
    the decay term is added to the update and scaled by lr with it."""
    learning_rate: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    grad_clip: float

    @classmethod
    def from_traffic(cls, opt: dict) -> "AdamW":
        if opt.get("schedule", "constant") != "constant":
            raise ValueError("the reference's AdamW keeps a constant rate")
        return cls(opt["learning_rate"], opt["b1"], opt["b2"], opt["eps"],
                   opt["weight_decay"], opt["grad_clip"])

    def clip(self, grads: Params) -> Params:
        g_norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads.values()))
        scale = 1.0 if float(g_norm) < self.grad_clip else \
            self.grad_clip / float(g_norm)
        return {n: g * scale for n, g in grads.items()}

    def update(self, params: Params, grads: Params, mu: Params, nu: Params,
               count: int) -> None:
        """One update, in place; `count` is the update's number, from 1."""
        c1 = float(torch.tensor(1.0) - torch.tensor(self.b1) ** count)
        c2 = float(torch.tensor(1.0) - torch.tensor(self.b2) ** count)
        for n, p in params.items():
            g = grads[n]
            mu[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (mu[n] / c1) / ((nu[n] / c2).sqrt() + self.eps)
            upd = upd + self.weight_decay * p
            p.sub_(self.learning_rate * upd)


def leaf_norms(tensors: Params) -> Dict[str, float]:
    return {n: float(t.float().norm()) for n, t in tensors.items()}


def train_steps(model, d: Dims, params: Params, batches: Sequence[torch.Tensor],
                opt: AdamW, prec: Precision = F32, rows_per_block: int = 1
                ) -> dict:
    """Train `params` (updated in place) for one step a batch: each step's
    loss, each leaf's norm of the first step's clipped gradient (what the
    optimizer takes in) and of its unclipped gradient."""
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], None
    for count, tokens in enumerate(batches, start=1):
        loss, grads = batch_loss_and_grads(model, d, params, tokens, prec,
                                           rows_per_block)
        grads = opt.clip(grads)
        if first is None:
            first = leaf_norms(grads)
        with torch.no_grad():
            opt.update(params, grads, mu, nu, count)
        del grads
        losses.append(loss)
    return {"losses": losses, "grad_norms": first}
