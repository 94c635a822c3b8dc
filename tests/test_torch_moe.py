"""Port parity: ray_tpu_torch's mixture-of-experts FFN against the JAX one.

The same seeded numpy inputs go through ``ray_tpu.models.moe.moe_ffn`` and
``ray_tpu_torch.models.moe.moe_ffn``: outputs, the load-balance loss, the
overflow share and the gradients. Then the model's "dots" checkpoint policy
with experts: the products without a batch dimension are saved, the
per-expert ones recomputed, as JAX's ``dots_with_no_batch_dims_saveable``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models.moe import moe_ffn as jax_moe_ffn
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import moe_ffn
from ray_tpu_torch.models.moe import route

torch.set_num_threads(2)

F32_ATOL = 1e-5   # f32 on both sides, sums in another order
AUX_ATOL = 1e-6   # load-balance loss and overflow share, O(1) and O(0.1)
# bf16 products on both sides, rounded at other places (XLA fuses the
# casts): the outputs reach 0.62, where the bf16 spacing is 2**-8; two of
# those (the largest reading is one)
BF16_ATOL = 8e-3
GRAD_ATOL = 1e-5  # f32 gradients, O(0.1) or smaller

E, D, FF = 4, 32, 48

# name -> (batch, seq, top_k, capacity_factor, zero router)
CASES = {
    "top2": (2, 32, 2, 1.25, False),
    "top1": (2, 32, 1, 1.25, False),
    "overflow": (2, 32, 2, 0.5, False),
    "zero_router_ties": (2, 32, 2, 0.75, True),
    # 74 tokens: capacity int(1.25 * 2 * 74 / 4) = int(46.25) = 46
    "ragged_tokens": (2, 37, 2, 1.25, False),
}


def _inputs(b, s, zero_router, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    router = rng.standard_normal((D, E)).astype(np.float32) * 0.3
    if zero_router:
        router[:] = 0.0
    w_up = rng.standard_normal((E, D, FF)).astype(np.float32) * 0.1
    w_gate = rng.standard_normal((E, D, FF)).astype(np.float32) * 0.1
    w_down = rng.standard_normal((E, FF, D)).astype(np.float32) * 0.1
    return x, router, w_up, w_gate, w_down


def _both(arrays, top_k, cf, bf16=False):
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16 else
                (jnp.float32, torch.float32))
    x, *w = arrays
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    jout, jm = jax_moe_ffn(jx, *map(jnp.asarray, w), top_k=top_k,
                           capacity_factor=cf, dtype=jdt)
    tout, tm = moe_ffn(tx, *map(torch.from_numpy, w), top_k=top_k,
                       capacity_factor=cf, dtype=tdt)
    return (np.asarray(jout.astype(jnp.float32)), jm,
            tout.float().numpy(), tm)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax_f32(case):
    b, s, k, cf, zero = CASES[case]
    jout, jm, tout, tm = _both(_inputs(b, s, zero), k, cf)
    assert tout.shape == (b, s, D)
    np.testing.assert_allclose(tout, jout, atol=F32_ATOL, rtol=0)
    for key in ("moe_aux_loss", "moe_overflow"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   atol=AUX_ATOL, rtol=0)
    if case in ("overflow", "zero_router_ties"):
        assert float(tm["moe_overflow"]) > 0.1


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax_bf16(case):
    b, s, k, cf, zero = CASES[case]
    jout, jm, tout, tm = _both(_inputs(b, s, zero), k, cf, bf16=True)
    np.testing.assert_allclose(tout, jout, atol=BF16_ATOL, rtol=0)
    for key in ("moe_aux_loss", "moe_overflow"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   atol=AUX_ATOL, rtol=0)


def test_zero_router_takes_the_lowest_experts():
    """Every probability ties at 1/E: jax.lax.top_k takes experts 0..k-1
    for every token, and so must the port; the k=0 choices fill expert 0
    first, in token order, before any k=1 choice."""
    x, router, *_ = _inputs(1, 20, zero_router=True)
    r = route(torch.from_numpy(x[0]), torch.from_numpy(router), top_k=2,
              n_slots=12)
    assert (r["expert_idx"] == torch.tensor([0, 1])).all()
    slots = torch.arange(20, dtype=torch.float32)
    torch.testing.assert_close(r["slot"], torch.stack([slots, slots], 1))
    assert r["fits"][:12].all() and not r["fits"][12:].any()
    torch.testing.assert_close(r["gate_vals"][:12], torch.full((12, 2), 0.5))
    assert (r["gate_vals"][12:] == 0).all()


@pytest.mark.parametrize("case", ["top2", "overflow", "ragged_tokens"])
def test_moe_ffn_grads_match_jax(case):
    """d/d(x, router, w_up, w_gate, w_down) of sum(out * ct) + aux, f32."""
    b, s, k, cf, zero = CASES[case]
    arrays = _inputs(b, s, zero)
    ct = np.random.default_rng(5).standard_normal((b, s, D)).astype(
        np.float32)

    def jloss(*args):
        out, m = jax_moe_ffn(*args, top_k=k, capacity_factor=cf,
                             dtype=jnp.float32)
        return (out * ct).sum() + m["moe_aux_loss"]

    jgrads = jax.grad(jloss, argnums=tuple(range(5)))(
        *map(jnp.asarray, arrays))
    targs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out, m = moe_ffn(*targs, top_k=k, capacity_factor=cf,
                     dtype=torch.float32)
    ((out * torch.from_numpy(ct)).sum() + m["moe_aux_loss"]).backward()
    for name, jg, t in zip(("x", "router", "w_up", "w_gate", "w_down"),
                           jgrads, targs):
        assert np.abs(np.asarray(jg)).max() > 0, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def _products(cfg, toks):
    """aten.mm / aten.bmm counts of the forward and of the backward."""
    model = tgpt.GPT(cfg, device="cpu", seed=0)
    fwd, bwd = _CountProducts(), _CountProducts()
    with fwd:
        loss, _ = model.loss({"tokens": toks})
    with bwd:
        loss.backward()
    return fwd.counts, bwd.counts


def test_dots_policy_saves_router_dispatch_and_combine():
    """With experts, a block's forward runs 7 aten.mm (wq, wk, wv, wo,
    router, dispatch, combine) and the per-expert products as aten.bmm.
    "dots" recomputes no mm in the backward, "full" recomputes all of them,
    and both recompute every bmm."""
    cfg = tgpt.llama_tiny(dtype=torch.float32, n_experts=4, remat=False)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16))).long()
    L = cfg.n_layers
    fwd, off = _products(cfg, toks)
    _, full = _products(dataclasses.replace(cfg, remat=True,
                                            remat_policy="full"), toks)
    _, dots = _products(dataclasses.replace(cfg, remat=True,
                                            remat_policy="dots"), toks)
    assert fwd["mm"] == 7 * L + 1                        # + the lm head
    block_bmm = fwd["bmm"] // L
    assert block_bmm >= 3                                # up, gate, down
    assert dots["mm"] == off["mm"]
    assert full["mm"] == off["mm"] + 7 * L
    assert dots["bmm"] == full["bmm"] == off["bmm"] + block_bmm * L
