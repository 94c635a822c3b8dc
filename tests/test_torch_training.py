"""Port parity: ray_tpu_torch's train step against the JAX train step.

Same JAX-initialised params, same batch, f32 on both sides: the loss and
grad-norm trajectories over 8 steps of clipped AdamW with warmup-cosine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import training as jtrain
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import training as ttrain
from ray_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(2)

# Per-step relative tolerance of the trajectory: f32 on both sides, but
# eight updates through Adam's 1/sqrt(nu) amplify sums taken in another
# order.
TRAJ_RTOL = 2e-4


def _setup(**model_kw):
    jc = jgpt.llama_tiny(dtype=jnp.float32, attention_impl="reference",
                         **model_kw)
    tc = tgpt.llama_tiny(dtype=torch.float32, **model_kw)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50)
    jm = jgpt.GPT(jc)
    jopt = jtrain.make_optimizer(**kw)
    jstate = jtrain.init_train_state(jm, jopt, jax.random.PRNGKey(0))
    tm = tgpt.GPT(tc, device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params), tc))
    topt = ttrain.make_optimizer(**kw)
    tstate = ttrain.init_train_state(tm, topt, device="cpu")
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 64),
                                             dtype=np.int32)
    return jm, jopt, jstate, tm, topt, tstate, toks


def _trajectories(**model_kw):
    """8 steps of both train steps from the same params: checks the loss,
    grad-norm (and aux-loss) trajectories and returns the final params,
    the port's and JAX's mapped to the port's names."""
    jm, jopt, jstate, tm, topt, tstate, toks = _setup(**model_kw)
    jstep = jtrain.make_train_step(jm, jopt, donate=False)
    tstep = ttrain.make_train_step(tm, topt, device="cpu")
    jbatch = {"tokens": jnp.asarray(toks)}
    tbatch = {"tokens": torch.from_numpy(toks).long()}
    p0 = {n: p.detach().clone() for n, p in tstate.params.items()}
    jl, tl, jg, tg = [], [], [], []
    for i in range(8):
        jstate, jm_ = jstep(jstate, jbatch)
        tstate, tm_ = tstep(tstate, tbatch)
        jl.append(float(jm_["loss"]))
        tl.append(float(tm_["loss"]))
        jg.append(float(jm_["grad_norm"]))
        tg.append(float(tm_["grad_norm"]))
        assert set(tm_) == set(jm_)
        if "moe_aux_loss" in jm_:
            np.testing.assert_allclose(float(tm_["moe_aux_loss"]),
                                       float(jm_["moe_aux_loss"]),
                                       rtol=TRAJ_RTOL)
        if i == 0:
            # the schedule is read at count 0: the first update has lr = 0
            for n, p in tstate.params.items():
                torch.testing.assert_close(p, p0[n], atol=0, rtol=0)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_RTOL)
    np.testing.assert_allclose(tg, jg, rtol=TRAJ_RTOL)
    assert tl[-1] < tl[0]
    assert tstate.step == 8 and int(jstate.step) == 8
    jp = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                         tm.config)
    return {n: p.detach() for n, p in tstate.params.items()}, jp


def test_trajectory_matches_jax():
    params, jp = _trajectories()
    # params after 8 steps agree too
    for n, p in params.items():
        np.testing.assert_allclose(p.numpy(), jp[n].numpy(),
                                   atol=1e-5, rtol=1e-3)


def test_moe_trajectory_matches_jax():
    """The same 8 steps with the mixture-of-experts FFN (4 experts, top-2):
    the aux loss enters the loss and rides along in the metrics. The params
    after 8 steps are held per leaf, normwise (largest reading 4.9e-6): an
    expert weight whose gradient sits at rounding level gets a full Adam
    step of either sign (m / sqrt(v)), which moved one element of 262144
    by 2.6e-5."""
    params, jp = _trajectories(n_experts=4, moe_top_k=2)
    for n, p in params.items():
        assert (p - jp[n]).norm() <= 2e-5 * jp[n].norm(), n


def _update_before_chunking(opt, params, grads, state):
    """`Optimizer.update_` as it was written with whole-model temporaries:
    the plain version that the chunked, in-place update must equal bit for
    bit."""
    names = list(params)
    p = [params[n] for n in names]
    mu = [state["mu"][n] for n in names]
    nu = [state["nu"][n] for n in names]
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = torch.where(g_norm < opt.grad_clip, torch.ones_like(g_norm),
                       opt.grad_clip / g_norm)
    g = torch._foreach_mul(grads, clip)
    count = state["count"] + 1
    torch._foreach_lerp_(mu, g, 1 - opt.b1)
    torch._foreach_mul_(nu, opt.b2)
    torch._foreach_addcmul_(nu, g, g, value=1 - opt.b2)
    # the bias corrections as optax computes them, in f32
    mu_hat = torch._foreach_div(mu, ttrain._bias_correction(opt.b1, count))
    denom = torch._foreach_div(nu, ttrain._bias_correction(opt.b2, count))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, opt.eps)
    upd = torch._foreach_div(mu_hat, denom)
    if opt.weight_decay:
        torch._foreach_add_(upd, p, alpha=opt.weight_decay)
    lr = opt.lr(state["count"])
    if lr:
        torch._foreach_add_(p, upd, alpha=-lr)
    state["count"] = count
    return g_norm


@pytest.mark.parametrize("chunk_numel", [1 << 26, 250, 1])
def test_chunked_update_is_bit_identical(chunk_numel, monkeypatch):
    """One chunk, chunks of several tensors, one tensor a chunk: params,
    moments and the norm equal the whole-model formula exactly over five
    updates, below and above the clip threshold."""
    monkeypatch.setattr(ttrain, "_CHUNK_NUMEL", chunk_numel)
    rng = np.random.default_rng(0)
    shapes = [(40, 30), (7,), (5, 6, 7), (300,), (2, 2)]
    opt = ttrain.make_optimizer(learning_rate=1e-2, warmup_steps=1,
                                total_steps=10)
    new = {f"p{i}": torch.tensor(rng.standard_normal(s).astype(np.float32))
           for i, s in enumerate(shapes)}
    old = {n: t.clone() for n, t in new.items()}
    s_new, s_old = opt.init(new), opt.init(old)
    for step in range(5):
        grads = [torch.tensor((rng.standard_normal(s)
                               * (0.1 if step % 2 else 10.0)
                               ).astype(np.float32)) for s in shapes]
        n_old = _update_before_chunking(opt, old, [g.clone() for g in grads],
                                        s_old)
        n_new = opt.update_(new, [g.clone() for g in grads], s_new)
        assert torch.equal(n_new, n_old)
    for n in new:
        assert torch.equal(new[n], old[n]), n
        assert torch.equal(s_new["mu"][n], s_old["mu"][n]), n
        assert torch.equal(s_new["nu"][n], s_old["nu"][n]), n
    assert s_new["count"] == s_old["count"] == 5
    if chunk_numel == 250:   # (7,) and (5, 6, 7) share a chunk
        assert (1, 3) in ttrain._chunks(list(new.values()))


@pytest.mark.parametrize("kw", [
    dict(learning_rate=1e-3, warmup_steps=2, total_steps=50),
    dict(learning_rate=3e-4, warmup_steps=100, total_steps=10000),
    dict(learning_rate=1e-3, warmup_steps=5, total_steps=3),
    dict(learning_rate=1e-3, warmup_steps=0, total_steps=20),
])
def test_schedule_matches_optax(kw):
    sched = optax.warmup_cosine_decay_schedule(
        0.0, kw["learning_rate"], kw["warmup_steps"],
        max(kw["total_steps"], kw["warmup_steps"] + 1),
        kw["learning_rate"] * 0.1)
    opt = ttrain.make_optimizer(**kw)
    for count in (0, 1, 2, 3, 5, 50, 99, 100, 101, 5000, 10000, 20000):
        np.testing.assert_allclose(opt.lr(count), float(sched(count)),
                                   rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_update_matches_optax_chain(scale):
    """One update of clip_by_global_norm + adamw on random tensors, below
    and above the clip threshold (no epsilon in optax's clip factor)."""
    rng = np.random.default_rng(0)
    params = {f"p{i}": rng.standard_normal(s).astype(np.float32)
              for i, s in enumerate([(4, 3), (5,), (2, 2, 2)])}
    grads = {n: (rng.standard_normal(p.shape) * scale).astype(np.float32)
             for n, p in params.items()}
    kw = dict(learning_rate=1e-2, warmup_steps=0, total_steps=10)
    jopt = jtrain.make_optimizer(**kw)
    jstate = jopt.init(params)
    tp = {n: torch.tensor(p) for n, p in params.items()}
    topt = ttrain.make_optimizer(**kw)
    tstate = topt.init(tp)
    jp = params
    for _ in range(3):
        upd, jstate = jopt.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        norm = topt.update_(tp, [torch.tensor(grads[n]) for n in tp], tstate)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                               rtol=1e-6)
    for n in params:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-5, atol=1e-7)


def test_eval_step_and_flops_per_token():
    _, _, _, tm, _, _, toks = _setup()
    metrics = ttrain.eval_step_fn(tm, device="cpu")(
        {"tokens": torch.from_numpy(toks).long()})
    assert np.isfinite(float(metrics["loss"]))
    for name in ("gpt2_small", "gpt2_medium", "llama_tiny", "llama_1b",
                 "llama_7b"):
        assert ttrain.flops_per_token(getattr(tgpt, name)()) == \
            jtrain.flops_per_token(getattr(jgpt, name)())
