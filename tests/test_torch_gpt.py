"""Port parity: ray_tpu_torch's GPT against the JAX model.

JAX-initialised params go through `params_from_jax` into the port; logits
and losses are compared on the same tokens. The JAX model runs its Pallas
attention under the interpreter; the port runs its kernels' plain versions
(CPU tensors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.parallel import AXIS_ORDER, Mesh, MeshSpec

torch.set_num_threads(2)

F32_ATOL = 1e-4   # f32 on both sides; sums in another order
GRAD_ATOL = 1e-6  # f32 gradients, whose largest entries are ~0.05
# bf16 activations: both round the residual stream, projections and norms
# to bf16, at different places inside fused ops; logits are O(1), whose
# bf16 spacing is 2**-7, so allow a few of those.
BF16_ATOL = 3e-2

# tests/test_models.py:36, the GPT-2 family at test scale
GPT2_FAMILY = dict(vocab_size=512, n_layers=2, d_model=128, n_heads=4,
                   max_seq_len=128, activation="gelu", norm="layernorm",
                   positions="learned", tie_embeddings=True)


# the mixture-of-experts block (tests/test_models_parallel.py:32)
MOE = dict(n_experts=4, moe_top_k=2)
# a family at an unaligned vocabulary: 500 = 7 x 64 + 52 head rows, which
# the port's head pads to 512 in its working copy
V500 = "_v500"
FAMILIES = ["llama_tiny", "gpt2_family", "llama_tiny_moe",
            "gpt2_family" + V500]


def _configs(family, f32, **kw):
    jdt = jnp.float32 if f32 else jnp.bfloat16
    tdt = torch.float32 if f32 else torch.bfloat16
    vocab = {}
    if family.endswith(V500):
        family, vocab = family[:-len(V500)], dict(vocab_size=500)
    if family == "llama_tiny_moe":
        family, kw = "llama_tiny", {**MOE, **kw}
    if family == "llama_tiny":
        return (dataclasses.replace(jgpt.llama_tiny(
                    dtype=jdt, attention_impl="pallas_interpret", **kw),
                    **vocab),
                dataclasses.replace(tgpt.llama_tiny(dtype=tdt, **kw),
                                    **vocab))
    kw = {**GPT2_FAMILY, **vocab, **kw}
    return (jgpt.GPTConfig(dtype=jdt, attention_impl="pallas_interpret",
                           **kw),
            tgpt.GPTConfig(dtype=tdt, **kw))


def _pair(family, f32=True, **kw):
    jc, tc = _configs(family, f32, remat=False, **kw)
    jm = jgpt.GPT(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tm = tgpt.GPT(tc, device="cpu")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tc))
    return jm, params, tm


def _tokens(b=2, s=64, vocab=512, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_jax_f32(family):
    jm, params, tm = _pair(family)
    toks = _tokens(vocab=tm.config.vocab_size)
    j = np.asarray(jm.apply(params, jnp.asarray(toks)))
    t = tm.apply(torch.from_numpy(toks).long())
    assert t.dtype == torch.float32
    assert t.shape == (2, 64, tm.config.vocab_size)
    np.testing.assert_allclose(t.detach().numpy(), j, atol=F32_ATOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_jax_bf16(family):
    jm, params, tm = _pair(family, f32=False)
    toks = _tokens(vocab=tm.config.vocab_size)
    j = np.asarray(jm.apply(params, jnp.asarray(toks)))
    t = tm.apply(torch.from_numpy(toks).long())
    assert t.dtype == torch.float32   # logits come back f32 (gpt.py:493)
    np.testing.assert_allclose(t.detach().numpy(), j, atol=BF16_ATOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_matches_jax(family):
    """Next-token NLL + z-loss 1e-4, last position masked, loss_mask applied,
    plus 0.01 x the MoE load-balance loss with experts (gpt.py:559-594)."""
    jm, params, tm = _pair(family)
    toks = _tokens(vocab=tm.config.vocab_size)
    mask = (np.random.default_rng(2).random(toks.shape) > 0.3
            ).astype(np.float32)
    for batch in ({"tokens": toks}, {"tokens": toks, "loss_mask": mask}):
        jl, jmet = jm.loss(params, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tl, tmet = tm.loss({k: torch.from_numpy(v).long()
                            if k == "tokens" else torch.from_numpy(v)
                            for k, v in batch.items()})
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
        assert set(tmet) == set(jmet)
        for key in jmet:
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=1e-5)
    # z-loss is on: switching it off changes the loss by z * mean(lse^2)
    tc0 = dataclasses.replace(tm.config, z_loss=0.0)
    tm0 = tgpt.GPT(tc0, device="cpu")
    tm0.load_state_dict(tm.state_dict())
    batch = {"tokens": torch.from_numpy(toks).long()}
    assert float(tm.loss(batch)[0].detach()) > float(tm0.loss(batch)[0].detach())


@pytest.mark.parametrize("family", ["gpt2_family" + V500,
                                    "llama_tiny" + V500])
def test_grads_match_jax(family):
    """The port's backward against `jax.grad` of JAX's loss, every leaf, at
    the unaligned vocabulary: the tied table (its lookup's gradient and the
    padded head's together) and the untied lm_head."""
    jm, params, tm = _pair(family)
    toks = _tokens(vocab=tm.config.vocab_size)
    assert tm.head_pad_rows == 12
    grads = jax.grad(lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)})[0])(
        params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                           tm.config)
    loss, _ = tm.loss({"tokens": torch.from_numpy(toks).long()})
    loss.backward()
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    assert ("lm_head" in got) == (not tm.config.tie_embeddings)
    for name, g in got.items():
        assert g.shape == want[name].shape, name
        torch.testing.assert_close(g, want[name], atol=GRAD_ATOL, rtol=1e-4,
                                   msg=name)


@pytest.mark.parametrize("family", ["gpt2_family", "llama_tiny"])
@pytest.mark.parametrize("vocab, pad", [(500, 12), (512, 0)])
def test_head_pads_only_its_working_copy(family, vocab, pad):
    """`head_pad_rows` is what makes the head's rows a multiple of 64, and
    the pad lives in the step's working copy alone: every parameter keeps
    its shape, the logits come back [B, S, V] in f32, and the logits and
    gradients equal those of the unpadded head (f32)."""
    _, tc = _configs(family, f32=True, remat=False)
    tc = dataclasses.replace(tc, vocab_size=vocab)
    tm = tgpt.GPT(tc, device="cpu")
    assert tm.head_pad_rows == pad
    d = tc.d_model
    shapes = {"tok_embed": (vocab, d), "lm_head": (d, vocab)}
    own = dict(tm.named_parameters())
    for name, shape in shapes.items():
        if name in own:
            assert own[name].shape == shape, name
    toks = torch.from_numpy(_tokens(s=32, vocab=vocab)).long()
    runs = []
    for pad_rows in (pad, 0):
        tm.head_pad_rows = pad_rows
        tm.zero_grad(set_to_none=True)
        logits = tm.apply(toks)
        tm.loss({"tokens": toks})[0].backward()
        runs.append((logits.detach(),
                     {n: p.grad for n, p in tm.named_parameters()}))
    (logits, grads), (logits0, grads0) = runs
    assert logits.dtype == torch.float32 and logits.shape == (2, 32, vocab)
    assert logits.is_contiguous()
    torch.testing.assert_close(logits, logits0, atol=1e-6, rtol=0)
    for name, g in grads.items():
        assert g.shape == own[name].shape, name
        torch.testing.assert_close(g, grads0[name], atol=1e-7, rtol=1e-5,
                                   msg=name)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_moe_aux_loss_matches_jax(f32):
    """forward_with_aux's load-balance loss, the mean over layers, and the
    loss that adds 0.01 of it."""
    jm, params, tm = _pair("llama_tiny_moe", f32=f32)
    toks = _tokens()
    _, jaux = jm.forward_with_aux(params, jnp.asarray(toks))
    _, taux = tm.forward_with_aux(torch.from_numpy(toks).long())
    # router in f32 on both sides from bf16 or f32 activations
    atol = 1e-6 if f32 else 1e-4
    np.testing.assert_allclose(float(taux["moe_aux_loss"]),
                               float(jaux["moe_aux_loss"]), atol=atol)
    assert 0.5 < float(taux["moe_aux_loss"]) < 2.0
    jl, _ = jm.loss(params, {"tokens": jnp.asarray(toks)})
    tl, tmet = tm.loss({"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=1e-5 if f32 else 1e-4)
    assert float(tmet["loss"]) == float(tl.detach())


def test_causality():
    """Changing a future token must not change past logits."""
    _, _, tm = _pair("llama_tiny")
    toks = torch.from_numpy(_tokens(b=1, s=32)).long()
    logits1 = tm.apply(toks)
    toks2 = toks.clone()
    toks2[0, -1] = (toks2[0, -1] + 1) % 512
    logits2 = tm.apply(toks2)
    torch.testing.assert_close(logits1[0, :-1], logits2[0, :-1], atol=1e-6,
                               rtol=0)
    assert not torch.allclose(logits1[0, -1], logits2[0, -1])


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_policies_give_equal_grads(family):
    _, tc = _configs(family, f32=True)
    toks = torch.from_numpy(_tokens(s=48, vocab=tc.vocab_size)).long()
    grads = {}
    for name, kw in {"off": dict(remat=False),
                     "full": dict(remat=True, remat_policy="full"),
                     "dots": dict(remat=True, remat_policy="dots")}.items():
        m = tgpt.GPT(dataclasses.replace(tc, **kw), device="cpu", seed=0)
        loss, _ = m.loss({"tokens": toks})
        loss.backward()
        grads[name] = {n: p.grad for n, p in m.named_parameters()}
    for name in ("full", "dots"):
        for n, g in grads["off"].items():
            torch.testing.assert_close(grads[name][n], g, atol=1e-6,
                                       rtol=1e-5)


def test_bad_remat_policy_raises():
    with pytest.raises(ValueError):
        tgpt.GPT(tgpt.llama_tiny(remat_policy="nope"), device="cpu")


def _mesh(**spec):
    spec = MeshSpec(**spec)
    return Mesh(spec.resolve(spec.total), {a: 0 for a in AXIS_ORDER})


# The port once refused the ep and pp axes and MoE across ranks; those are
# ported, and what is left of these cases is JAX's own refusals
# (gpt.py:170-178): n_layers must divide into the pp stages, and experts
# with pp > 1 raise. Each case raises exactly when JAX's GPT raises, with
# the same exception type.
@pytest.mark.parametrize("kw, mesh", [
    pytest.param(dict(n_experts=4, pp_microbatches=2), None, id="kw0"),
    pytest.param(dict(pp_microbatches=2), None, id="kw1"),
    pytest.param(dict(n_experts=4), dict(dp=1, fsdp=2), id="fsdp2"),
    pytest.param(dict(n_experts=4), dict(dp=1, tp=2), id="tp2"),
    pytest.param({}, dict(dp=1, ep=2), id="ep2"),
    pytest.param({}, dict(dp=1, pp=2), id="pp2"),
    pytest.param(dict(n_experts=4), dict(dp=2), id="moe_dp2"),
    pytest.param(dict(n_experts=4), dict(dp=1, sp=2), id="moe_sp2"),
    pytest.param(dict(n_experts=4), dict(dp=1, pp=2), id="moe_pp2"),
    pytest.param(dict(n_layers=3), dict(dp=1, pp=2), id="layers3_pp2"),
    pytest.param(dict(n_experts=4), dict(dp=2, ep=2, tp=2), id="moe_ep2"),
])
def test_unported_features_raise(kw, mesh):
    from types import SimpleNamespace

    def outcome(fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as exc:
            return type(exc)
        return None

    jmesh = None if mesh is None else SimpleNamespace(
        shape=_mesh(**mesh).shape)
    want = outcome(lambda: jgpt.GPT(
        dataclasses.replace(jgpt.llama_tiny(), **kw), mesh=jmesh))
    cfg = dataclasses.replace(tgpt.llama_tiny(), **kw)
    if mesh is None:
        got = outcome(lambda: tgpt.GPT(cfg, device="cpu"))
    else:
        # the refusals come first; a hand-built mesh has no process groups
        got = outcome(lambda: tgpt.check_mesh(cfg, _mesh(**mesh)))
    assert got is want, (got, want)
    if "pp" in (mesh or {}) and (kw.get("n_experts") or "n_layers" in kw):
        assert want is not None


def test_param_layout_matches_jax():
    """Every JAX leaf maps to one port parameter of the same shape (per
    layer), and nothing is left over."""
    for family in FAMILIES:
        jm, params, tm = _pair(family)
        state = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                tm.config)
        own = dict(tm.named_parameters())
        assert set(state) == set(own)
        for name, t in state.items():
            assert own[name].shape == t.shape, name
        L = tm.config.n_layers
        assert state["blocks.0.wq"].shape == params["blocks"]["wq"].shape[1:]
        assert len([n for n in state if n.endswith(".wq")]) == L
        assert ("lm_head" in state) == (not tm.config.tie_embeddings)
        if tm.config.n_experts:
            assert state["blocks.0.w_up"].shape == (4, 128, tm.config.ff_dim)
            assert state["blocks.0.router"].shape == (128, 4)


def test_presets_match_jax():
    for name in ("gpt2_small", "gpt2_medium", "gpt2_large", "llama_tiny",
                 "llama_1b", "llama_7b"):
        j, t = getattr(jgpt, name)(), getattr(tgpt, name)()
        for f in dataclasses.fields(j):
            if f.name in ("dtype", "param_dtype", "attention_impl"):
                continue
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        assert (t.n_params, t.head_dim, t.ff_dim, t.kv_heads) == (
            j.n_params, j.head_dim, j.ff_dim, j.kv_heads)
