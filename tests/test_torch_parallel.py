"""Port parity: ray_tpu_torch.parallel and the dp x sp train step.

`MeshSpec`, the axis order and the rules table against the JAX package;
`shard_batch` against the shards JAX's batch sharding gives each device;
the model on a loopback mesh against the model without one; and f32
llama_tiny train steps on 4 gloo processes (tests/torch_dist_worker.py)
against JAX's sharded `make_train_step` on 4 of the suite's virtual CPU
devices, from the same parameters and tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker
from ray_tpu.models import gpt as jgpt
from ray_tpu.models import training as jtrain
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import training as ttrain
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.parallel import (AXIS_ORDER, DEFAULT_RULES, Mesh, MeshSpec,
                                    loopback_mesh, mesh_shape_for,
                                    shard_batch)

torch.set_num_threads(torch_dist_worker.THREADS)

# f32 on both sides; the ring, the all-reduces and XLA's partitioned sums
# add in other orders. Per step, losses and grad norms to 1e-5 relative
# (read 8.0e-8 and 2.3e-7); after 3 steps each parameter normwise to 1e-5
# (read 4.5e-6: Adam's first steps are m / sqrt(v) of rounding-level
# gradients for a few elements).
TRAJ_RTOL = 1e-5
PARAM_NORM_RTOL = 1e-5
# the same model with and without a loopback mesh: only attention differs
# (the ring's merge against one flash pass; read 4.8e-7 on the logits)
LOOPBACK_ATOL = 1e-6
OPT_KW = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50)


SPECS = [dict(), dict(dp=2), dict(dp=-1, sp=2), dict(dp=2, sp=2),
         dict(dp=1, sp=4), dict(dp=2, tp=2, fsdp=2), dict(dp=-1, tp=3),
         dict(dp=-1, fsdp=-1), dict(dp=3, sp=1), dict(pp=2, ep=2, dp=1)]


def _spec_id(kw):
    return "_".join(f"{k}{v}" for k, v in kw.items()) or "default"


@pytest.mark.parametrize("kw", SPECS, ids=_spec_id)
@pytest.mark.parametrize("n", [4, 8])
def test_mesh_spec_resolve_matches_jax(kw, n):
    ours, theirs = MeshSpec(**kw), jmesh.MeshSpec(**kw)
    try:
        want = theirs.resolve(n)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            ours.resolve(n)
        assert str(got.value) == str(exc)
        return
    got = ours.resolve(n)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.axis_sizes() == want.axis_sizes() and got.total == want.total


def test_axis_order_and_helpers_match_jax():
    assert AXIS_ORDER == jmesh.AXIS_ORDER
    for kw in (dict(), dict(sp=2), dict(tp=2, sp=2), dict(fsdp=4)):
        assert dataclasses.asdict(mesh_shape_for(8, **kw)) == \
            dataclasses.asdict(jmesh.mesh_shape_for(8, **kw))
    with pytest.raises(ValueError, match="unresolved"):
        MeshSpec().total
    with pytest.raises(ValueError, match="unresolved"):
        jmesh.MeshSpec().total


def test_default_rules_match_jax():
    assert dict(DEFAULT_RULES) == dict(jsharding.DEFAULT_RULES)
    for axes in (("act_batch", "act_seq"), ("act_batch", "act_heads",
                                            "act_seq", "head_dim"),
                 ("embed", None, "vocab")):
        assert DEFAULT_RULES.spec(*axes) == \
            tuple(jsharding.DEFAULT_RULES.spec(*axes))


@pytest.mark.parametrize("kw", [dict(dp=2, sp=2), dict(dp=1, sp=4),
                                dict(dp=2, fsdp=2, sp=2)], ids=_spec_id)
def test_shard_batch_matches_jax_shards(kw):
    """Each device's rows and columns under JAX's batch sharding
    (act_batch, act_seq) are the rows and columns `shard_batch` gives the
    rank at that device's mesh coordinate; targets, mask and positions are
    slices of the global ones."""
    spec = MeshSpec(**kw)
    spec = spec.resolve(spec.total)
    jax_mesh = jmesh.build_mesh(jmesh.MeshSpec(**kw).resolve(spec.total),
                                devices=jax.devices()[:spec.total])
    b, s = 8, 32
    index_map = jtrain.batch_shardings(jax_mesh).devices_indices_map((b, s))
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(0, 512, (b, s)))
    loss_mask = torch.tensor((rng.random((b, s)) > 0.3).astype(np.float32))
    full = shard_batch(None, {"tokens": tokens, "loss_mask": loss_mask})
    assert torch.equal(full["targets"][:, :-1], tokens[:, 1:])
    assert torch.equal(full["loss_mask"][:, :-1], loss_mask[:, :-1])
    assert not full["loss_mask"][:, -1].any()
    for device, index in index_map.items():
        where = np.argwhere(jax_mesh.devices == device)[0]
        coords = dict(zip(jax_mesh.axis_names, map(int, where)))
        local = shard_batch(Mesh(spec, coords),
                            {"tokens": tokens, "loss_mask": loss_mask})
        for key, value in full.items():
            assert torch.equal(local[key], value[index]), (key, coords)


@pytest.mark.parametrize("sp", [2, 4])
def test_loopback_mesh_model_equals_no_mesh(sp):
    """llama_tiny on a loopback sp mesh (the whole sequence here, attention
    through the ring's shards) against the same weights without a mesh:
    logits, loss, metrics and every gradient."""
    cfg = tgpt.llama_tiny(dtype=torch.float32)
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64)))
    out = {}
    for name, mesh in (("none", None),
                       ("loopback", loopback_mesh(MeshSpec(dp=1, sp=sp)))):
        m = tgpt.GPT(cfg, device="cpu", seed=0, mesh=mesh)
        loss, metrics = m.loss({"tokens": toks})
        loss.backward()
        out[name] = (m.apply(toks).detach(), loss.detach(), metrics,
                     {n: p.grad for n, p in m.named_parameters()})
    (l0, loss0, met0, g0), (l1, loss1, met1, g1) = out["none"], out["loopback"]
    torch.testing.assert_close(l1, l0, atol=LOOPBACK_ATOL, rtol=0)
    torch.testing.assert_close(loss1, loss0, atol=LOOPBACK_ATOL, rtol=0)
    assert met1["tokens"] == met0["tokens"]
    for n, g in g0.items():
        torch.testing.assert_close(g1[n], g, atol=LOOPBACK_ATOL, rtol=0)


def test_loopback_mesh_holds_sp_alone():
    with pytest.raises(ValueError, match="sp alone"):
        loopback_mesh(MeshSpec(dp=2, sp=2))
    mesh = loopback_mesh(MeshSpec(sp=4))
    assert mesh.shape == {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "sp": 4,
                          "tp": 1}
    assert mesh.group("sp").size == 4


def test_step_takes_the_models_mesh():
    mesh = loopback_mesh(MeshSpec(sp=2))
    model = tgpt.GPT(tgpt.llama_tiny(), device="cpu")
    opt = ttrain.make_optimizer()
    with pytest.raises(ValueError, match="mesh"):
        ttrain.make_train_step(model, opt, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        ttrain.init_train_state(model, opt, device="cpu", mesh=mesh)


# --- gloo ranks against JAX's sharded step ------------------------------------

def _jax_setup(cfg_kw=None, family="llama_tiny"):
    if family == "llama_tiny":
        jc = jgpt.llama_tiny(dtype=jnp.float32, attention_impl="reference")
        tc = tgpt.llama_tiny(dtype=torch.float32)
    else:
        jc = jgpt.GPTConfig(dtype=jnp.float32, attention_impl="reference",
                            **cfg_kw)
        tc = tgpt.GPTConfig(dtype=torch.float32, **cfg_kw)
    return jc, tc


def _save_params(path, jparams, tc):
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tc)
    np.savez(path, **{n: t.numpy() for n, t in state.items()})
    return state


TRAIN_SPECS = {"dp2_sp2": dict(dp=2, sp=2), "sp4": dict(dp=1, sp=4)}


@pytest.fixture(scope="module", params=list(TRAIN_SPECS))
def trained(request, tmp_path_factory):
    """3 train steps on 4 gloo ranks and in JAX on 4 virtual devices, with
    the same MeshSpec, parameters and global batch."""
    spec_kw = TRAIN_SPECS[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    jc, tc = _jax_setup()
    jax_mesh = jmesh.build_mesh(jmesh.MeshSpec(**spec_kw).resolve(4),
                                devices=jax.devices()[:4])
    jm = jgpt.GPT(jc, mesh=jax_mesh)
    jopt = jtrain.make_optimizer(**OPT_KW)
    jstate = jtrain.init_train_state(jm, jopt, jax.random.PRNGKey(0),
                                     mesh=jax_mesh)
    _save_params(tmp / "params.npz", jstate.params, tc)
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (4, 64),
                                             dtype=np.int32)
    np.savez(tmp / "tokens.npz", tokens=toks)
    ranks = torch_dist_worker.launch(
        torch_dist_worker.train_rank, 4, tmp, spec_kw,
        str(tmp / "params.npz"), str(tmp / "tokens.npz"), 3, OPT_KW)
    jstep = jtrain.make_train_step(jm, jopt, mesh=jax_mesh, donate=False)
    batch = {"tokens": jax.device_put(jnp.asarray(toks),
                                      jtrain.batch_shardings(jax_mesh))}
    jl, jg, jt = [], [], []
    for _ in range(3):
        jstate, m = jstep(jstate, batch)
        jl.append(float(m["loss"]))
        jg.append(float(m["grad_norm"]))
        jt.append(float(m["tokens"]))
    j_eval = float(jtrain.eval_step_fn(jm, mesh=jax_mesh)(
        jstate.params, batch)["loss"])
    jparams = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params), tc)
    return ranks, (jl, jg, jt, jparams, j_eval)


def test_same_weights_on_every_rank(trained):
    ranks, _ = trained
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["init"], ranks[0]["init"])
    coords = sorted(tuple(r["coords"]) for r in ranks)
    assert len(set(coords)) == 4


def test_train_trajectory_matches_jax(trained):
    ranks, (jl, jg, jt, jparams, _) = trained
    for res in ranks:
        np.testing.assert_allclose(res["losses"], jl, rtol=TRAJ_RTOL)
        np.testing.assert_allclose(res["grad_norms"], jg, rtol=TRAJ_RTOL)
        np.testing.assert_array_equal(res["tokens"], jt)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
    for name, want in jparams.items():
        want = want.numpy()
        for res in ranks:
            got = res[f"param/{name}"]
            # the same all-reduced gradients: equal on every rank
            np.testing.assert_array_equal(got, ranks[0][f"param/{name}"])
        err = np.linalg.norm(ranks[0][f"param/{name}"] - want)
        assert err <= PARAM_NORM_RTOL * np.linalg.norm(want), name


def test_eval_step_on_the_mesh_matches_jax(trained):
    """The eval step after the 3 updates: the global loss on every rank."""
    ranks, (_, _, _, _, j_eval) = trained
    for res in ranks:
        np.testing.assert_allclose(float(res["eval_loss"]), j_eval,
                                   rtol=TRAJ_RTOL)


# tests/test_models.py:36, the GPT-2 family at test scale
GPT2_FAMILY = dict(vocab_size=512, n_layers=2, d_model=128, n_heads=4,
                   max_seq_len=128, activation="gelu", norm="layernorm",
                   positions="learned", tie_embeddings=True)


def test_gpt2_family_sp2_forward_matches_jax(tmp_path):
    """Learned positions at sp 2 on 2 gloo ranks: each rank's logits are
    its columns of JAX's single-device logits (so the position offsets are
    right), and the loss is the global one."""
    jc, tc = _jax_setup(GPT2_FAMILY, family="gpt2")
    jm = jgpt.GPT(jc)
    params = jm.init(jax.random.PRNGKey(0))
    _save_params(tmp_path / "params.npz", params, tc)
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 64),
                                             dtype=np.int32)
    np.savez(tmp_path / "tokens.npz", tokens=toks)
    ranks = torch_dist_worker.launch(
        torch_dist_worker.forward_rank, 2, tmp_path, dict(dp=1, sp=2),
        GPT2_FAMILY, str(tmp_path / "params.npz"),
        str(tmp_path / "tokens.npz"))
    logits = np.asarray(jm.apply(params, jnp.asarray(toks)))
    loss, _ = jm.loss(params, {"tokens": jnp.asarray(toks)})
    for res in ranks:
        sp = int(res["coords"][1])
        np.testing.assert_allclose(res["logits"],
                                   logits[:, sp * 32:(sp + 1) * 32],
                                   atol=1e-4)
        np.testing.assert_allclose(float(res["global_loss"]), float(loss),
                                   rtol=1e-5)
    np.testing.assert_allclose(sum(float(r["loss"]) for r in ranks),
                               float(loss), rtol=1e-5)
