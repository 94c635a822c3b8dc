"""Port parity: ray_tpu_torch.parallel and the dp x fsdp x tp x sp train
step.

`MeshSpec`, the axis order and the rules table against the JAX package;
`shard_batch` and `shard_params` against the shards JAX's shardings give
each device; the parameters' logical axes against JAX's table; the model
on a loopback mesh against the model without one; the clip's global norm
on sharded gradients against optax; and f32 llama_tiny train steps on 4
and 8 gloo processes (tests/torch_dist_worker.py) against JAX's sharded
`make_train_step` on as many of the suite's virtual CPU devices, from the
same parameters and tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optax

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
                                    shard_batch, shard_params,
                                    with_logical_constraint)

torch_dist_worker.settle()

# f32 on both sides; the ring, the all-reduces and XLA's partitioned sums
# add in other orders. Per step, losses and grad norms to 1e-5 relative
# (read 8.0e-8 and 2.3e-7 at dp x sp, at most 1.5e-7 and 9.0e-8 on the 8
# ranks of JAX's fsdp/tp meshes); after 3 steps each parameter normwise to
# 1e-5 (read 4.5e-6 and at most 3.5e-6: Adam's first steps are
# m / sqrt(v) of rounding-level gradients for a few elements).
TRAJ_RTOL = 1e-5
PARAM_NORM_RTOL = 1e-5
# the same model with and without a loopback mesh: only attention differs
# (the ring's merge against one flash pass; read 4.8e-7 on the logits)
LOOPBACK_ATOL = 1e-6
# one forward and backward of the GPT-2 family at tp 2 against JAX, each
# parameter's gradient normwise (read 9.3e-7)
GRAD_NORM_RTOL = 1e-5
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
    """A loopback mesh holds one axis larger than 1: sp (a ring) or, since
    the pipeline, pp (a pipe); dp 2 x sp 2 and sp 2 x pp 2 are refused."""
    for spec in (MeshSpec(dp=2, sp=2), MeshSpec(sp=2, pp=2),
                 MeshSpec(ep=2)):
        with pytest.raises(ValueError, match="sp alone"):
            loopback_mesh(spec)
    mesh = loopback_mesh(MeshSpec(sp=4))
    assert mesh.shape == {"pp": 1, "dp": 1, "fsdp": 1, "ep": 1, "sp": 4,
                          "tp": 1}
    assert mesh.group("sp").size == 4
    mesh = loopback_mesh(MeshSpec(pp=2))
    assert mesh.shape == {"pp": 2, "dp": 1, "fsdp": 1, "ep": 1, "sp": 1,
                          "tp": 1}
    assert mesh.group("pp").stages == (0, 1)


def test_step_takes_the_models_mesh():
    mesh = loopback_mesh(MeshSpec(sp=2))
    model = tgpt.GPT(tgpt.llama_tiny(), device="cpu")
    opt = ttrain.make_optimizer()
    with pytest.raises(ValueError, match="mesh"):
        ttrain.make_train_step(model, opt, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        ttrain.init_train_state(model, opt, device="cpu", mesh=mesh)


# --- parameter shards ------------------------------------------------------

# tests/test_models.py:96-100, the meshes JAX's sharded training runs on
SHARDED_SPECS = {"dp2_fsdp2_tp2": dict(dp=2, fsdp=2, tp=2),
                 "dp2_sp2_tp2": dict(dp=2, sp=2, tp=2),
                 "fsdp4_tp2": dict(dp=1, fsdp=4, tp=2)}

# tests/test_models.py:36, the GPT-2 family at test scale
GPT2_FAMILY = dict(vocab_size=512, n_layers=2, d_model=128, n_heads=4,
                   max_seq_len=128, activation="gelu", norm="layernorm",
                   positions="learned", tie_embeddings=True)

LOGICAL_FAMILIES = {
    "llama_tiny": dict(),
    "gpt2": GPT2_FAMILY,
    "llama_tiny_moe": dict(n_experts=4, moe_top_k=2),
}


def _family_configs(kw):
    if "activation" in kw:
        return (jgpt.GPTConfig(dtype=jnp.float32, **kw),
                tgpt.GPTConfig(dtype=torch.float32, **kw))
    return (jgpt.llama_tiny(dtype=jnp.float32, **kw),
            tgpt.llama_tiny(dtype=torch.float32, **kw))


def _jax_axes_by_port_name(jaxes, n_layers):
    """JAX's nested table -> the port's flat names, each block entry per
    layer without its leading "layers" axis."""
    out = {}
    for name, axes in jaxes.items():
        if name != "blocks":
            out[name] = tuple(axes)
            continue
        for k, v in axes.items():
            assert v[0] == "layers", (k, v)
            out.update({f"blocks.{i}.{k}": tuple(v[1:])
                        for i in range(n_layers)})
    return out


@pytest.mark.parametrize("family", list(LOGICAL_FAMILIES))
def test_param_logical_axes_match_jax(family):
    jc, tc = _family_configs(LOGICAL_FAMILIES[family])
    want = _jax_axes_by_port_name(jgpt.GPT(jc).param_logical_axes(),
                                  tc.n_layers)
    model = tgpt.GPT(tc, device="cpu")
    got = model.param_logical_axes()
    assert got == want
    assert set(got) == {n for n, _ in model.named_parameters()}


@pytest.mark.parametrize("spec_name", list(SHARDED_SPECS))
@pytest.mark.parametrize("family", ["llama_tiny", "gpt2"])
def test_shard_params_match_jax_shards(family, spec_name):
    """Each device's `addressable_shards` data of JAX's parameters sharded
    by its logical axes (`shard_params`) equals what the port's
    `shard_params` gives the rank at that device's mesh coordinates, for
    every parameter and every layer."""
    spec_kw = SHARDED_SPECS[spec_name]
    jc, tc = _family_configs(LOGICAL_FAMILIES[family])
    jax_mesh = jmesh.build_mesh(jmesh.MeshSpec(**spec_kw).resolve(8),
                                devices=jax.devices()[:8])
    jm = jgpt.GPT(jc)
    params = jm.init(jax.random.PRNGKey(0))
    sharded = jsharding.shard_params(params, jm.param_logical_axes(),
                                     jax_mesh)
    full = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tc)
    logical = tgpt.GPT(tc, device="cpu").param_logical_axes()
    spec = MeshSpec(**spec_kw).resolve(8)
    leaves = dict(sharded, **{f"blocks/{k}": v
                              for k, v in sharded["blocks"].items()})
    del leaves["blocks"]
    n_checked = 0
    for shard in jax.tree_util.tree_leaves(sharded)[0].addressable_shards:
        where = np.argwhere(jax_mesh.devices == shard.device)[0]
        coords = dict(zip(jax_mesh.axis_names, map(int, where)))
        local = shard_params(full, logical, Mesh(spec, coords))
        for leaf_name, leaf in leaves.items():
            data = next(np.asarray(sh.data) for sh in leaf.addressable_shards
                        if sh.device == shard.device)
            if leaf_name.startswith("blocks/"):
                name = leaf_name.split("/")[1]
                for i in range(tc.n_layers):
                    np.testing.assert_array_equal(
                        local[f"blocks.{i}.{name}"].numpy(), data[i])
                    n_checked += 1
            else:
                np.testing.assert_array_equal(local[leaf_name].numpy(), data)
                n_checked += 1
    assert n_checked == 8 * len(full)


def test_with_logical_constraint_checks_local_shapes():
    spec = MeshSpec(dp=2, fsdp=2, tp=2).resolve(8)
    mesh = Mesh(spec, {a: 0 for a in AXIS_ORDER})
    x = torch.zeros(2, 16, 256)
    assert with_logical_constraint(x, "act_batch", "act_seq", "act_vocab",
                                   global_shape=(8, 16, 512),
                                   mesh=mesh) is x
    with pytest.raises(ValueError, match="not this rank's part"):
        with_logical_constraint(x, "act_batch", "act_seq", "act_vocab",
                                global_shape=(4, 16, 512), mesh=mesh)
    # no mesh, no check
    assert with_logical_constraint(x, "act_batch", global_shape=(1,)) is x


def test_rules_only_keeps_the_named_mesh_axes():
    tp = DEFAULT_RULES.only("tp")
    assert tp.spec("act_batch", "embed", "heads", "vocab") == \
        (None, None, "tp", "tp")
    both = DEFAULT_RULES.only("dp", "fsdp")
    assert both.spec("act_batch", "embed", "heads") == \
        (("dp", "fsdp"), "fsdp", None)


CLIP_SPECS = {"fsdp2_tp2": dict(dp=1, fsdp=2, tp=2),
              "dp2_tp2": dict(dp=2, tp=2)}


@pytest.mark.parametrize("spec_name", list(CLIP_SPECS))
@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_sharded_clip_matches_optax(spec_name, scale, tmp_path):
    """Three clip_by_global_norm + adamw updates on 4 gloo ranks, each
    holding its shards (over fsdp and tp by the rules) of the same full
    params and grads, against optax on the full tensors: the norm is the
    full gradients' (tp-replicated tensors counted once), below and above
    the clip threshold, and the gathered params equal optax's. Also: with
    the squares summed over groups of one rank the update equals the
    unsharded one bit for bit."""
    rng = np.random.default_rng(0)
    logical = {"emb": ("vocab", "embed"), "norm": (None,),
               "wq": ("embed", "heads", "head_dim"),
               "wo": ("heads", "head_dim", "embed"),
               "bias": ("embed",)}
    shapes = {"emb": (8, 6), "norm": (6,), "wq": (6, 4, 3),
              "wo": (4, 3, 6), "bias": (6,)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    grads = {n: (rng.standard_normal(s) * scale).astype(np.float32)
             for n, s in shapes.items()}
    np.savez(tmp_path / "inputs.npz",
             **{f"p/{n}": v for n, v in params.items()},
             **{f"g/{n}": v for n, v in grads.items()})
    kw = dict(learning_rate=1e-2, warmup_steps=0, total_steps=10)
    ranks = torch_dist_worker.launch(
        torch_dist_worker.clip_rank, 4, tmp_path, CLIP_SPECS[spec_name],
        str(tmp_path / "inputs.npz"), logical, kw, timeout=120.0)
    jopt = jtrain.make_optimizer(**kw)
    jstate = jopt.init(params)
    jp = params
    for _ in range(3):
        upd, jstate = jopt.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
    want_norm = float(optax.global_norm(grads))
    for res in ranks:
        np.testing.assert_allclose(res["norms"], [want_norm] * 3, rtol=1e-6)
        assert bool(res["bit_identical"])
        for n in params:
            np.testing.assert_allclose(res[f"param/{n}"], np.asarray(jp[n]),
                                       rtol=1e-5, atol=1e-7)


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


TRAIN_SPECS = {"dp2_sp2": dict(dp=2, sp=2), "sp4": dict(dp=1, sp=4),
               **SHARDED_SPECS}


@pytest.fixture(scope="module", params=list(TRAIN_SPECS))
def trained(request, tmp_path_factory):
    """3 train steps on 4 or 8 gloo ranks and in JAX on as many virtual
    devices, with the same MeshSpec, parameters and global batch."""
    spec_kw = TRAIN_SPECS[request.param]
    world = MeshSpec(**spec_kw).total
    tmp = tmp_path_factory.mktemp(request.param)
    jc, tc = _jax_setup()
    jax_mesh = jmesh.build_mesh(jmesh.MeshSpec(**spec_kw).resolve(world),
                                devices=jax.devices()[:world])
    jm = jgpt.GPT(jc, mesh=jax_mesh)
    jopt = jtrain.make_optimizer(**OPT_KW)
    jstate = jtrain.init_train_state(jm, jopt, jax.random.PRNGKey(0),
                                     mesh=jax_mesh)
    _save_params(tmp / "params.npz", jstate.params, tc)
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (4, 64),
                                             dtype=np.int32)
    np.savez(tmp / "tokens.npz", tokens=toks)
    ranks = torch_dist_worker.launch(
        torch_dist_worker.train_rank, world, tmp, spec_kw,
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
    assert len(set(coords)) == len(ranks)


def test_shards_equal_slices_of_the_unsharded_draw(trained):
    """Each rank cuts every tensor to its part as it is drawn; its shards
    (the FSDP2 shard of its tp slice) are bit-equal to the same part of the
    weights `GPT(config, seed=0)` draws with no mesh, as when every rank
    drew the full weights and sliced them."""
    ranks, _ = trained
    for rank, res in enumerate(ranks):
        assert list(res["shards_not_matching"]) == [], f"rank {rank}"


def test_build_holds_one_full_tensor_beyond_its_shards(tmp_path):
    """While a rank of a 4-rank fsdp x tp mesh builds the model, the bytes
    alive at once never exceed its tp slices plus the largest full
    parameter, and no tensor larger than that parameter is allocated
    (every full parameter alive at once would be the whole model)."""
    ranks = torch_dist_worker.launch(torch_dist_worker.build_memory_rank, 4,
                                     tmp_path, dict(fsdp=2, tp=2), {})
    for rank, res in enumerate(ranks):
        assert res["largest"] <= res["largest_param"], rank
        assert res["peak"] - res["sliced"] <= res["largest_param"], (
            rank, {k: int(v) for k, v in res.items()})
        assert res["sliced"] < res["model"], rank


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
            # the same summed gradients: the same gathered weights on
            # every rank
            np.testing.assert_array_equal(got, ranks[0][f"param/{name}"])
        err = np.linalg.norm(ranks[0][f"param/{name}"] - want)
        assert err <= PARAM_NORM_RTOL * np.linalg.norm(want), name


def test_eval_step_on_the_mesh_matches_jax(trained):
    """The eval step after the 3 updates: the global loss on every rank."""
    ranks, (_, _, _, _, j_eval) = trained
    for res in ranks:
        np.testing.assert_allclose(float(res["eval_loss"]), j_eval,
                                   rtol=TRAJ_RTOL)


def _gpt2_forward(tmp_path, spec_kw, cfg_kw=GPT2_FAMILY):
    """GPT-2-family ranks on `spec_kw` against JAX's single-device logits,
    loss and gradients, from the same parameters and tokens."""
    jc, tc = _jax_setup(cfg_kw, family="gpt2")
    jm = jgpt.GPT(jc)
    params = jm.init(jax.random.PRNGKey(0))
    _save_params(tmp_path / "params.npz", params, tc)
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 64),
                                             dtype=np.int32)
    np.savez(tmp_path / "tokens.npz", tokens=toks)
    world = MeshSpec(**spec_kw).total
    ranks = torch_dist_worker.launch(
        torch_dist_worker.forward_rank, world, tmp_path, spec_kw,
        cfg_kw, str(tmp_path / "params.npz"),
        str(tmp_path / "tokens.npz"))
    logits = np.asarray(jm.apply(params, jnp.asarray(toks)))
    (loss, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        params, {"tokens": jnp.asarray(toks)})
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads), tc)
    return ranks, logits, float(loss), grads


def _coord(res, axis):
    return int(res["coords"][AXIS_ORDER.index(axis)])


def test_gpt2_family_sp2_forward_matches_jax(tmp_path):
    """Learned positions at sp 2 on 2 gloo ranks: each rank's logits are
    its columns of JAX's single-device logits (so the position offsets are
    right), and the loss is the global one."""
    ranks, logits, loss, _ = _gpt2_forward(tmp_path, dict(dp=1, sp=2))
    for res in ranks:
        sp = _coord(res, "sp")
        np.testing.assert_allclose(res["logits"],
                                   logits[:, sp * 32:(sp + 1) * 32],
                                   atol=1e-4)
        np.testing.assert_allclose(float(res["global_loss"]), loss,
                                   rtol=1e-5)
    np.testing.assert_allclose(sum(float(r["loss"]) for r in ranks),
                               loss, rtol=1e-5)


def test_gpt2_family_tp2_forward_matches_jax(tmp_path):
    """Tied vocab-parallel embeddings, learned positions and LayerNorm
    biases at tp 2 on 2 gloo ranks: each rank's logits are its vocab
    columns of JAX's single-device logits, both ranks hold the global loss
    (not summed over tp), and the gathered gradients (the tied table's from
    the lookup and the head together) equal JAX's. The block checkpoint
    runs the "dots" policy, whose recompute repeats the tp all-reduces."""
    ranks, logits, loss, grads = _gpt2_forward(
        tmp_path, dict(dp=1, tp=2), dict(GPT2_FAMILY, remat_policy="dots"))
    for res in ranks:
        tp = _coord(res, "tp")
        np.testing.assert_allclose(res["logits"],
                                   logits[:, :, tp * 256:(tp + 1) * 256],
                                   atol=1e-4)
        np.testing.assert_allclose(float(res["global_loss"]), loss,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(res["loss"]), loss, rtol=1e-5)
        for name, want in grads.items():
            want = want.numpy()
            err = np.linalg.norm(res[f"grad/{name}"] - want)
            assert err <= GRAD_NORM_RTOL * np.linalg.norm(want), name
