"""Port parity: the mixture-of-experts FFN across ranks and the ep axis.

JAX runs `moe_ffn` as one global computation that GSPMD partitions: the
capacity from the global token count, the slots in global token order,
tokens replicated over ep and each ep rank running its own experts. Here
the same seeded numpy inputs go through:

* `moe_ffn` on 4 gloo ranks at dp 2 x sp 2 (tests/torch_dist_worker.py)
  against JAX's single-device `moe_ffn` on the global tokens: routing
  exactly, outputs, metrics and gradients;
* `shard_params` of the MoE model at dp 2 x ep 2 x tp 2 against the shards
  JAX's shardings give each device;
* 3 f32 train steps of llama_tiny with 4 experts on 8 gloo ranks against
  JAX's sharded `make_train_step` on 8 virtual devices, at JAX's own
  dp 2 x ep 2 x tp 2 (tests/test_models_parallel.py:52-65) and at
  fsdp 2 x sp 2 x ep 2;
* the MoE model on a process mesh of one rank against the model without a
  mesh: bit for bit, and the exact calls of each collective a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker
from ray_tpu.models import gpt as jgpt
from ray_tpu.models import training as jtrain
from ray_tpu.models.moe import moe_ffn as jax_moe_ffn
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import training as ttrain
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.parallel import AXIS_ORDER, Mesh, MeshSpec, shard_params

torch.set_num_threads(torch_dist_worker.THREADS)

# f32 on both sides, partitioned sums in other orders. Per step losses,
# grad norms and the load-balance loss to 1e-5 relative of JAX's sharded
# step (the dense meshes' bound, tests/test_torch_parallel.py). After 3
# steps each parameter normwise to 5e-5 of JAX's sharded parameters: two
# partitions of the same f32 step differ that much, JAX's own included.
# JAX's sharded step lies 2.4e-5 (dp 2 x ep 2 x tp 2) and 1.7e-5 (fsdp 2 x
# sp 2 x ep 2) from JAX's single-device step, both at blocks.1.wv, where
# Adam's first updates scale rounding-level gradient differences up; the
# port read 2.1e-5 and 2.7e-6 from JAX's sharded step, 2.7e-6 and 1.7e-5
# from JAX's single-device one.
TRAJ_RTOL = 1e-5
PARAM_NORM_RTOL = 5e-5
# moe_ffn on 4 ranks against JAX on one device, f32: outputs and x's
# gradient per element (O(1) values), the summed weight gradients
# normwise, the metrics relative
MOE_ATOL = 1e-5
MOE_GRAD_NORM_RTOL = 1e-5
MOE_METRIC_RTOL = 1e-6
OPT_KW = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50)

E, D, FF = 4, 32, 48


def _jax_routing(x, router, top_k, capacity_factor):
    """JAX's routing, ray_tpu/models/moe.py:27-50 line for line (moe_ffn
    keeps it internal): expert choice, slot and fits of every token."""
    b, s, d = x.shape
    e = router.shape[-1]
    n_tokens = b * s
    capacity = max(1, int(capacity_factor * top_k * n_tokens / e))
    xf = x.reshape(n_tokens, d)
    probs = jax.nn.softmax(xf.astype(jnp.float32)
                           @ router.astype(jnp.float32), axis=-1)
    _, expert_idx = jax.lax.top_k(probs, top_k)
    onehot = jax.nn.one_hot(expert_idx, e, dtype=jnp.float32)
    flat = onehot.transpose(1, 0, 2).reshape(top_k * n_tokens, e)
    pos = jnp.cumsum(flat, axis=0) - flat
    pos = pos.reshape(top_k, n_tokens, e).transpose(1, 0, 2)
    slot = (pos * onehot).sum(-1)
    return (np.asarray(expert_idx), np.asarray(slot),
            np.asarray(slot < capacity))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5],
                         ids=["cf1.25", "overflow_cf0.5"])
def test_moe_ffn_across_ranks_matches_jax(capacity_factor, tmp_path):
    """dp 2 x sp 2 on 4 gloo ranks: each rank's expert choice, slot and
    fits equal, exactly, its rows and columns of JAX's single-device
    routing on the global tokens (a rank's tokens are not contiguous in
    the global order at sp 2); its outputs and x's gradient are its part
    of JAX's; the load-balance shares sum to JAX's loss, the overflow is
    JAX's; the router and expert gradients summed over the batch group are
    JAX's."""
    rng = np.random.default_rng(0)
    b, s, top_k = 4, 32, 2
    data = {"x": rng.standard_normal((b, s, D)).astype(np.float32),
            "router": (rng.standard_normal((D, E)) * 0.3).astype(np.float32),
            "w_up": (rng.standard_normal((E, D, FF)) * 0.1).astype(np.float32),
            "w_gate": (rng.standard_normal((E, D, FF)) * 0.1
                       ).astype(np.float32),
            "w_down": (rng.standard_normal((E, FF, D)) * 0.1
                       ).astype(np.float32),
            "probe": rng.standard_normal((b, s, D)).astype(np.float32)}
    np.savez(tmp_path / "inputs.npz", **data)
    spec = dict(dp=2, sp=2)
    ranks = torch_dist_worker.launch(
        torch_dist_worker.moe_rank, 4, tmp_path, spec,
        str(tmp_path / "inputs.npz"), top_k, capacity_factor)

    idx, slot, fits = _jax_routing(jnp.asarray(data["x"]),
                                   jnp.asarray(data["router"]), top_k,
                                   capacity_factor)
    names = ("router", "w_up", "w_gate", "w_down")

    def loss(x, *w):
        out, m = jax_moe_ffn(x, *w, top_k=top_k,
                             capacity_factor=capacity_factor,
                             dtype=jnp.float32)
        return (out * data["probe"]).sum(), (out, m)

    (_, (out, metrics)), grads = jax.value_and_grad(
        loss, argnums=tuple(range(5)), has_aux=True)(
            *(jnp.asarray(data[n]) for n in ("x",) + names))
    out, grads = np.asarray(out), [np.asarray(g) for g in grads]
    if capacity_factor < 1:
        assert not fits.all()
    aux = 0.0
    for res in ranks:
        c = dict(zip(AXIS_ORDER, res["coords"]))
        rows = slice(c["dp"] * 2, c["dp"] * 2 + 2)
        cols = slice(c["sp"] * 16, c["sp"] * 16 + 16)
        want = [a.reshape(b, s, top_k)[rows, cols].reshape(-1, top_k)
                for a in (idx, slot, fits)]
        np.testing.assert_array_equal(res["expert_idx"], want[0])
        np.testing.assert_array_equal(res["slot"], want[1])
        np.testing.assert_array_equal(res["fits"], want[2])
        np.testing.assert_allclose(res["out"], out[rows, cols],
                                   atol=MOE_ATOL, rtol=0)
        np.testing.assert_allclose(res["grad_x"], grads[0][rows, cols],
                                   atol=MOE_ATOL, rtol=0)
        np.testing.assert_allclose(float(res["overflow"]),
                                   float(metrics["moe_overflow"]),
                                   rtol=MOE_METRIC_RTOL)
        for n, g in zip(names, grads[1:]):
            err = np.linalg.norm(res[f"grad/{n}"] - g)
            assert err <= MOE_GRAD_NORM_RTOL * np.linalg.norm(g), n
        aux += float(res["aux"])
    np.testing.assert_allclose(aux, float(metrics["moe_aux_loss"]),
                               rtol=MOE_METRIC_RTOL)


def test_moe_shard_params_match_jax_shards():
    """dp 2 x ep 2 x tp 2: each device's shard of JAX's MoE parameters
    (the expert axis over ep, mlp over tp, embed over fsdp of 1) is what the
    port's `shard_params` gives the rank at its coordinates."""
    spec_kw = dict(dp=2, ep=2, tp=2)
    jc = jgpt.llama_tiny(dtype=jnp.float32, n_experts=4)
    tc = tgpt.llama_tiny(dtype=torch.float32, n_experts=4)
    jax_mesh = jmesh.build_mesh(jmesh.MeshSpec(**spec_kw).resolve(8),
                                devices=jax.devices()[:8])
    jm = jgpt.GPT(jc)
    params = jm.init(jax.random.PRNGKey(0))
    sharded = jsharding.shard_params(params, jm.param_logical_axes(),
                                     jax_mesh)
    full = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tc)
    logical = tgpt.GPT(tc, device="cpu").param_logical_axes()
    spec = MeshSpec(**spec_kw).resolve(8)
    n_checked = 0
    for name in ("w_up", "w_gate", "w_down", "router"):
        for shard in sharded["blocks"][name].addressable_shards:
            where = np.argwhere(jax_mesh.devices == shard.device)[0]
            coords = dict(zip(jax_mesh.axis_names, map(int, where)))
            local = shard_params(full, logical, Mesh(spec, coords))
            for i in range(tc.n_layers):
                np.testing.assert_array_equal(
                    local[f"blocks.{i}.{name}"].numpy(),
                    np.asarray(shard.data)[i])
                n_checked += 1
    assert n_checked == 4 * 8 * tc.n_layers
    assert local["blocks.0.w_up"].shape == (2, 128, tc.ff_dim // 2)


MOE_SPECS = {"dp2_ep2_tp2": dict(dp=2, ep=2, tp=2),
             "fsdp2_sp2_ep2": dict(dp=1, fsdp=2, sp=2, ep=2)}


@pytest.fixture(scope="module", params=list(MOE_SPECS))
def moe_trained(request, tmp_path_factory):
    """3 train steps of f32 llama_tiny with 4 experts (top-2) on 8 gloo
    ranks and in JAX on 8 virtual devices, same MeshSpec, parameters and
    global batch [8, 64]."""
    spec_kw = MOE_SPECS[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    jc = jgpt.llama_tiny(dtype=jnp.float32, attention_impl="reference",
                         n_experts=4)
    tc = tgpt.llama_tiny(dtype=torch.float32, n_experts=4)
    jax_mesh = jmesh.build_mesh(jmesh.MeshSpec(**spec_kw).resolve(8),
                                devices=jax.devices()[:8])
    jm = jgpt.GPT(jc, mesh=jax_mesh)
    jopt = jtrain.make_optimizer(**OPT_KW)
    jstate = jtrain.init_train_state(jm, jopt, jax.random.PRNGKey(0),
                                     mesh=jax_mesh)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                   jstate.params), tc)
    np.savez(tmp / "params.npz", **{n: t.numpy() for n, t in state.items()})
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (8, 64),
                                             dtype=np.int32)
    np.savez(tmp / "tokens.npz", tokens=toks)
    ranks = torch_dist_worker.launch(
        torch_dist_worker.train_rank, 8, tmp, spec_kw,
        str(tmp / "params.npz"), str(tmp / "tokens.npz"), 3, OPT_KW,
        dict(n_experts=4))
    jstep = jtrain.make_train_step(jm, jopt, mesh=jax_mesh, donate=False)
    batch = {"tokens": jax.device_put(jnp.asarray(toks),
                                      jtrain.batch_shardings(jax_mesh))}
    want = {"losses": [], "grad_norms": [], "aux": []}
    for _ in range(3):
        jstate, m = jstep(jstate, batch)
        want["losses"].append(float(m["loss"]))
        want["grad_norms"].append(float(m["grad_norm"]))
        want["aux"].append(float(m["moe_aux_loss"]))
    want["eval"] = float(jtrain.eval_step_fn(jm, mesh=jax_mesh)(
        jstate.params, batch)["loss"])
    want["params"] = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params), tc)
    return ranks, want


def test_moe_trajectory_matches_jax_sharded(moe_trained):
    ranks, want = moe_trained
    for res in ranks:
        for key in ("losses", "grad_norms", "aux"):
            np.testing.assert_allclose(res[key], want[key], rtol=TRAJ_RTOL)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
    for name, w in want["params"].items():
        w = w.numpy()
        for res in ranks:
            np.testing.assert_array_equal(res[f"param/{name}"],
                                          ranks[0][f"param/{name}"])
        err = np.linalg.norm(ranks[0][f"param/{name}"] - w)
        assert err <= PARAM_NORM_RTOL * np.linalg.norm(w), name


def test_moe_eval_step_matches_jax_sharded(moe_trained):
    ranks, want = moe_trained
    for res in ranks:
        np.testing.assert_allclose(float(res["eval_loss"]), want["eval"],
                                   rtol=TRAJ_RTOL)


def _mesh1(config_kw, tmp_path):
    """The model without a mesh and through the process-mesh path on one
    gloo rank, 3 steps from the same weights and tokens, on the rank's
    thread count (bit-equality is claimed for equal sums)."""
    torch.set_num_threads(torch_dist_worker.THREADS)
    cfg = tgpt.llama_tiny(dtype=torch.float32, **config_kw)
    ref = tgpt.GPT(cfg, device="cpu", seed=0)
    np.savez(tmp_path / "params.npz",
             **{n: p.detach().numpy() for n, p in ref.named_parameters()})
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 64))
    np.savez(tmp_path / "tokens.npz", tokens=toks)
    opt = ttrain.make_optimizer(**OPT_KW)
    state = ttrain.init_train_state(ref, opt, device="cpu")
    step = ttrain.make_train_step(ref, opt, device="cpu")
    want = {"losses": [], "grad_norms": [], "aux": []}
    for _ in range(3):
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        want["losses"].append(float(m["loss"]))
        want["grad_norms"].append(float(m["grad_norm"]))
        want["aux"].append(float(m["moe_aux_loss"]))
    (res,) = torch_dist_worker.launch(
        torch_dist_worker.mesh1_rank, 1, tmp_path, config_kw,
        str(tmp_path / "params.npz"), str(tmp_path / "tokens.npz"), 3,
        OPT_KW)
    return ref, want, res


@pytest.mark.parametrize("remat_policy", ["full", "dots"])
def test_moe_on_a_mesh_of_one_rank_equals_no_mesh(remat_policy, tmp_path):
    """The process-mesh path at one rank (FSDP2, the routing gather, the
    batch-group sum, the ep and tp pairs, the clip's sums over ep): every
    collective is a copy, so losses, grad norms, load-balance losses and
    parameters equal the no-mesh model's bit for bit; each collective runs
    its exact count a step (L layers, the block recompute repeating the
    forward's: gpt's tp pair in the attention half and the head, moe's
    pairs and sums once per layer each, copy_to_ep twice)."""
    ref, want, res = _mesh1(dict(n_experts=4, remat_policy=remat_policy),
                            tmp_path)
    for key in ("losses", "grad_norms", "aux"):
        np.testing.assert_array_equal(res[key], want[key])
    for n, p in ref.named_parameters():
        np.testing.assert_array_equal(res[f"param/{n}"], p.detach().numpy())
    L = ref.config.n_layers
    passes = 2          # the forward and the block checkpoint's recompute
    calls = dict(zip(res["call_names"].tolist(), res["calls"].tolist()))
    assert calls == {
        "gpt.copy_to_tp": L * passes + 1, "gpt.reduce_from_tp": L * passes + 1,
        "gpt.gather_from_tp": 1,
        "moe.copy_to_tp": L * passes, "moe.reduce_from_tp": L * passes,
        "moe.copy_to_ep": 2 * L * passes, "moe.reduce_from_ep": L * passes,
        "moe.sum_over_batch": L * passes, "moe.gather_over_batch": L * passes,
        "training._global_norms": 1}
