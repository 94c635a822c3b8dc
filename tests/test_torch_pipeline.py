"""Port parity: GPipe over the pp mesh axis (`ray_tpu_torch.parallel.pipeline`).

JAX's pipeline (``ray_tpu/models/gpt.py:_pipeline_blocks``) stage-stacks
the blocks over pp and carries M microbatches through the stages in M + P
- 1 steps; on the CPU it and the port both run the reference attention.
The same seeded numpy inputs and JAX's weights (through `params_from_jax`,
stage-stacked ones included) go through:

* the logits at JAX's dp 2 x pp 2 x tp 2 (tests/test_models_parallel.py:
  68-81) on 8 gloo ranks (tests/torch_dist_worker.py) against JAX's
  pipeline on 8 virtual devices;
* 3 f32 train steps of llama_tiny with 4 microbatches at JAX's dp 1 x
  fsdp 2 x pp 2 x tp 2 (:84-98) against JAX's sharded step;
* the GPT-2 family (tied table, learned positions) at pp 2 on 2 ranks:
  logits, loss and gradients against JAX on one device;
* a loopback pp mesh (every stage in one process) against no mesh, JAX's
  refusals (:101-111), the stage-stacked params, and `dryrun_multichip`.
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
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models import training as ttrain
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.parallel import AXIS_ORDER, MeshSpec, loopback_mesh

torch.set_num_threads(torch_dist_worker.THREADS)

# f32 on both sides. Logits of the pipeline per element (O(0.1) values;
# JAX's own test bounds its bf16 pipeline at 2e-2); losses and grad norms
# per step relative, the gradients of one step and the parameters after 3
# steps normwise, as on the dense meshes (tests/test_torch_parallel.py;
# the parameters read 3.9e-6 at dp 1 x fsdp 2 x pp 2 x tp 2).
LOGITS_ATOL = 1e-5
TRAJ_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-5
PARAM_NORM_RTOL = 1e-5
# a loopback pipe against no mesh: the same ops on microbatches of the
# rows, the loss summed over microbatches
LOOPBACK_ATOL = 1e-6
OPT_KW = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50)

GPT2_FAMILY = dict(vocab_size=512, n_layers=2, d_model=128, n_heads=4,
                   max_seq_len=128, activation="gelu", norm="layernorm",
                   positions="learned", tie_embeddings=True)


def _tokens(vocab, b, s=64):
    return np.random.default_rng(1).integers(0, vocab, (b, s),
                                             dtype=np.int32)


def _save(path, jparams, tc):
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tc)
    np.savez(path, **{n: t.numpy() for n, t in state.items()})
    return state


def _coord(res, axis):
    return int(res["coords"][AXIS_ORDER.index(axis)])


def test_pipeline_logits_match_jax(tmp_path):
    """dp 2 x pp 2 x tp 2: JAX's pipeline logits (its stage-stacked
    parameters converted) against the port's on 8 gloo ranks, each rank
    holding its rows and vocab columns, every pp rank the last stage's."""
    spec_kw = dict(dp=2, pp=2, tp=2)
    jc = jgpt.llama_tiny(dtype=jnp.float32, attention_impl="reference")
    tc = tgpt.llama_tiny(dtype=torch.float32)
    jax_mesh = jmesh.build_mesh(jmesh.MeshSpec(**spec_kw).resolve(8),
                                devices=jax.devices()[:8])
    jm = jgpt.GPT(jc, mesh=jax_mesh)
    params = jm.init(jax.random.PRNGKey(0))
    assert params["blocks"]["wq"].shape[:2] == (2, 1)      # [P, L/P, ...]
    _save(tmp_path / "params.npz", params, tc)
    toks = _tokens(tc.vocab_size, 4)
    np.savez(tmp_path / "tokens.npz", tokens=toks)
    logits = np.asarray(jm.apply(params, jnp.asarray(toks)))
    ranks = torch_dist_worker.launch(
        torch_dist_worker.forward_rank, 8, tmp_path, spec_kw, {},
        str(tmp_path / "params.npz"), str(tmp_path / "tokens.npz"),
        "llama_tiny")
    half = tc.vocab_size // 2
    for res in ranks:
        dp, tp = _coord(res, "dp"), _coord(res, "tp")
        np.testing.assert_allclose(
            res["logits"], logits[dp * 2:dp * 2 + 2, :, tp * half:
                                  (tp + 1) * half], atol=LOGITS_ATOL, rtol=0)


@pytest.fixture(scope="module")
def pipeline_trained(tmp_path_factory):
    """3 train steps of f32 llama_tiny with 4 microbatches at dp 1 x fsdp 2
    x pp 2 x tp 2 on 8 gloo ranks and in JAX on 8 virtual devices, same
    parameters and global batch [8, 64]."""
    spec_kw = dict(dp=1, fsdp=2, pp=2, tp=2)
    tmp = tmp_path_factory.mktemp("pp")
    jc = jgpt.llama_tiny(dtype=jnp.float32, attention_impl="reference",
                         pp_microbatches=4)
    tc = tgpt.llama_tiny(dtype=torch.float32, pp_microbatches=4)
    jax_mesh = jmesh.build_mesh(jmesh.MeshSpec(**spec_kw).resolve(8),
                                devices=jax.devices()[:8])
    jm = jgpt.GPT(jc, mesh=jax_mesh)
    jopt = jtrain.make_optimizer(**OPT_KW)
    jstate = jtrain.init_train_state(jm, jopt, jax.random.PRNGKey(0),
                                     mesh=jax_mesh)
    _save(tmp / "params.npz", jstate.params, tc)
    toks = _tokens(tc.vocab_size, 8)
    np.savez(tmp / "tokens.npz", tokens=toks)
    ranks = torch_dist_worker.launch(
        torch_dist_worker.train_rank, 8, tmp, spec_kw,
        str(tmp / "params.npz"), str(tmp / "tokens.npz"), 3, OPT_KW,
        dict(pp_microbatches=4))
    jstep = jtrain.make_train_step(jm, jopt, mesh=jax_mesh, donate=False)
    batch = {"tokens": jax.device_put(jnp.asarray(toks),
                                      jtrain.batch_shardings(jax_mesh))}
    want = {"losses": [], "grad_norms": [], "tokens": []}
    for _ in range(3):
        jstate, m = jstep(jstate, batch)
        want["losses"].append(float(m["loss"]))
        want["grad_norms"].append(float(m["grad_norm"]))
        want["tokens"].append(float(m["tokens"]))
    want["eval"] = float(jtrain.eval_step_fn(jm, mesh=jax_mesh)(
        jstate.params, batch)["loss"])
    want["params"] = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params), tc)
    return ranks, want


def test_pipeline_trajectory_matches_jax_sharded(pipeline_trained):
    ranks, want = pipeline_trained
    for res in ranks:
        np.testing.assert_allclose(res["losses"], want["losses"],
                                   rtol=TRAJ_RTOL)
        np.testing.assert_allclose(res["grad_norms"], want["grad_norms"],
                                   rtol=TRAJ_RTOL)
        np.testing.assert_array_equal(res["tokens"], want["tokens"])
        np.testing.assert_array_equal(res["aux"], 0.0)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
    for name, w in want["params"].items():
        w = w.numpy()
        for res in ranks:
            np.testing.assert_array_equal(res[f"param/{name}"],
                                          ranks[0][f"param/{name}"])
        err = np.linalg.norm(ranks[0][f"param/{name}"] - w)
        assert err <= PARAM_NORM_RTOL * np.linalg.norm(w), name


def test_pipeline_eval_step_matches_jax_sharded(pipeline_trained):
    ranks, want = pipeline_trained
    for res in ranks:
        np.testing.assert_allclose(float(res["eval_loss"]), want["eval"],
                                   rtol=TRAJ_RTOL)


def test_gpt2_family_pp2_matches_jax(tmp_path):
    """The GPT-2 family at pp 2 on 2 gloo ranks ("dots" remat): the tied
    table feeds stage 0's lookup and the last stage's head, learned
    positions are added on stage 0. Every rank's logits and the global loss
    against JAX on one device, and every gradient (the tied table's summed
    over pp) against `jax.grad`."""
    cfg_kw = dict(GPT2_FAMILY, remat_policy="dots")
    jc = jgpt.GPTConfig(dtype=jnp.float32, attention_impl="reference",
                        **cfg_kw)
    tc = tgpt.GPTConfig(dtype=torch.float32, **cfg_kw)
    jm = jgpt.GPT(jc)
    params = jm.init(jax.random.PRNGKey(0))
    _save(tmp_path / "params.npz", params, tc)
    toks = _tokens(tc.vocab_size, 2)
    np.savez(tmp_path / "tokens.npz", tokens=toks)
    ranks = torch_dist_worker.launch(
        torch_dist_worker.forward_rank, 2, tmp_path, dict(dp=1, pp=2),
        cfg_kw, str(tmp_path / "params.npz"), str(tmp_path / "tokens.npz"))
    logits = np.asarray(jm.apply(params, jnp.asarray(toks)))
    (loss, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(
        params, {"tokens": jnp.asarray(toks)})
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads), tc)
    for res in ranks:
        np.testing.assert_allclose(res["logits"], logits, atol=LOGITS_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(float(res["global_loss"]), float(loss),
                                   rtol=TRAJ_RTOL)
        for name, want in grads.items():
            want = want.numpy()
            err = np.linalg.norm(res[f"grad/{name}"] - want)
            assert err <= GRAD_NORM_RTOL * np.linalg.norm(want), name


@pytest.mark.parametrize("micro", [0, 4])
def test_loopback_pipeline_equals_no_mesh(micro):
    """llama_tiny on `loopback_mesh(MeshSpec(pp=2))` (both stages here, the
    same schedule and backward as on ranks) against the same weights
    without a mesh: logits, loss, metrics, every gradient, and a train
    step's grad norm."""
    cfg = tgpt.llama_tiny(dtype=torch.float32, pp_microbatches=micro)
    toks = torch.tensor(_tokens(cfg.vocab_size, 4))
    out = {}
    for name, mesh in (("none", None),
                       ("loopback", loopback_mesh(MeshSpec(pp=2)))):
        m = tgpt.GPT(cfg, device="cpu", seed=0, mesh=mesh)
        if mesh is None:
            loss, metrics = m.loss({"tokens": toks})
            loss.backward()
        else:
            assert m.pp_stages == 2
            loss, metrics = m.pipeline_loss({"tokens": toks}, backward=True)
        grads = {n: p.grad for n, p in m.named_parameters()}
        with torch.no_grad():
            logits = m.apply(toks)
        opt = ttrain.make_optimizer(**OPT_KW)
        state = ttrain.init_train_state(m, opt, device="cpu", mesh=mesh)
        _, step_metrics = ttrain.make_train_step(m, opt, device="cpu",
                                                 mesh=mesh)(
            state, {"tokens": toks})
        out[name] = (logits, loss.detach(), metrics, grads, step_metrics)
    (l0, loss0, met0, g0, s0), (l1, loss1, met1, g1, s1) = (out["none"],
                                                            out["loopback"])
    torch.testing.assert_close(l1, l0, atol=LOOPBACK_ATOL, rtol=0)
    torch.testing.assert_close(loss1, loss0, atol=LOOPBACK_ATOL, rtol=0)
    torch.testing.assert_close(met1["ppl_log"], met0["ppl_log"],
                               atol=LOOPBACK_ATOL, rtol=0)
    assert met1["tokens"] == met0["tokens"]
    for n, g in g0.items():
        torch.testing.assert_close(g1[n], g, atol=LOOPBACK_ATOL, rtol=0)
    torch.testing.assert_close(s1["grad_norm"], s0["grad_norm"],
                               atol=LOOPBACK_ATOL, rtol=0)


def test_pipeline_refusals_match_jax():
    """JAX's refusals (tests/test_models_parallel.py:101-111) on a pp mesh:
    layers that do not divide into the stages, and experts with a pipeline;
    and a batch that does not divide into the microbatches."""
    mesh = loopback_mesh(MeshSpec(pp=2))
    cfg3 = dataclasses.replace(tgpt.llama_tiny(), n_layers=3)
    with pytest.raises(ValueError, match="divide into pp=2"):
        tgpt.GPT(cfg3, device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="EP\\+PP"):
        tgpt.GPT(tgpt.llama_tiny(n_experts=2), device="cpu", mesh=mesh)
    m = tgpt.GPT(tgpt.llama_tiny(dtype=torch.float32, pp_microbatches=4),
                 device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="batch 6 must divide into 4"):
        m.loss({"tokens": torch.zeros(6, 16, dtype=torch.long)})


def test_params_from_jax_takes_stage_stacked_params():
    """JAX's init on a pp mesh reshapes each block leaf [L, ...] into [P,
    L/P, ...] (ray_tpu/models/gpt.py:238-244); converted, it is the state of
    the unstacked init, tensor for tensor. A leaf of neither layout
    raises."""
    jc = dataclasses.replace(jgpt.llama_tiny(dtype=jnp.float32), n_layers=4)
    tc = dataclasses.replace(tgpt.llama_tiny(dtype=torch.float32),
                             n_layers=4)
    jax_mesh = jmesh.build_mesh(jmesh.MeshSpec(dp=2, pp=4).resolve(8),
                                devices=jax.devices()[:8])
    stacked = jgpt.GPT(jc, mesh=jax_mesh).init(jax.random.PRNGKey(0))
    plain = jgpt.GPT(jc).init(jax.random.PRNGKey(0))
    assert stacked["blocks"]["wo"].shape[:2] == (4, 1)
    a = params_from_jax(jax.tree_util.tree_map(np.asarray, stacked), tc)
    b = params_from_jax(jax.tree_util.tree_map(np.asarray, plain), tc)
    assert a.keys() == b.keys()
    for n in a:
        assert torch.equal(a[n], b[n]), n
    bad = jax.tree_util.tree_map(np.asarray, plain)
    bad["blocks"]["wq"] = bad["blocks"]["wq"][:3]
    with pytest.raises(ValueError, match="blocks/wq"):
        params_from_jax(bad, tc)


def test_dryrun_multichip_8(capsys):
    """The port's `dryrun_multichip(8)`: one train step at tp/sp/fsdp, at
    pp/tp and at ep/tp with 4 experts on 8 gloo ranks, one line each, every
    loss in (0, 20)."""
    from ray_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(8)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "dryrun tp/sp/fsdp", "dryrun pp/tp", "dryrun ep/tp"]
    assert all(ln.endswith(" ok") for ln in lines)
    assert "'pp': 2" in lines[1] and "'ep': 2" in lines[2]
