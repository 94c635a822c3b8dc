"""Port parity: ray_tpu_torch.train (TorchTrainer) against ray_tpu.train.

Analogs of tests/test_train.py's five trainer tests on the port's runtime;
a gang of 4 gloo workers that trains f32 llama_tiny at dp 2 x fsdp 2
against JAX's sharded step on as many of the suite's virtual CPU devices
(the bounds of tests/test_torch_parallel.py); and the same gang killed
after its step-2 sharded checkpoint (rank 1 exits), whose restart in fresh
processes resumes from that checkpoint and must take the uninterrupted
gang's trajectory bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
import torch_dist_worker
from ray_tpu.models import gpt as jgpt
from ray_tpu.models import training as jtrain
from ray_tpu.parallel import mesh as jmesh
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.train import (Checkpoint, CheckpointConfig, FailureConfig,
                                 RunConfig, ScalingConfig, TorchTrainer)

torch_dist_worker.settle()

# tests/test_torch_parallel.py's bounds: f32 on both sides, sums in other
# orders; losses and grad norms per step to 1e-5 relative, each parameter
# normwise to 1e-5 after the steps
TRAJ_RTOL = 1e-5
PARAM_NORM_RTOL = 1e-5
OPT_KW = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50)
GANG_SPEC = dict(dp=2, fsdp=2)
GANG_STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def runtime():
    rt.init(num_cpus=6)
    yield
    rt.shutdown()


# --- tests/test_train.py's five, on the port ----------------------------------

def test_fit_reports_metrics(tmp_path):
    def loop(config):
        from ray_tpu_torch import train
        ctx = train.get_context()
        for i in range(3):
            train.report({"loss": 1.0 / (i + 1),
                          "rank": ctx.get_world_rank(),
                          "local_rank": ctx.get_local_rank()})

    trainer = TorchTrainer(
        loop,
        train_loop_config={},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                     placement_strategy="PACK"),
        run_config=RunConfig(name="t1", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["loss"] == pytest.approx(1.0 / 3)
    assert len(result.metrics_history) == 3
    assert result.metrics["rank"] == 0
    assert result.metrics["local_rank"] == 0


def test_fit_persists_checkpoints(tmp_path):
    def loop(config):
        from ray_tpu_torch import train
        ctx = train.get_context()
        for i in range(2):
            ckpt = None
            if ctx.get_world_rank() == 0:
                ckpt = train.Checkpoint.from_dict({"step": i})
            train.report({"step": i}, checkpoint=ckpt)

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="t2", storage_path=str(tmp_path),
                             checkpoint_config=CheckpointConfig(
                                 num_to_keep=1)))
    result = trainer.fit()
    assert result.error is None
    assert result.checkpoint is not None
    assert result.checkpoint.to_dict() == {"step": 1}
    # num_to_keep=1: only one checkpoint dir remains
    dirs = [d for d in os.listdir(result.path)
            if d.startswith("checkpoint_")]
    assert len(dirs) == 1


def test_failure_restart_resumes_from_checkpoint(tmp_path):
    def loop(config):
        from ray_tpu_torch import train
        ctx = train.get_context()
        start = 0
        resume = train.get_checkpoint()
        if resume is not None:
            start = resume.to_dict()["step"] + 1
        for i in range(start, 4):
            ckpt = (train.Checkpoint.from_dict({"step": i})
                    if ctx.get_world_rank() == 0 else None)
            train.report({"step": i, "resumed": start > 0},
                         checkpoint=ckpt)
            if i == 1 and start == 0:
                raise RuntimeError("injected failure at step 1")

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="t3", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=2)))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["step"] == 3
    assert result.metrics["resumed"] is True


def test_failure_budget_exhausted(tmp_path):
    def loop():
        raise ValueError("always fails")

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="t4", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)))
    result = trainer.fit()
    assert result.error is not None


def test_torch_training_with_state_dict_checkpoint(tmp_path):
    def loop(config):
        import torch
        from ray_tpu_torch import train
        from ray_tpu_torch.models import (GPT, init_train_state, llama_tiny,
                                          make_optimizer, make_train_step)

        cfg = llama_tiny()
        model = GPT(cfg, device="cpu", seed=0)
        opt = make_optimizer(total_steps=4)
        state = init_train_state(model, opt, device="cpu")
        step = make_train_step(model, opt, device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                               generator=torch.Generator().manual_seed(1))
        for i in range(2):
            state, metrics = step(state, {"tokens": tokens})
            ckpt = train.Checkpoint.from_state_dict(state)
            train.report({"loss": float(metrics["loss"])}, checkpoint=ckpt)
        # the last checkpoint restores into a fresh state of the model
        fresh = init_train_state(GPT(cfg, device="cpu", seed=5), opt,
                                 device="cpu")
        ckpt.to_state_dict(template=fresh)
        assert fresh.step == 2 and fresh.opt_state["count"] == 2
        for n, p in state.params.items():
            assert torch.equal(fresh.params[n], p), n
            assert torch.equal(fresh.opt_state["nu"][n],
                               state.opt_state["nu"][n]), n

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="t5", storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.error is None
    assert result.metrics["loss"] > 0
    restored = result.checkpoint.to_state_dict()
    assert int(restored["step"]) == 2 and int(restored["count"]) == 2
    assert "tok_embed" in restored["params"]
    assert set(restored["mu"]) == set(restored["params"])


def test_use_gpu_is_the_default_and_needs_slots(tmp_path):
    """Like every entry point, the trainer asks for the card unless told
    not to: with no GPU slots in the cluster it refuses at once."""
    def loop():
        pass

    result = None
    with pytest.raises(RuntimeError, match="use_gpu=False"):
        result = TorchTrainer(loop, run_config=RunConfig(
            name="nogpu", storage_path=str(tmp_path))).fit()
    assert result is None


def test_use_gpu_workers_bind_their_card(tmp_path):
    """use_gpu: one GPU slot per worker's bundle, and a worker with a slot
    joins the group over NCCL on the card its slot names, never gloo in
    its place: with slots that no card backs (this runtime counts two),
    the rendezvous fails in CUDA and the budget runs out."""
    assert ScalingConfig().bundle() == {"CPU": 1.0, "GPU": 1.0}
    assert ScalingConfig(use_gpu=False).bundle() == {"CPU": 1.0}

    def loop():
        pass

    rt.shutdown()
    rt.init(num_cpus=4, num_gpus=2)
    try:
        trainer = TorchTrainer(
            loop, scaling_config=ScalingConfig(num_workers=2,
                                               placement_strategy="PACK"),
            run_config=RunConfig(name="gpu", storage_path=str(tmp_path)))
        result = trainer.fit()
    finally:
        rt.shutdown()
        rt.init(num_cpus=6)
    assert result.error is not None
    assert len(trainer.failures) == 1
    assert "CUDA" in trainer.failures[0] or "cuda" in trainer.failures[0]


# --- a gang of 4 gloo workers against JAX's sharded step -----------------------

@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """JAX's sharded steps on 4 virtual devices, and the port's 4-worker
    gang uninterrupted and killed-and-resumed, from the same parameters
    and tokens."""
    tmp = tmp_path_factory.mktemp("gang")
    world = 4
    jc = jgpt.llama_tiny(dtype=jnp.float32, attention_impl="reference")
    tc = tgpt.llama_tiny(dtype=torch.float32)
    jax_mesh = jmesh.build_mesh(jmesh.MeshSpec(**GANG_SPEC).resolve(world),
                                devices=jax.devices()[:world])
    jm = jgpt.GPT(jc, mesh=jax_mesh)
    jopt = jtrain.make_optimizer(**OPT_KW)
    jstate = jtrain.init_train_state(jm, jopt, jax.random.PRNGKey(0),
                                     mesh=jax_mesh)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                   jstate.params), tc)
    np.savez(tmp / "params.npz", **{n: t.numpy() for n, t in state.items()})
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (4, 64),
                                             dtype=np.int32)
    np.savez(tmp / "tokens.npz", tokens=toks)
    jstep = jtrain.make_train_step(jm, jopt, mesh=jax_mesh, donate=False)
    batch = {"tokens": jax.device_put(jnp.asarray(toks),
                                      jtrain.batch_shardings(jax_mesh))}
    jl, jg = [], []
    for _ in range(GANG_STEPS):
        jstate, m = jstep(jstate, batch)
        jl.append(float(m["loss"]))
        jg.append(float(m["grad_norm"]))
    jparams = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params), tc)

    def fit(name, **kw):
        config = dict(spec=GANG_SPEC, params=str(tmp / "params.npz"),
                      tokens=str(tmp / "tokens.npz"), opt=OPT_KW,
                      steps=GANG_STEPS, ckpt_at=(2,),
                      out=str(tmp / f"{name}.npz"), **kw)
        result = TorchTrainer(
            torch_dist_worker.gang_loop, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=world, use_gpu=False,
                                         placement_strategy="PACK"),
            run_config=RunConfig(name=name, storage_path=str(tmp),
                                 failure_config=FailureConfig(
                                     max_failures=1))).fit()
        assert result.error is None, result.error
        return result, dict(np.load(tmp / f"{name}.npz"))

    whole = fit("whole")
    resumed = fit("resumed", die_step=2, die_rank=1)
    return (jl, jg, jparams), whole, resumed


def test_gang_matches_jax_sharded_step(gang):
    (jl, jg, jparams), (result, params), _ = gang
    hist = result.metrics_history
    assert [h["step"] for h in hist] == list(range(1, GANG_STEPS + 1))
    np.testing.assert_allclose([h["loss"] for h in hist], jl,
                               rtol=TRAJ_RTOL)
    np.testing.assert_allclose([h["grad_norm"] for h in hist], jg,
                               rtol=TRAJ_RTOL)
    assert hist[-1]["loss"] < hist[0]["loss"]
    for name, want in jparams.items():
        want = want.numpy()
        err = np.linalg.norm(params[name] - want)
        assert err <= PARAM_NORM_RTOL * np.linalg.norm(want), name


def test_killed_gang_resumes_bit_equal(gang):
    """Rank 1 exits after the step-2 sharded checkpoint; the new gang
    (fresh processes, a new rendezvous file) restores every rank's shards
    of the parameters and Adam moments, the step and the count, and takes
    steps 3 and 4 exactly as the uninterrupted gang took them."""
    _, (whole, whole_params), (resumed, resumed_params) = gang
    hist = resumed.metrics_history
    assert [(h["step"], h["attempt"]) for h in hist] == [
        (1, 0), (2, 0), (3, 1), (4, 1)]
    for got, want in zip(hist, whole.metrics_history):
        assert (got["loss"], got["grad_norm"]) == (want["loss"],
                                                   want["grad_norm"])
    assert set(resumed_params) == set(whole_params)
    for name, want in whole_params.items():
        np.testing.assert_array_equal(resumed_params[name], want,
                                      err_msg=name)
    # the restart point was persisted: the sharded directory and its files
    ckpt = Checkpoint(os.path.join(resumed.path, "checkpoint_000000"))
    assert ckpt.sharded and ckpt.get_metrics()["step"] == 2
