"""ray_tpu_torch.rl on the port's runtime: PPO's smoke test, the learner
actors and the runner actors (analogs of tests/test_rl.py:95-125).

The learners run in actors or in process on the CPU here (``device="cpu"``;
on the card they take a GPU slot each), the runners are actors that sample
on the host. PPO's learning tests are in test_torch_rl_runtime_ppo.py,
IMPALA and DQN in test_torch_rl_runtime_offpolicy.py.
"""

import jax
import numpy as np
import pytest

import ray_tpu_torch as rt
import torch_dist_worker
from ray_tpu_torch import rl
from ray_tpu_torch.rl import sample_batch as SB

torch_dist_worker.settle()



@pytest.fixture(scope="module", autouse=True)
def runtime():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return rl.SampleBatch({
        SB.OBS: rng.normal(size=(n, 4)).astype(np.float32),
        SB.ACTIONS: rng.integers(0, 2, n).astype(np.int32),
        SB.LOGP: np.full(n, -0.69, np.float32),
        SB.ADVANTAGES: rng.normal(size=n).astype(np.float32),
        SB.VALUE_TARGETS: rng.normal(size=n).astype(np.float32),
    })


def test_ppo_smoke_random_env():
    algo = (rl.PPOConfig()
            .environment(lambda: rl.RandomEnv(episode_len=20))
            .rollouts(num_rollout_workers=1, rollout_fragment_length=64)
            .training(num_sgd_iter=2, sgd_minibatch_size=32, device="cpu")
            .build())
    result = algo.train()
    assert result["num_env_steps_sampled"] == 64
    assert "learner/total_loss" in result
    assert result["num_learner_updates"] == 4
    algo.stop()


def test_learner_group_multi():
    m = rl.DiscretePolicyModule(4, 2, hidden=(8,))
    group = rl.LearnerGroup(m, num_learners=2, lr=1e-3, device="cpu")
    stats = group.update(_batch())
    assert "total_loss" in stats
    w = group.get_weights()
    assert set(w) == {"torso", "pi", "vf"}
    assert isinstance(w["pi"]["w"], np.ndarray)
    # counted in the learners' processes: an MLP launches no flash kernel
    zero = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert group.kernel_launches(reset=True) == zero
    assert group.kernel_launches() == zero
    group.shutdown()


def test_learner_group_averages_as_jax_does():
    """Two learner actors on halves of a batch, then the mean of their
    weights in numpy: the same bits as two in-process learners and the
    mean of their weights as JAX's group takes it (``tree_map`` of
    ``np.mean``); both actors hold it afterwards. The comparison with
    JAX's learners is test_torch_rl_runtime_parity.py's."""
    batch = _batch()
    group = rl.LearnerGroup(rl.DiscretePolicyModule(4, 2, hidden=(8,)),
                            num_learners=2, lr=1e-3, device="cpu")
    group.update(batch)
    got = group.get_weights()
    second = rt.get(group._actors[1].get_weights.remote())
    group.shutdown()
    local = [rl.Learner(rl.DiscretePolicyModule(4, 2, hidden=(8,)),
                        lr=1e-3, device="cpu") for _ in range(2)]
    for learner, part in zip(local, (batch.slice(0, 32),
                                     batch.slice(32, 64))):
        learner.update(part)
    want = jax.tree_util.tree_map(lambda *ws: np.mean(np.stack(ws), axis=0),
                                  *[lr.get_weights() for lr in local])
    for t, w, s in zip(*(jax.tree_util.tree_leaves(x)
                         for x in (got, want, second)), strict=True):
        np.testing.assert_array_equal(t, w)
        np.testing.assert_array_equal(s, t)


def test_learner_resources_map_to_gpu_slots():
    """A learner on the card asks for one GPU slot; resources_per_learner
    maps CPU and GPU onto num_cpus and num_gpus."""
    from ray_tpu_torch.rl.learner import learner_actor_options

    assert learner_actor_options(None, "cuda") == {"num_gpus": 1}
    assert learner_actor_options(None, "cpu") == {}
    assert learner_actor_options({"CPU": 2, "GPU": 1, "x": 1}, "cuda") == {
        "num_cpus": 2, "num_gpus": 1, "resources": {"x": 1}}


def test_env_runner_actor_equals_in_process_runner():
    """`EnvRunner.remote` runs the in-process runner's body: the same
    weights and seed give the same batch; `collect_epsilon_greedy` puts
    its batch in the store and hands back the ref."""
    cfg = {"observation_size": 4, "action_size": 2, "hidden": (16,)}
    q = rl.QNetworkModule(**cfg)
    q.init_weights(3)
    weights = rl.params_to_jax(q.state_dict())
    local = rl.EnvRunner(rl.CartPoleEnv, cfg, num_envs=2, module_kind="q",
                         seed=7, device="cpu")
    actor = rl.EnvRunner.remote(rl.CartPoleEnv, cfg, num_envs=2,
                                module_kind="q", seed=7, device="cpu")
    want, _ = local.sample_epsilon_greedy(weights, 16, 0.3)
    [ref], count, stats = rt.get(actor.collect_epsilon_greedy.remote(
        weights, 16, 0.3))
    got = rt.get(ref)
    assert count == 32 and isinstance(stats["episode_rewards"], list)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rt.kill(actor)


def test_replay_buffer_as_remote():
    Buffer = rl.ReplayBuffer.as_remote()
    buf = Buffer.remote(8, seed=3)
    local = rl.ReplayBuffer(8, seed=3)
    for i in range(12):
        rt.get(buf.add.remote(i))
        local.add(i)
    assert rt.get(buf.sample.remote(5)) == local.sample(5)
    assert rt.get(buf.stats.remote())["size"] == 8
    rt.kill(buf)
