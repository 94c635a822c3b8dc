"""ray_tpu_torch.rl on the port's runtime: IMPALA and DQN (analogs of
tests/test_rl.py:174-212, :234-254 and :305-318), with the runners as
actors sampling on the host and the learners on the CPU here
(``device="cpu"``), in process or in learner actors. The learning test
holds JAX's bar: best episode_reward_mean >= 80 on CartPole within JAX's
iteration budget.
"""

import numpy as np
import pytest

import ray_tpu_torch as rt
import torch_dist_worker
from ray_tpu_torch import rl

torch_dist_worker.settle()


@pytest.fixture(scope="module", autouse=True)
def runtime():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def test_impala_smoke_random_env():
    algo = (rl.ImpalaConfig()
            .environment(lambda: rl.RandomEnv(episode_len=20))
            .rollouts(num_rollout_workers=2, rollout_fragment_length=32)
            .training(device="cpu")
            .build())
    result = algo.train()
    assert result["num_env_steps_sampled"] >= 32
    assert "learner/total_loss" in result
    algo.stop()


def test_impala_learns_cartpole():
    algo = (rl.ImpalaConfig()
            .environment(rl.CartPoleEnv)
            .rollouts(num_rollout_workers=2, rollout_fragment_length=256)
            .training(lr=2e-3, entropy_coeff=0.02, num_sgd_iter=6,
                      device="cpu")
            .learners(1)
            .build())
    best = -np.inf
    for _ in range(200):
        result = algo.train()
        r = result["episode_reward_mean"]
        if not np.isnan(r):
            best = max(best, r)
        if best >= 80:
            break
    algo.stop()
    assert best >= 80, f"IMPALA failed to learn CartPole: best={best}"


def test_impala_multi_learner():
    algo = (rl.ImpalaConfig()
            .environment(lambda: rl.RandomEnv(episode_len=20))
            .rollouts(num_rollout_workers=2, rollout_fragment_length=32)
            .training(device="cpu")
            .learners(2)
            .build())
    result = algo.train()
    assert "learner/total_loss" in result
    algo.stop()


def test_impala_vectorized_smoke():
    algo = (rl.ImpalaConfig()
            .environment(lambda: rl.RandomEnv(episode_len=16))
            .rollouts(num_rollout_workers=2, num_envs_per_worker=3,
                      rollout_fragment_length=32)
            .training(device="cpu")
            .build())
    result = algo.train()
    assert "learner/total_loss" in result
    assert result["num_env_steps_sampled"] % (3 * 32) == 0
    algo.stop()


@pytest.mark.parametrize("num_learners", [0, 1],
                         ids=["in_process", "learner_actor"])
def test_dqn_trains_past_learning_starts(num_learners):
    algo = (rl.DQNConfig()
            .environment(lambda: rl.RandomEnv(episode_len=20))
            .rollouts(num_rollout_workers=1, rollout_fragment_length=64)
            .training(learning_starts=64, train_batch_size=32,
                      updates_per_iter=4, target_update_freq=4,
                      device="cpu")
            .learners(num_learners)
            .build())
    saw_update = False
    for _ in range(4):
        result = algo.train()
        if result["num_updates"] > 0:
            assert np.isfinite(result["loss"])
            saw_update = True
    algo.stop()
    assert saw_update, "DQN never ran a learner update"


def test_dqn_vectorized_smoke():
    algo = (rl.DQNConfig()
            .environment(lambda: rl.RandomEnv(episode_len=10))
            .rollouts(num_rollout_workers=1, num_envs_per_worker=4,
                      rollout_fragment_length=32)
            .training(learning_starts=64, train_batch_size=32,
                      updates_per_iter=2, device="cpu")
            .build())
    upd = 0
    for _ in range(3):
        result = algo.train()
        upd += result["num_updates"]
    algo.stop()
    assert upd > 0


def test_dqn_refuses_several_learners():
    with pytest.raises(ValueError, match="1 learner"):
        rl.DQNConfig().learners(2)
