"""ray_tpu_torch.rl on the port's runtime: PPO's learning tests (analogs
of tests/test_rl.py:84-106 and :289-303), with the runners as actors
sampling on the host and the learner on the CPU here (``device="cpu"``),
in process or in a learner actor. Each holds JAX's bar: the best
episode_reward_mean reaches 80 on CartPole within JAX's iteration budget.
"""

import numpy as np
import pytest

import ray_tpu_torch as rt
import torch_dist_worker
from ray_tpu_torch import rl

torch_dist_worker.settle()

BAR = 80


@pytest.fixture(scope="module", autouse=True)
def runtime():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()


def _learn(algo, iterations, check=None):
    first, best = None, -np.inf
    for _ in range(iterations):
        result = algo.train()
        if check is not None:
            check(result)
        r = result["episode_reward_mean"]
        if not np.isnan(r):
            first = r if first is None else first
            best = max(best, r)
        if best >= BAR:
            break
    algo.stop()
    return first, best


@pytest.mark.parametrize("num_learners", [0, 1],
                         ids=["in_process", "learner_actor"])
def test_ppo_learns_cartpole(num_learners):
    """JAX's test with the learner in process, and (the card path's
    shape) in a learner actor."""
    algo = (rl.PPOConfig()
            .environment(rl.CartPoleEnv)
            .rollouts(num_rollout_workers=2, rollout_fragment_length=512)
            .training(num_sgd_iter=10, sgd_minibatch_size=256, lr=1e-3,
                      entropy_coeff=0.01, device="cpu")
            .learners(num_learners)
            .build())
    assert isinstance(algo.learner, rl.LearnerGroup) == bool(num_learners)
    first, best = _learn(algo, 40)
    assert first is not None
    assert best >= BAR, f"PPO failed to learn: first={first}, best={best}"


def test_ppo_vectorized_learns_cartpole():
    def check(result):
        assert result["num_env_steps_sampled"] == 4 * 256

    algo = (rl.PPOConfig()
            .environment(rl.CartPoleEnv)
            .rollouts(num_rollout_workers=1, num_envs_per_worker=4,
                      rollout_fragment_length=256)
            .training(num_sgd_iter=10, sgd_minibatch_size=256, lr=1e-3,
                      entropy_coeff=0.01, device="cpu")
            .learners(1)
            .build())
    _, best = _learn(algo, 40, check)
    assert best >= BAR, f"vectorized PPO failed to learn: best={best}"
