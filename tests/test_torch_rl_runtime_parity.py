"""ray_tpu_torch.rl on the port's runtime against ray_tpu.rl on JAX's, on
the same inputs, on the CPU.

Each side runs on its own runtime, the port's first: ``LearnerGroup`` with
two learner actors on one batch (the split and the mean of the weights),
one ``PPO.train`` with a learner actor (the shuffle, the minibatches and
the group's updates), JAX's fed the batch that the port's runner sampled,
and one ``DQN.train`` with its learner in an actor against JAX's
in-process learner (the epsilon-greedy sampling at epsilon 1, the replay
actor's and the algorithm's draws, the updates and a target sync). JAX's
side starts from the port's initial weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch as rt
import torch_dist_worker
import torch_runtime_tasks as T
from ray_tpu.rl import dqn as jdqn
from ray_tpu.rl import learner as jlearner
from ray_tpu.rl import module as jmodule
from ray_tpu.rl import ppo as jppo
from ray_tpu.rl import sample_batch as jsb
from ray_tpu_torch import rl
from ray_tpu_torch.rl import sample_batch as SB

torch_dist_worker.settle()

# test_torch_rl.py's bounds for one learner: stats to 1e-5 relative,
# parameters normwise per tensor to 2e-6 of JAX's. Through the group's mean
# of two learners each bound scales with the learners' own values, not the
# mean's: the two halves of a batch can move a tensor in opposite
# directions (Adam's first step is about lr * sign(g)), and then the mean
# is a residue at rounding level.
STATS_RTOL = 1e-5
PARAM_RTOL = 2e-6
# PPO's pg_loss is the mean of ratio * advantage over a minibatch whose
# advantages the loss standardizes (mean 0, std 1): terms of about unit
# size that cancel, so its rounding is held at their scale, not at the
# value's (after PPO.train's 4 updates: 1.3e-7 apart at -1.4e-3).
TERM_SCALE = {"learner/pg_loss": 1.0}

MODULE = {"observation_size": 4, "action_size": 2, "hidden": (16,)}
PPO_SETTINGS = dict(num_sgd_iter=2, sgd_minibatch_size=32, lr=1e-3,
                    entropy_coeff=0.01)
DQN_SETTINGS = dict(hidden=(16,), fragment_length=64, learning_starts=64,
                    updates_per_iter=4, train_batch_size=32,
                    target_update_freq=2, buffer_capacity=1000)


def _batch(n=64, seed=0):
    """test_torch_rl.py's PPO batch: behaviour log-probs away from the
    policy's, so that no stat of the update cancels to rounding level."""
    rng = np.random.default_rng(seed)
    return {
        SB.OBS: rng.normal(size=(n, 4)).astype(np.float32),
        SB.ACTIONS: rng.integers(0, 2, n).astype(np.int32),
        SB.LOGP: (np.log(0.5) + 0.3 * rng.normal(size=n)).astype(np.float32),
        SB.ADVANTAGES: rng.normal(size=n).astype(np.float32),
        SB.VALUE_TARGETS: rng.normal(size=n).astype(np.float32),
    }


def _port_side():
    out = {}
    rt.init(num_cpus=4)
    try:
        group = rl.LearnerGroup(rl.DiscretePolicyModule(**MODULE),
                                num_learners=2, lr=1e-3, device="cpu")
        out["group_w0"] = group.get_weights()
        out["group_stats"] = group.update(rl.SampleBatch(_batch()))
        out["group_w1"] = [rt.get(a.get_weights.remote())
                           for a in group._actors]
        group.shutdown()

        algo = (rl.PPOConfig().environment(rl.CartPoleEnv)
                .rollouts(num_rollout_workers=1, rollout_fragment_length=64)
                .training(hidden=MODULE["hidden"], device="cpu",
                          **PPO_SETTINGS)
                .learners(1).build())
        out["ppo_w0"] = algo.get_weights()
        # the batch the algorithm's runner samples: a runner actor of the
        # same seed on the same weights
        twin = rl.EnvRunner.remote(rl.CartPoleEnv, MODULE, seed=0,
                                   device="cpu")
        out["ppo_sample"] = rt.get(twin.sample.remote(out["ppo_w0"], 64))
        rt.kill(twin)
        out["ppo_result"] = algo.train()
        out["ppo_w1"] = algo.get_weights()
        algo.stop()

        algo = (rl.DQNConfig().environment(rl.CartPoleEnv)
                .training(device="cpu", **DQN_SETTINGS)
                .learners(1).build())
        out["dqn_w0"] = algo.get_weights()
        out["dqn_result"] = algo.train()
        out["dqn_w1"] = algo.get_weights()
        algo.stop()
    finally:
        rt.shutdown()
    return out


def _jax_side(port):
    out = {}
    ray_tpu.init(num_cpus=4)
    try:
        group = jlearner.LearnerGroup(jmodule.DiscretePolicyModule(**MODULE),
                                      num_learners=2, lr=1e-3)
        ray_tpu.get([a.set_weights.remote(port["group_w0"])
                     for a in group._actors])
        out["group_stats"] = group.update(jsb.SampleBatch(_batch()))
        out["group_w1"] = [ray_tpu.get(a.get_weights.remote())
                           for a in group._actors]
        group.shutdown()
        # what JAX's group averages: JAX learners on the two halves
        out["group_parts"] = []
        for lo, hi in ((0, 32), (32, 64)):
            learner = jlearner.Learner(
                jmodule.DiscretePolicyModule(**MODULE), lr=1e-3)
            learner.set_weights(port["group_w0"])
            stats = learner.update(jsb.SampleBatch(_batch()).slice(lo, hi))
            out["group_parts"].append((stats, learner.get_weights()))

        algo = (jppo.PPOConfig().environment(jppo.CartPoleEnv)
                .rollouts(num_rollout_workers=1, rollout_fragment_length=64)
                .training(hidden=MODULE["hidden"], **PPO_SETTINGS)
                .learners(1).build())
        ray_tpu.get([a.set_weights.remote(port["ppo_w0"])
                     for a in algo.learner._actors])
        for w in algo.workers:
            ray_tpu.kill(w)
        algo.workers = [ray_tpu.remote(T.FixedSampler).remote(
            *port["ppo_sample"])]
        out["ppo_result"] = algo.train()
        out["ppo_w1"] = algo.get_weights()
        algo.stop()

        algo = (jdqn.DQNConfig().environment(jppo.CartPoleEnv)
                .training(**DQN_SETTINGS).build())
        params = jax.tree_util.tree_map(jnp.asarray, port["dqn_w0"])
        algo.learner.params = params
        algo.learner.target_params = params
        algo.learner.opt_state = algo.learner.opt.init(params)
        out["dqn_result"] = algo.train()
        out["dqn_w1"] = algo.get_weights()
        algo.stop()
    finally:
        ray_tpu.shutdown()
    return out


@pytest.fixture(scope="module")
def runs():
    port = _port_side()
    return port, _jax_side(port)


def _assert_params_close(got, want, parts=()):
    """Normwise per tensor within PARAM_RTOL of the larger of JAX's tensor
    and the mean of the norms of the `parts` it averages."""
    leaves = [jax.tree_util.tree_leaves(w) for w in parts]
    for i, ((path, p), (_, j)) in enumerate(zip(
            jax.tree_util.tree_leaves_with_path(got),
            jax.tree_util.tree_leaves_with_path(want), strict=True)):
        assert p.shape == j.shape, path
        scale = max([np.linalg.norm(j)] + [np.mean(
            [np.linalg.norm(ls[i]) for ls in leaves])] * bool(leaves))
        err = np.linalg.norm(np.asarray(p) - np.asarray(j))
        assert err <= PARAM_RTOL * scale, (path, err, scale)


def _assert_stats_close(got, want, keys, parts=()):
    """Each stat within STATS_RTOL of the largest of JAX's value, the mean
    of the magnitudes of the `parts` it averages and its TERM_SCALE."""
    for k in keys:
        scale = max([abs(want[k]), TERM_SCALE.get(k, 0.0)]
                    + [np.mean([abs(s[k]) for s in parts])] * bool(parts))
        assert abs(got[k] - want[k]) <= STATS_RTOL * scale, (
            k, got[k], want[k], scale)


def test_learner_group_equals_jax_learner_group(runs):
    port, jax_ = runs
    stats, weights = zip(*jax_["group_parts"])
    _assert_stats_close(port["group_stats"], jax_["group_stats"],
                        jax_["group_stats"], stats)
    for got, want in zip(port["group_w1"], jax_["group_w1"], strict=True):
        _assert_params_close(got, want, weights)
    # the mean reached both learners
    for a, b in zip(*(jax.tree_util.tree_leaves(w)
                      for w in port["group_w1"])):
        np.testing.assert_array_equal(a, b)


def test_ppo_train_equals_jax_on_the_sampled_batch(runs):
    port, jax_ = runs
    got, want = port["ppo_result"], jax_["ppo_result"]
    learner_keys = [k for k in want if k.startswith("learner/")]
    assert learner_keys and set(learner_keys) <= set(got)
    _assert_stats_close(got, want, learner_keys)
    for k in ("training_iteration", "num_env_steps_sampled",
              "episodes_total", "episode_reward_mean"):
        assert got[k] == want[k] or (np.isnan(got[k])
                                     and np.isnan(want[k])), k
    assert got["num_learner_updates"] == 4
    _assert_params_close(port["ppo_w1"], jax_["ppo_w1"])


def test_dqn_train_equals_jax(runs):
    port, jax_ = runs
    got, want = port["dqn_result"], jax_["dqn_result"]
    for k in ("num_env_steps_sampled", "num_updates", "buffer_size",
              "epsilon", "episode_reward_mean"):
        assert got[k] == want[k] or (np.isnan(got[k])
                                     and np.isnan(want[k])), k
    assert want["num_updates"] == DQN_SETTINGS["updates_per_iter"]
    _assert_stats_close(got, want, ("loss", "td_error_mean"))
    _assert_params_close(port["dqn_w1"], jax_["dqn_w1"])
