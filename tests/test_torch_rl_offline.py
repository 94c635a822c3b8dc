"""ray_tpu_torch.rl's offline DQN on the port's runtime against ray_tpu.rl's
on JAX's, on the CPU.

The port's side runs first: ``collect_to_dataset`` (an env runner actor
sampling on the host into ``data.from_numpy``) and ``OfflineDQN`` with its
learner on the CPU, then JAX's analog of ``tests/test_rl.py::
test_offline_dqn_from_dataset``. JAX's side collects with the port's
initial weights (the batches are equal exactly: the same Q values and the
same numpy generator), then trains JAX's ``OfflineDQN`` on the port's
logged blocks from the port's initial weights: both draw their
minibatches from ``default_rng(seed)`` over the same blocks, so after 16
updates the parameters and the loss are held at ``tests/test_torch_rl.py``'s
bounds for DQN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch as rt
import torch_dist_worker
from ray_tpu import data as jd
from ray_tpu.rl import offline as joffline
from ray_tpu.rl.env import CartPoleEnv as JaxCartPole
from ray_tpu_torch import rl

torch_dist_worker.settle()

# tests/test_torch_rl.py's bounds: the loss to 1e-5 relative, each
# parameter normwise to 2e-6 of JAX's
STATS_RTOL = 1e-5
PARAM_RTOL = 2e-6
HIDDEN = (32, 32)
STEPS, ENVS, EPSILON, SEED = 512, 2, 0.3, 0


def _port_side():
    out = {}
    rt.init(num_cpus=4)
    try:
        # tests/test_rl.py::test_offline_dqn_from_dataset, on the port
        ds = rl.collect_to_dataset(rl.CartPoleEnv, num_steps=256,
                                   num_envs=2, epsilon=1.0, seed=0)
        out["analog_count"] = ds.count()
        algo = rl.OfflineDQN(ds, observation_size=4, action_size=2,
                             train_batch_size=32, seed=0, device="cpu")
        out["analog"] = (algo.train(num_updates=8), algo.train(num_updates=8),
                         algo.get_weights())

        cfg = {"observation_size": 4, "action_size": 2, "hidden": HIDDEN}
        out["w0"] = rl.offline._init_weights(cfg, SEED)
        ds = rl.collect_to_dataset(rl.CartPoleEnv, num_steps=STEPS,
                                   num_envs=ENVS, epsilon=EPSILON, seed=SEED,
                                   weights=out["w0"], hidden=HIDDEN)
        algo = rl.OfflineDQN(ds, observation_size=4, action_size=2,
                             hidden=HIDDEN, lr=1e-2, target_update_freq=4,
                             train_batch_size=32, seed=SEED, device="cpu")
        out["blocks"] = [dict(b) for b in algo._blocks]
        np.testing.assert_equal(algo.get_weights(), out["w0"])
        out["result"] = algo.train(num_updates=16)
        out["w1"] = algo.get_weights()
    finally:
        rt.shutdown()
    return out


def _jax_side(port):
    out = {}
    ray_tpu.init(num_cpus=4)
    try:
        ds = joffline.collect_to_dataset(
            JaxCartPole, num_steps=STEPS, num_envs=ENVS, epsilon=EPSILON,
            seed=SEED, weights=port["w0"], hidden=HIDDEN)
        out["collected"] = [dict(b) for b in ds.iter_blocks()]
        # the port's logged blocks, one JAX block each
        logged = jd.from_numpy({k: np.concatenate(
            [b[k] for b in port["blocks"]]) for k in port["blocks"][0]},
            num_blocks=len(port["blocks"]))
        algo = joffline.OfflineDQN(logged, observation_size=4, action_size=2,
                                   hidden=HIDDEN, lr=1e-2,
                                   target_update_freq=4, train_batch_size=32,
                                   seed=SEED)
        out["blocks"] = [dict(b) for b in algo._blocks]
        params = jax.tree_util.tree_map(jnp.asarray, port["w0"])
        algo.learner.params = params
        algo.learner.target_params = params
        algo.learner.opt_state = algo.learner.opt.init(params)
        out["result"] = algo.train(num_updates=16)
        out["w1"] = algo.get_weights()
    finally:
        ray_tpu.shutdown()
    return out


@pytest.fixture(scope="module")
def runs():
    port = _port_side()
    return port, _jax_side(port)


def test_offline_dqn_from_dataset(runs):
    """Offline RL: collect transitions into a Dataset with a random
    behavior policy, then train DQN purely from the logs (reference:
    rllib/offline DatasetReader)."""
    port, _ = runs
    assert port["analog_count"] == 512
    r1, r2, w = port["analog"]
    assert r2["num_updates"] == 16
    assert np.isfinite(r1["loss"]) and np.isfinite(r2["loss"])
    assert "q" in w or len(w) > 0


def test_collect_to_dataset_equals_jax(runs):
    """The same weights, seed and epsilon: the same logged transitions, in
    the same blocks."""
    port, jax_ = runs
    assert len(port["blocks"]) == len(jax_["collected"]) == STEPS // 256
    for g, w in zip(port["blocks"], jax_["collected"]):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # epsilon 0.3 and greedy actions from the Q values both appear
    assert len(np.unique(port["blocks"][0]["actions"])) == 2


def test_offline_dqn_matches_jax(runs):
    """16 updates from the same weights over the same blocks and draws:
    the loss and the TD error within STATS_RTOL, each parameter within
    PARAM_RTOL of JAX's, normwise."""
    port, jax_ = runs
    for g, w in zip(port["blocks"], jax_["blocks"], strict=True):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    got, want = port["result"], jax_["result"]
    assert got["num_updates"] == want["num_updates"] == 16
    for k in ("loss", "td_error_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=STATS_RTOL,
                                   err_msg=k)
    moved = 0.0
    for (path, p), (_, j), (_, p0) in zip(
            jax.tree_util.tree_leaves_with_path(port["w1"]),
            jax.tree_util.tree_leaves_with_path(jax_["w1"]),
            jax.tree_util.tree_leaves_with_path(port["w0"]), strict=True):
        err = np.linalg.norm(p - np.asarray(j))
        assert err <= PARAM_RTOL * np.linalg.norm(j), (path, err)
        moved = max(moved, np.linalg.norm(p - p0))
    assert moved > 1e-3      # the updates moved the weights
