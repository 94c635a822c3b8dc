"""Offline RL: train from logged transitions in a Dataset.

Counterpart of ``ray_tpu/rl/offline.py``. Reference: ``rllib/offline/``
(JsonReader/DatasetReader feeding off-policy algorithms without
environment interaction). Here the input is a ``ray_tpu_torch.data.Dataset``
whose rows carry obs/actions/rewards/next_obs/dones columns — written by
``collect_to_dataset`` below or any ETL — and the learner is the double-DQN
``DQNLearner`` the online algorithm uses, on the card unless the caller
passes ``device="cpu"``. The minibatches are drawn as JAX's are, from
``np.random.default_rng(seed)`` over the same blocks.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from . import sample_batch as SB
from .dqn import NEXT_OBS, DQNLearner
from .module import QNetworkModule
from .sample_batch import SampleBatch

REQUIRED = (SB.OBS, SB.ACTIONS, SB.REWARDS, NEXT_OBS, SB.DONES)


class OfflineDQN:
    """Double-DQN trained purely from a logged-transition Dataset."""

    def __init__(self, dataset, *, observation_size: int,
                 action_size: int, hidden=(64, 64), lr: float = 1e-3,
                 gamma: float = 0.99, target_update_freq: int = 200,
                 train_batch_size: int = 64, seed: int = 0,
                 device="cuda"):
        self._blocks = [blk for blk in dataset.iter_blocks()
                        if blk and len(next(iter(blk.values())))]
        if not self._blocks:
            raise ValueError("offline dataset is empty")
        for blk in self._blocks:     # every block: heterogeneous ETL
            missing = [c for c in REQUIRED if c not in blk]
            if missing:
                raise ValueError(
                    f"offline dataset lacks columns {missing}; needs "
                    f"{list(REQUIRED)}")
        self.module = QNetworkModule(observation_size, action_size,
                                     hidden=tuple(hidden))
        self.learner = DQNLearner(
            self.module, lr=lr, gamma=gamma,
            target_update_freq=target_update_freq, seed=seed, device=device)
        self.train_batch_size = train_batch_size
        self._rng = np.random.default_rng(seed)
        self._updates = 0

    def _minibatch(self) -> SampleBatch:
        blk = self._blocks[self._rng.integers(0, len(self._blocks))]
        n = len(blk[SB.ACTIONS])
        idx = self._rng.integers(0, n, size=self.train_batch_size)
        return SampleBatch({c: np.asarray(blk[c])[idx]
                            for c in REQUIRED})

    def train(self, num_updates: int = 64) -> Dict[str, Any]:
        metrics: Dict[str, float] = {}
        for _ in range(num_updates):
            metrics = self.learner.update(self._minibatch())
            self._updates += 1
        return {"num_updates": self._updates, **metrics}

    def get_weights(self):
        return self.learner.get_weights()


def collect_to_dataset(env_creator, *, num_steps: int,
                       num_envs: int = 4, epsilon: float = 1.0,
                       seed: int = 0, weights: Optional[Any] = None,
                       hidden=(64, 64)):
    """Log transitions from an (epsilon-greedy) behavior policy into a
    Dataset (reference: ``rllib/offline/output_writer.py`` — here the
    sink is the data plane itself). The runner is an actor that samples on
    the host, as JAX's does; `weights` (JAX's pytree layout) default to
    the Q network's init from `seed`."""
    from .. import get, kill
    from ..data import from_numpy
    from .vector_env import EnvRunner

    cfg = _probe_module_config(env_creator, hidden)
    runner = EnvRunner.remote(env_creator, cfg, num_envs=num_envs,
                              module_kind="q", seed=seed, device="cpu")
    if weights is None:
        weights = _init_weights(cfg, seed)
    batch, _ = get(runner.sample_epsilon_greedy.remote(
        weights, num_steps, epsilon))
    try:
        kill(runner)
    except Exception:   # noqa: BLE001 — collection actor teardown
        pass
    return from_numpy({k: np.asarray(v) for k, v in batch.items()},
                      num_blocks=max(1, num_steps // 256))


def _probe_module_config(env_creator, hidden) -> Dict[str, Any]:
    env = env_creator()
    return {"observation_size": env.observation_size,
            "action_size": env.action_size, "hidden": tuple(hidden)}


def _init_weights(cfg, seed):
    """The Q network's init from `seed` (``init_weights``, a torch
    generator: not JAX's ``PRNGKey(seed)`` draws) in JAX's pytree layout."""
    from .convert import params_to_jax
    module = QNetworkModule(**cfg)
    module.init_weights(seed)
    return params_to_jax(module.state_dict())
