"""PPO algorithm: rollout fan-out → GAE → minibatch SGD epochs.

Counterpart of ``ray_tpu/rl/ppo.py``. Reference: ``rllib/algorithms/ppo/
ppo.py:420`` (training_step: synchronous_parallel_sample over the WorkerSet
→ LearnerGroup.update → weight broadcast) and ``algorithm_config.py``
(builder-style config).

The runners are actors that sample on the host (``device="cpu"``), as
JAX's runners do; the learner runs on the card (``device``, "cuda" by
default) in process, or with ``learners(n)`` in n actors with a GPU slot
each. Each result also carries the iteration's learner time and update
count, from which ms per update is read.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .. import get
from .env import CartPoleEnv
from .learner import Learner, LearnerGroup
from .module import DiscretePolicyModule
from .vector_env import EnvRunner
from .sample_batch import SampleBatch, concat_batches


class PPOConfig:
    """Builder (reference: ``AlgorithmConfig`` fluent API)."""

    def __init__(self):
        self.env_creator: Callable = CartPoleEnv
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 1
        self.rollout_fragment_length = 256
        self.num_sgd_iter = 8
        self.sgd_minibatch_size = 128
        self.lr = 3e-4
        self.gamma = 0.99
        self.lam = 0.95
        self.clip_param = 0.2
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.grad_clip = 0.5
        self.hidden = (64, 64)
        self.num_learners = 0          # 0 = in-process learner
        self.device = "cuda"           # the learner's
        self.seed = 0

    def environment(self, env_creator: Callable) -> "PPOConfig":
        self.env_creator = env_creator
        return self

    def rollouts(self, *, num_rollout_workers: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None
                 ) -> "PPOConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        return self

    def training(self, **kwargs) -> "PPOConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown PPO setting {k!r}")
            setattr(self, k, v)
        return self

    def learners(self, num_learners: int) -> "PPOConfig":
        """n learner actors, each on a card of its own (one GPU slot)
        unless the device is "cpu"."""
        self.num_learners = num_learners
        return self

    def build(self) -> "PPO":
        return PPO(self)


class PPO:
    def __init__(self, config: PPOConfig):
        self.config = config
        probe = config.env_creator()
        module_cfg = {"observation_size": probe.observation_size,
                      "action_size": probe.action_size,
                      "hidden": tuple(config.hidden)}
        self.module = DiscretePolicyModule(**module_cfg)
        learner_kwargs = dict(lr=config.lr, clip=config.clip_param,
                              vf_coeff=config.vf_loss_coeff,
                              entropy_coeff=config.entropy_coeff,
                              grad_clip=config.grad_clip,
                              seed=config.seed, device=config.device)
        if config.num_learners > 0:
            self.learner = LearnerGroup(
                self.module, num_learners=config.num_learners,
                **learner_kwargs)
        else:
            self.learner = Learner(self.module, **learner_kwargs)
        self.workers: List[Any] = [
            EnvRunner.remote(config.env_creator, module_cfg,
                             num_envs=config.num_envs_per_worker,
                             gamma=config.gamma, lam=config.lam,
                             seed=config.seed + i * 1000, device="cpu")
            for i in range(config.num_rollout_workers)]
        self.iteration = 0

    # ---------------------------------------------------------------- train
    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        weights = self.learner.get_weights()
        results = get([w.sample.remote(weights,
                                       cfg.rollout_fragment_length)
                       for w in self.workers])
        batch = concat_batches([SampleBatch(b) for b, _ in results])
        stats_list = [s for _, s in results]
        sgd_stats: Dict[str, float] = {}
        t_learn, n_updates = time.perf_counter(), 0
        for _ in range(cfg.num_sgd_iter):
            shuffled = batch.shuffle(seed=self.iteration)
            for mb in shuffled.minibatches(cfg.sgd_minibatch_size):
                sgd_stats = self.learner.update(mb)
                n_updates += 1
        t_learn = time.perf_counter() - t_learn
        self.iteration += 1
        rewards = [s["episode_reward_mean"] for s in stats_list
                   if not np.isnan(s["episode_reward_mean"])]
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": (float(np.mean(rewards)) if rewards
                                    else float("nan")),
            "episodes_total": sum(s["episodes_total"]
                                  for s in stats_list),
            "num_env_steps_sampled": (cfg.rollout_fragment_length
                                      * cfg.num_envs_per_worker
                                      * len(self.workers)),
            "time_this_iter_s": time.perf_counter() - t0,
            "time_learner_s": t_learn,
            "num_learner_updates": n_updates,
            **{f"learner/{k}": v for k, v in sgd_stats.items()},
        }

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self) -> None:
        from .. import kill
        for w in self.workers:
            try:
                kill(w)
            except Exception:
                pass
        if isinstance(self.learner, LearnerGroup):
            self.learner.shutdown()
