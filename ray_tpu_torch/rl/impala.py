"""IMPALA: asynchronous actor-critic with V-trace correction.

Counterpart of ``ray_tpu/rl/impala.py``: the runners are actors that
sample on the host (``device="cpu"``), as JAX's do; the V-trace learner
runs on the card (``device``, "cuda" by default) in process, or with
``learners(n)`` in n actors with a GPU slot each. Reference: ``rllib/algorithms/impala/impala.py`` (async sample requests
kept in flight, learner consumes whatever arrived, weights broadcast
back to the workers that just reported) and
``rllib/core/learner/learner_group.py:61`` for the multi-learner form.
The V-trace update is one forward, backward and Adam step over stacked
env-major fragments (``Learner._vtrace_loss``); off-policy staleness
from async sampling is exactly what V-trace's rho/c clipping corrects.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .. import get, wait
from .env import CartPoleEnv
from .learner import Learner, LearnerGroup
from .module import DiscretePolicyModule
from .vector_env import EnvRunner
from . import sample_batch as SB


class ImpalaConfig:
    """Builder (reference: ``ImpalaConfig`` fluent API)."""

    def __init__(self):
        self.env_creator: Callable = CartPoleEnv
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 1
        self.rollout_fragment_length = 64
        self.lr = 5e-4
        self.gamma = 0.99
        self.entropy_coeff = 0.01
        self.vf_loss_coeff = 0.5
        self.grad_clip = 40.0
        self.clip_rho_threshold = 1.0
        self.clip_c_threshold = 1.0
        # passes over each collected batch (reference: minibatch_buffer's
        # num_sgd_iter; >1 reuses data, V-trace corrects the off-policy
        # drift this introduces)
        self.num_sgd_iter = 1
        self.hidden = (64, 64)
        self.num_learners = 0          # 0 = in-process learner
        self.device = "cuda"           # the learner's
        self.seed = 0

    def environment(self, env_creator: Callable) -> "ImpalaConfig":
        self.env_creator = env_creator
        return self

    def rollouts(self, *, num_rollout_workers: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None
                 ) -> "ImpalaConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        return self

    def training(self, **kwargs) -> "ImpalaConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown IMPALA setting {k!r}")
            setattr(self, k, v)
        return self

    def learners(self, num_learners: int) -> "ImpalaConfig":
        """n learner actors, each on a card of its own (one GPU slot)
        unless the device is "cpu"."""
        self.num_learners = num_learners
        return self

    def build(self) -> "Impala":
        return Impala(self)


class Impala:
    def __init__(self, config: ImpalaConfig):
        self.config = config
        probe = config.env_creator()
        module_cfg = {"observation_size": probe.observation_size,
                      "action_size": probe.action_size,
                      "hidden": tuple(config.hidden)}
        self.module = DiscretePolicyModule(**module_cfg)
        learner_kwargs = dict(
            lr=config.lr, vf_coeff=config.vf_loss_coeff,
            entropy_coeff=config.entropy_coeff,
            grad_clip=config.grad_clip, gamma=config.gamma,
            rho_clip=config.clip_rho_threshold,
            c_clip=config.clip_c_threshold,
            loss="vtrace", seed=config.seed, device=config.device)
        if config.num_learners > 0:
            self.learner = LearnerGroup(
                self.module, num_learners=config.num_learners,
                **learner_kwargs)
        else:
            self.learner = Learner(self.module, **learner_kwargs)
        self.workers: List[Any] = [
            EnvRunner.remote(config.env_creator, module_cfg,
                             num_envs=config.num_envs_per_worker,
                             gamma=config.gamma, lam=1.0,
                             seed=config.seed + i * 1000, device="cpu")
            for i in range(config.num_rollout_workers)]
        # async pipeline: one sample request in flight per worker at all
        # times; train() consumes whatever is ready
        self._inflight: Dict[Any, Any] = {}       # ref -> worker
        weights = self.learner.get_weights()
        for w in self.workers:
            self._submit(w, weights)
        self.iteration = 0
        self._episodes_total = 0
        self._episodes_by_worker: Dict[int, int] = {}

    def _submit(self, worker, weights) -> None:
        ref = worker.sample.remote(weights,
                                   self.config.rollout_fragment_length,
                                   compute_advantages=False)
        self._inflight[ref] = worker

    # ---------------------------------------------------------------- train
    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        # at least one fragment, plus everything else already queued —
        # the async part: slow workers don't gate the learner
        ready, _ = wait(list(self._inflight), num_returns=1, timeout=None)
        more, _ = wait(list(set(self._inflight) - set(ready)),
                       num_returns=len(self._inflight) - len(ready),
                       timeout=0) if len(self._inflight) > len(ready) \
            else ([], [])
        done_refs = list(ready) + list(more)
        results = get(done_refs)
        finished_workers = [self._inflight.pop(r) for r in done_refs]

        # each runner reports [N, T, ...] fragments (N = envs/runner)
        frags = [b for b, _ in results]
        stats_list = [s for _, s in results]
        boot_list = [s["bootstrap_obs"] for s in stats_list]
        # pad B up to workers*envs by cycling ready fragments: JAX keeps
        # one compiled learner program this way, and the port keeps its
        # batches (slight overweighting of duplicated rows, same spirit
        # as the reference's batch bucketing)
        target_b = (self.config.num_rollout_workers
                    * self.config.num_envs_per_worker)
        i = 0
        while sum(f[SB.OBS].shape[0] for f in frags) < target_b:
            frags.append(frags[i % len(results)])
            boot_list.append(boot_list[i % len(results)])
            i += 1
        batch = {
            SB.OBS: np.concatenate([f[SB.OBS] for f in frags]),
            SB.ACTIONS: np.concatenate([f[SB.ACTIONS] for f in frags]),
            SB.REWARDS: np.concatenate([f[SB.REWARDS] for f in frags]),
            SB.DONES: np.concatenate([f[SB.DONES] for f in frags]),
            SB.LOGP: np.concatenate([f[SB.LOGP] for f in frags]),
            "bootstrap_obs": np.concatenate(boot_list),
        }
        learner_stats: Dict[str, float] = {}
        for _ in range(self.config.num_sgd_iter):
            learner_stats = self.learner.update(SB.SampleBatch(batch))
        # broadcast the fresh weights only to the workers that reported
        # (the reference's broadcast-on-report async weight sync)
        weights = self.learner.get_weights()
        for w in finished_workers:
            self._submit(w, weights)

        self.iteration += 1
        rewards = [s["episode_reward_mean"] for s in stats_list
                   if not np.isnan(s["episode_reward_mean"])]
        # per-worker counts are cumulative: the cluster total is the sum
        # of each worker's latest report (matches PPO's semantics)
        for w, s in zip(finished_workers, stats_list):
            self._episodes_by_worker[id(w)] = s["episodes_total"]
        self._episodes_total = sum(self._episodes_by_worker.values())
        sampled = (len(results) * self.config.num_envs_per_worker
                   * self.config.rollout_fragment_length)
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": (float(np.mean(rewards)) if rewards
                                    else float("nan")),
            "episodes_total": self._episodes_total,
            "num_env_steps_sampled": sampled,
            "num_env_steps_trained": sampled,
            "time_this_iter_s": time.perf_counter() - t0,
            **{f"learner/{k}": v for k, v in learner_stats.items()},
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
