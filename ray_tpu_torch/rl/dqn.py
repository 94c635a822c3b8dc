"""DQN: the double-DQN learner on the card, the replay actor and the
algorithm.

Counterpart of ``ray_tpu/rl/dqn.py``. ``DQNLearner``: the online net picks
a' and the target net evaluates it, a Huber loss at ``huber_delta``, Adam
without a clip (``models.training.Optimizer``), and the target network
copied from the online one every ``target_update_freq`` updates.

The REPLAY PLANE is the object store: rollout actors ``put`` each
collected fragment and register only the ObjectRef with the replay
actor (``ReplayBuffer``, JAX's ``@remote(num_cpus=0)`` class), so replay
data lives in shm and the buffer actor holds refs, never payloads. The
package's ``rl.ReplayBuffer`` stays the uniform buffer of
``replay_buffers.py``; this one is ``rl.dqn.ReplayBuffer``.

``DQN`` runs its learner in process (JAX's design) or, with
``DQNConfig.learners(1)``, in an actor with a GPU slot.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.gpt import resolve_device
from . import sample_batch as SB
from ._remote import RemoteMixin
from .convert import params_to_jax
from .learner import (Batch, Stats, adam, learner_actor_options, sgd_step,
                      to_device)
from .module import QNetworkModule
from .sample_batch import SampleBatch

NEXT_OBS = "next_obs"


class ReplayBuffer(RemoteMixin):
    """Holds ObjectRefs of transition fragments (the payloads stay in
    the object store); uniform sampling over stored fragments. Capacity
    is in TRANSITIONS; oldest fragments are dropped (their store blocks
    free via refcounting once unreferenced)."""

    _actor_options = {"num_cpus": 0}

    def __init__(self, capacity: int, seed: int = 0):
        self._capacity = capacity
        self._frags: List[tuple] = []        # ([ref], n_transitions)
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def add(self, wrapped_ref, count: int) -> int:
        self._frags.append((wrapped_ref, count))
        self._size += count
        while self._size - self._frags[0][1] >= self._capacity \
                and len(self._frags) > 1:
            _, n = self._frags.pop(0)
            self._size -= n
        return self._size

    def size(self) -> int:
        return self._size

    def sample_refs(self, n_fragments: int) -> List[Any]:
        """Random fragments (with replacement) — the learner fetches the
        payloads itself, so replay bytes never route through this
        actor."""
        if not self._frags:
            return []
        idx = self._rng.integers(0, len(self._frags), size=n_fragments)
        return [self._frags[i][0] for i in idx]


class DQNLearner:
    """Double-DQN update + periodic target sync. The learner owns `module`:
    it draws its weights from `seed` and moves it to `device`; the target
    network starts as its copy."""

    def __init__(self, module: QNetworkModule, *, lr: float = 1e-3,
                 gamma: float = 0.99, target_update_freq: int = 200,
                 huber_delta: float = 1.0, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        module.init_weights(seed)
        self.module = module.to(self.device)
        self.target_module = copy.deepcopy(self.module).requires_grad_(False)
        self.gamma = gamma
        self.huber_delta = huber_delta
        self.target_update_freq = target_update_freq
        self.opt = adam(lr, grad_clip=float("inf"))
        with torch.no_grad():
            self.opt_state = self.opt.init(dict(module.named_parameters()))
        self._updates = 0

    def _loss(self, batch: Batch) -> Tuple[torch.Tensor, Stats]:
        q = self.module(batch[SB.OBS])
        q_sa = q.gather(-1, batch[SB.ACTIONS].long()[:, None])[:, 0]
        with torch.no_grad():
            # double DQN: online net picks a', target net evaluates it
            # (argmax takes the first maximum, as jnp.argmax does)
            a_next = self.module(batch[NEXT_OBS]).argmax(dim=-1)
            q_next = self.target_module(batch[NEXT_OBS]).gather(
                -1, a_next[:, None])[:, 0]
        not_done = 1.0 - batch[SB.DONES].float()
        target = batch[SB.REWARDS] + self.gamma * not_done * q_next
        td = q_sa - target
        # Huber loss (reference: DQN's clipped TD error)
        d = self.huber_delta
        loss = torch.where(td.abs() <= d, 0.5 * td ** 2,
                           d * (td.abs() - 0.5 * d)).mean()
        return loss, {"td_error_mean": td.abs().mean(), "loss": loss}

    def update(self, batch: SB.SampleBatch) -> Dict[str, float]:
        metrics = sgd_step(self.module, self.opt, self.opt_state, self._loss,
                           to_device(batch, self.device))
        self._updates += 1
        if self._updates % self.target_update_freq == 0:
            self.target_module.load_state_dict(self.module.state_dict())
        return metrics

    def get_weights(self):
        return params_to_jax(self.module.state_dict())


class _DQNLearnerActor(RemoteMixin):
    """A `DQNLearner` in an actor; with a GPU slot its device "cuda" is the
    slot's card."""

    def __init__(self, module_config: dict, learner_kwargs: dict):
        self.learner = DQNLearner(QNetworkModule(**module_config),
                                  **learner_kwargs)

    def update(self, batch) -> Dict[str, float]:
        return self.learner.update(SampleBatch(batch))

    def get_weights(self):
        return self.learner.get_weights()


class DQNConfig:
    """Builder mirroring the PPO/IMPALA config surface (reference:
    ``AlgorithmConfig`` chaining)."""

    def __init__(self):
        self.env_creator: Optional[Callable] = None
        self.num_rollout_workers = 1
        self.num_envs_per_worker = 1
        self.fragment_length = 128
        self.hidden = (64, 64)
        self.lr = 1e-3
        self.gamma = 0.99
        self.train_batch_size = 64
        self.updates_per_iter = 64
        self.buffer_capacity = 50_000
        self.learning_starts = 1_000
        self.target_update_freq = 200
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 4_000
        self.seed = 0
        self.num_learners = 0          # 0 = in-process learner
        self.device = "cuda"           # the learner's

    def environment(self, env_creator: Callable) -> "DQNConfig":
        self.env_creator = env_creator
        return self

    def rollouts(self, *, num_rollout_workers: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None
                 ) -> "DQNConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if rollout_fragment_length is not None:
            self.fragment_length = rollout_fragment_length
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        return self

    def training(self, **kwargs) -> "DQNConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown DQN training option {k!r}")
            setattr(self, k, v)
        return self

    def learners(self, num_learners: int) -> "DQNConfig":
        """0: the learner in process (JAX's DQN); 1: in an actor, on a
        card of its own unless the device is "cpu". The target network
        has no consensus across learners, so more than one is refused."""
        if num_learners not in (0, 1):
            raise ValueError("DQN runs 0 (in process) or 1 learner actor, "
                             f"got {num_learners}")
        self.num_learners = num_learners
        return self

    def build(self) -> "DQN":
        if self.env_creator is None:
            raise ValueError("call .environment(env_creator) first")
        return DQN(self)


class DQN:
    """Iterate ``train()``: collect with decaying epsilon → replay →
    minibatch double-DQN updates (reference: ``dqn.py`` training_step —
    sample, store, replay, update-target). The runners sample on the
    host, as JAX's do."""

    def __init__(self, config: DQNConfig):
        from .. import get
        from .vector_env import EnvRunner

        env = config.env_creator()
        module_config = {"observation_size": env.observation_size,
                         "action_size": env.action_size,
                         "hidden": config.hidden}
        self.config = config
        learner_kwargs = dict(lr=config.lr, gamma=config.gamma,
                              target_update_freq=config.target_update_freq,
                              seed=config.seed, device=config.device)
        if config.num_learners:
            self._learner_actor = _DQNLearnerActor.options(
                **learner_actor_options(None, config.device)).remote(
                module_config, learner_kwargs)
            self.learner = None
            get(self._learner_actor.get_weights.remote())   # built
        else:
            self._learner_actor = None
            self.learner = DQNLearner(QNetworkModule(**module_config),
                                      **learner_kwargs)
        self.buffer = ReplayBuffer.remote(config.buffer_capacity,
                                          seed=config.seed)
        self.workers = [
            EnvRunner.remote(config.env_creator, module_config,
                             num_envs=config.num_envs_per_worker,
                             module_kind="q", seed=config.seed + i * 1000,
                             device="cpu")
            for i in range(config.num_rollout_workers)]
        self._steps_sampled = 0
        self._rng = np.random.default_rng(config.seed)
        self._episode_rewards: List[float] = []

    # ----------------------------------------------------------- train
    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self._steps_sampled / max(1, c.epsilon_decay_steps))
        return c.epsilon_initial + frac * (c.epsilon_final
                                           - c.epsilon_initial)

    def _update(self, mb: SampleBatch) -> Dict[str, float]:
        from .. import get
        if self._learner_actor is not None:
            return get(self._learner_actor.update.remote(dict(mb)))
        return self.learner.update(mb)

    def train(self) -> Dict[str, Any]:
        from .. import get

        c = self.config
        t0 = time.perf_counter()
        weights = self.get_weights()
        eps = self._epsilon()
        outs = get([w.collect_epsilon_greedy.remote(
                        weights, c.fragment_length, eps)
                    for w in self.workers])
        adds = []
        for wrapped, count, stats in outs:
            self._steps_sampled += count
            self._episode_rewards.extend(stats["episode_rewards"])
            adds.append(self.buffer.add.remote(wrapped, count))
        buffer_size = max(get(adds)) if adds else 0

        metrics: Dict[str, float] = {}
        n_updates = 0
        if buffer_size >= min(c.learning_starts, c.buffer_capacity):
            frag_refs = get(self.buffer.sample_refs.remote(
                c.updates_per_iter))
            for wrapped in frag_refs:
                frag = SampleBatch(get(wrapped[0]))
                idx = self._rng.integers(0, len(frag),
                                         size=c.train_batch_size)
                mb = SampleBatch({k: v[idx] for k, v in frag.items()})
                metrics = self._update(mb)
                n_updates += 1

        recent = self._episode_rewards[-20:]
        return {
            "num_env_steps_sampled": self._steps_sampled,
            "num_updates": n_updates,
            "buffer_size": buffer_size,
            "epsilon": round(eps, 4),
            "episode_reward_mean": (float(np.mean(recent))
                                    if recent else float("nan")),
            "time_this_iter_s": time.perf_counter() - t0,
            **metrics,
        }

    def get_weights(self):
        from .. import get
        if self._learner_actor is not None:
            return get(self._learner_actor.get_weights.remote())
        return self.learner.get_weights()

    def stop(self) -> None:
        from .. import kill
        for a in [*self.workers, self.buffer, self._learner_actor]:
            if a is None:
                continue
            try:
                kill(a)
            except Exception:
                pass
