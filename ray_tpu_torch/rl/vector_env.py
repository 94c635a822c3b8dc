"""Vectorized environments + the env runner's sampling.

Counterpart of ``ray_tpu/rl/vector_env.py``: ``VectorEnv`` (N sub-envs
stepped as a batch with auto-reset) is its numpy copy, and ``EnvRunner`` is
the body of the JAX actor class: ``EnvRunner(...)`` in process,
``EnvRunner.remote(...)`` as an actor of the port's runtime, as JAX's
``@remote`` class. The policy is evaluated once per step for all N
sub-envs, a [N, obs] batched forward.

Like every entry point of the port, the runner puts its policy on the card
unless the caller passes ``device="cpu"``. The callers that follow the JAX
design pass it: there sampling never touches the accelerator (the JAX
runners evaluate the policy on host devices, and the runtime starts its
workers with ``JAX_PLATFORMS=cpu``), while the learners' updates run on
the card.

Weights arrive as the learners hand them out (``Learner.get_weights``):
JAX's pytree layout with numpy leaves.
"""

from __future__ import annotations

import inspect
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..models.gpt import resolve_device
from . import sample_batch as SB
from ._remote import RemoteMixin
from .convert import params_from_jax
from .dqn import NEXT_OBS
from .module import DiscretePolicyModule, QNetworkModule
from .sample_batch import SampleBatch, compute_gae


class VectorEnv:
    """N sub-environments stepped together with per-env auto-reset."""

    def __init__(self, env_creator: Callable, num_envs: int,
                 seed: Optional[int] = None):
        if num_envs < 1:
            raise ValueError("num_envs must be >= 1")
        takes_seed = False
        try:
            takes_seed = "seed" in inspect.signature(
                env_creator).parameters
        except (TypeError, ValueError):
            pass
        self.envs = []
        for i in range(num_envs):
            if takes_seed:
                self.envs.append(env_creator(
                    seed=None if seed is None else seed + i))
            else:
                self.envs.append(env_creator())
        self.num_envs = num_envs
        probe = self.envs[0]
        self.observation_size = probe.observation_size
        self.action_size = probe.action_size

    def reset_all(self) -> np.ndarray:
        return np.stack([e.reset()[0] for e in self.envs]).astype(
            np.float32)

    def step(self, actions: np.ndarray):
        """Step every sub-env; done envs auto-reset. Returns
        (obs[N,D] AFTER auto-reset, rewards[N], terminateds[N],
        truncateds[N], final_obs[N,D] BEFORE any reset) — consumers
        needing the pre-reset observation (DQN's next_obs, truncation
        bootstrapping) read ``final_obs``."""
        n = self.num_envs
        obs = np.empty((n, self.observation_size), np.float32)
        final = np.empty((n, self.observation_size), np.float32)
        rewards = np.empty(n, np.float32)
        terms = np.empty(n, bool)
        truncs = np.empty(n, bool)
        for i, (env, a) in enumerate(zip(self.envs, actions)):
            o, r, term, trunc, _ = env.step(int(a))
            final[i] = o
            rewards[i] = r
            terms[i] = term
            truncs[i] = trunc
            if term or trunc:
                o, _ = env.reset()
            obs[i] = o
        return obs, rewards, terms, truncs, final


class EnvRunner(RemoteMixin):
    """The sampler every algorithm uses (reference:
    ``rllib/env/env_runner.py``): a VectorEnv plus a batched policy head on
    `device`. ``sample`` serves the on-policy family (PPO flat+GAE, IMPALA
    env-major fragments); ``sample_epsilon_greedy`` serves the off-policy
    family (DQN transitions with next_obs).

    Two generators, kept apart as in JAX: the policy's actions come from a
    ``torch.Generator`` on `device` seeded with `seed`, the epsilon draws
    from ``np.random.default_rng(seed)``, the JAX runner's own, so that
    ``sample_epsilon_greedy`` is deterministic and equals JAX's."""

    def __init__(self, env_creator: Callable, module_config: dict, *,
                 num_envs: int = 1, module_kind: str = "policy",
                 gamma: float = 0.99, lam: float = 0.95, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.venv = VectorEnv(env_creator, num_envs, seed=seed)
        self.gamma = gamma
        self.lam = lam
        self.num_envs = num_envs
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._np_rng = np.random.default_rng(seed)
        self._obs: Optional[np.ndarray] = None
        self._episode_reward = np.zeros(num_envs, np.float64)
        self._episode_rewards: List[float] = []
        module_cls = (DiscretePolicyModule if module_kind == "policy"
                      else QNetworkModule)
        self.module = module_cls(**module_config).to(self.device)

    def _load(self, weights) -> None:
        self.module.load_state_dict(params_from_jax(weights))

    def _tensor(self, obs: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(obs, device=self.device)

    def _value(self, obs: np.ndarray) -> np.ndarray:
        return self.module(self._tensor(obs))[1].cpu().numpy()

    # ------------------------------------------------------- policy mode
    @torch.no_grad()
    def sample(self, weights, num_steps: int,
               compute_advantages: bool = True) -> Tuple[dict, dict]:
        """Collect ``num_steps`` transitions PER SUB-ENV.

        compute_advantages=True (PPO): flat env-major batch of
        N*num_steps rows with per-env GAE columns.
        compute_advantages=False (IMPALA): env-major per-env fragments
        — arrays shaped [N, T, ...] plus stats["bootstrap_obs"] [N, D].
        """
        self._load(weights)
        if self._obs is None:
            self._obs = self.venv.reset_all()
        n, horizon = self.num_envs, num_steps
        obs_b = np.empty((horizon, n, self.venv.observation_size),
                         np.float32)
        act_b = np.empty((horizon, n), np.int32)
        rew_b = np.empty((horizon, n), np.float32)
        done_b = np.empty((horizon, n), bool)
        logp_b = np.empty((horizon, n), np.float32)
        vf_b = np.empty((horizon, n), np.float32)
        for t in range(horizon):
            action, logp, value = self.module.action_dist(
                self._tensor(self._obs), self._gen)
            acts = action.cpu().numpy()
            nxt, rewards, terms, truncs, final = self.venv.step(acts)
            cut = truncs & ~terms
            if cut.any():
                # truncated (not finished) episodes: fold the bootstrap
                # into the final reward so marking done stays unbiased
                boot = self._value(final)
                rewards = rewards + np.where(
                    cut, self.gamma * boot, 0.0).astype(np.float32)
            obs_b[t] = self._obs
            act_b[t] = acts
            rew_b[t] = rewards
            done_b[t] = terms | truncs
            logp_b[t] = logp.cpu().numpy()
            vf_b[t] = value.cpu().numpy()
            self._episode_reward += np.asarray(rewards, np.float64)
            for i in np.nonzero(terms | truncs)[0]:
                self._episode_rewards.append(
                    float(self._episode_reward[i]))
                self._episode_reward[i] = 0.0
            self._obs = nxt
        recent = self._episode_rewards[-20:]
        stats = {
            "episodes_total": len(self._episode_rewards),
            "episode_reward_mean": (float(np.mean(recent))
                                    if recent else float("nan")),
            # [N, D]: off-policy learners bootstrap each fragment from
            # its own env's next observation
            "bootstrap_obs": np.asarray(self._obs, np.float32),
        }
        if not compute_advantages:
            batch = {                       # env-major time series
                SB.OBS: obs_b.swapaxes(0, 1),
                SB.ACTIONS: act_b.T,
                SB.REWARDS: rew_b.T,
                SB.DONES: done_b.T,
                SB.LOGP: logp_b.T,
            }
            return batch, stats
        # PPO: per-env GAE, then flatten env-major
        frags = []
        last_values = self._value(self._obs)
        for i in range(n):
            frag = SampleBatch({
                SB.OBS: obs_b[:, i], SB.ACTIONS: act_b[:, i],
                SB.REWARDS: rew_b[:, i], SB.DONES: done_b[:, i],
                SB.LOGP: logp_b[:, i], SB.VF_PREDS: vf_b[:, i],
            })
            last = 0.0 if done_b[-1, i] else float(last_values[i])
            frags.append(compute_gae(frag, gamma=self.gamma,
                                     lam=self.lam, last_value=last))
        out = {k: np.concatenate([dict(f)[k] for f in frags])
               for k in dict(frags[0])}
        return out, stats

    # ------------------------------------------------ epsilon-greedy mode
    @torch.no_grad()
    def sample_epsilon_greedy(self, weights, num_steps: int,
                              epsilon: float) -> Tuple[dict, dict]:
        """DQN collection: flat transitions with next_obs; exploration
        by per-env epsilon-greedy over one batched Q forward."""
        self._load(weights)
        if self._obs is None:
            self._obs = self.venv.reset_all()
        n = self.num_envs
        rows_obs, rows_next = [], []
        rows_act, rows_rew, rows_done = [], [], []
        for _ in range(num_steps):
            q = self.module(self._tensor(self._obs)).cpu().numpy()
            acts = q.argmax(axis=-1)
            explore = self._np_rng.random(n) < epsilon
            acts = np.where(
                explore,
                self._np_rng.integers(0, self.venv.action_size, n),
                acts)
            nxt, rewards, terms, truncs, final = self.venv.step(acts)
            rows_obs.append(self._obs.copy())
            rows_next.append(final)
            rows_act.append(acts.astype(np.int32))
            rows_rew.append(rewards)
            rows_done.append(terms)     # truncation is not a terminal
            self._episode_reward += np.asarray(rewards, np.float64)
            for i in np.nonzero(terms | truncs)[0]:
                self._episode_rewards.append(
                    float(self._episode_reward[i]))
                self._episode_reward[i] = 0.0
            self._obs = nxt
        batch = {
            SB.OBS: np.concatenate(rows_obs),
            SB.ACTIONS: np.concatenate(rows_act),
            SB.REWARDS: np.concatenate(rows_rew),
            NEXT_OBS: np.concatenate(rows_next),
            SB.DONES: np.concatenate(rows_done),
        }
        rewards, self._episode_rewards = self._episode_rewards, []
        stats = {"episode_rewards": rewards}
        return batch, stats

    def collect_epsilon_greedy(self, weights, num_steps: int,
                               epsilon: float):
        """DQN replay-plane form: the batch goes STRAIGHT to the object
        store from this actor; only the ref travels (the buffer actor
        holds refs, never payloads)."""
        from .. import put
        batch, stats = self.sample_epsilon_greedy(weights, num_steps,
                                                  epsilon)
        count = int(len(batch[SB.ACTIONS]))
        return [put(batch)], count, stats
