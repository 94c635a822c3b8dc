"""Environments (gym-style API without the gym dependency).

The port's own copy of ``ray_tpu/rl/env.py`` (numpy only): under a seed and
an action sequence its trajectories equal the JAX package's bit for bit.
Reference: ``rllib/env/`` — the API subset algorithms need:
``reset() -> (obs, info)``, ``step(a) -> (obs, reward, terminated,
truncated, info)``. CartPole matches the classic control task
(reference tuned example: PPO CartPole-v1, BASELINE.json config #1).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


class Env:
    observation_size: int
    action_size: int

    def reset(self, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action: int):
        raise NotImplementedError


class CartPoleEnv(Env):
    """CartPole-v1 dynamics (pole balancing; reward 1/step, cap 500)."""

    observation_size = 4
    action_size = 2

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE = 10.0
    DT = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500

    def __init__(self, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)
        self._state = None
        self._steps = 0

    def reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        return self._state.astype(np.float32).copy(), {}

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE if action == 1 else -self.FORCE
        cos, sin = np.cos(theta), np.sin(theta)
        total_mass = self.CART_MASS + self.POLE_MASS
        pole_ml = self.POLE_MASS * self.POLE_HALF_LEN
        temp = (force + pole_ml * theta_dot ** 2 * sin) / total_mass
        theta_acc = (self.GRAVITY * sin - cos * temp) / (
            self.POLE_HALF_LEN * (4.0 / 3.0 - self.POLE_MASS * cos ** 2
                                  / total_mass))
        x_acc = temp - pole_ml * theta_acc * cos / total_mass
        x += self.DT * x_dot
        x_dot += self.DT * x_acc
        theta += self.DT * theta_dot
        theta_dot += self.DT * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._steps += 1
        terminated = bool(abs(x) > self.X_LIMIT
                          or abs(theta) > self.THETA_LIMIT)
        truncated = self._steps >= self.MAX_STEPS
        return (self._state.astype(np.float32).copy(), 1.0, terminated,
                truncated, {})


class RandomEnv(Env):
    """Reference analogue: ``rllib/examples/env/random_env.py`` — smoke
    tests without meaningful dynamics."""

    def __init__(self, observation_size: int = 4, action_size: int = 2,
                 episode_len: int = 10, seed: Optional[int] = None):
        self.observation_size = observation_size
        self.action_size = action_size
        self.episode_len = episode_len
        self._rng = np.random.default_rng(seed)
        self._steps = 0

    def reset(self, seed: Optional[int] = None):
        self._steps = 0
        return self._rng.normal(size=self.observation_size).astype(
            np.float32), {}

    def step(self, action: int):
        self._steps += 1
        obs = self._rng.normal(size=self.observation_size).astype(
            np.float32)
        return (obs, float(self._rng.normal()), False,
                self._steps >= self.episode_len, {})
