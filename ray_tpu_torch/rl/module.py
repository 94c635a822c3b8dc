"""RL modules: the policy/value network and the Q network as nn.Modules.

Counterpart of ``ray_tpu/rl/module.py``. The parameters keep the JAX
module's layout under dotted names: ``torso.{i}.w``/``.b``, ``pi.w``/``.b``,
``vf.w``/``.b`` (policy) or ``q.w``/``.b`` (Q network), each ``w`` stored
``[n_in, n_out]`` so that a layer is ``x @ w + b`` as in JAX (``convert.py``
maps the JAX pytree to and from these names). ``init_weights(seed)`` is the
counterpart of JAX's ``init(PRNGKey(seed))``: the same orthogonal init, from
a ``torch.Generator`` on the CPU, so its draws differ from JAX's; parity runs
on converted weights. The same module runs on the card (the learners) and
on the CPU (the env runners).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


def _resize(q: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """``jnp.resize``: the flattened `q` repeated cyclically to fill
    `shape`."""
    flat = q.reshape(-1)
    total = shape[0] * shape[1]
    return flat.repeat(math.ceil(total / flat.numel()))[:total].reshape(shape)


def _orthogonal(gen: torch.Generator, n_in: int, n_out: int,
                scale: float) -> torch.Tensor:
    """JAX's ``_dense_init`` weight: QR of a normal [n_in, n_out] draw with
    the sign fix, tiled by ``jnp.resize`` when n_in < n_out."""
    a = torch.randn(n_in, n_out, generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if q.shape != (n_in, n_out):
        q = _resize(q, (n_in, n_out))
    return q * scale


class _Dense(nn.Module):
    """``x @ w + b`` with ``w`` [n_in, n_out], as the JAX module's layers."""

    def __init__(self, n_in: int, n_out: int, scale: float):
        super().__init__()
        self.scale = scale
        self.w = nn.Parameter(torch.zeros(n_in, n_out))
        self.b = nn.Parameter(torch.zeros(n_out))

    def init_weights(self, gen: torch.Generator) -> None:
        n_in, n_out = self.w.shape
        with torch.no_grad():
            self.w.copy_(_orthogonal(gen, n_in, n_out, self.scale))
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class _MLP(nn.Module):
    """tanh torso of `hidden` widths, then the named heads."""

    heads: Tuple[Tuple[str, Optional[int], float], ...] = ()

    def __init__(self, observation_size: int, action_size: int,
                 hidden: Tuple[int, ...] = (64, 64)):
        super().__init__()
        self.observation_size = observation_size
        self.action_size = action_size
        self.hidden = tuple(hidden)
        widths = (observation_size,) + self.hidden
        self.torso = nn.ModuleList(
            _Dense(n_in, n_out, math.sqrt(2.0))
            for n_in, n_out in zip(widths, widths[1:]))
        for name, n_out, scale in self.heads:
            self.add_module(name, _Dense(widths[-1], n_out or action_size,
                                         scale))
        self.init_weights(0)

    def init_weights(self, seed: int) -> None:
        """Draw every layer anew from `seed` (torso first, then the heads in
        order, as JAX splits its key), on the CPU, whatever the device."""
        gen = torch.Generator().manual_seed(seed)
        for layer in self.torso:
            layer.init_weights(gen)
        for name, _, _ in self.heads:
            getattr(self, name).init_weights(gen)

    def _torso(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for layer in self.torso:
            x = torch.tanh(layer(x))
        return x


class DiscretePolicyModule(_MLP):
    """MLP torso + categorical policy head + value head."""

    heads = (("pi", None, 0.01), ("vf", 1, 1.0))

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs [B, obs_size] -> (logits [B, A], value [B])."""
        x = self._torso(obs)
        return self.pi(x), self.vf(x)[..., 0]

    def action_dist(self, obs: torch.Tensor, generator: torch.Generator
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Sample actions: (action, logp, value). `generator` lies on the
        module's device; JAX draws with ``jax.random.categorical``, so the
        samples differ from JAX's, their log-probabilities do not."""
        logits, value = self.forward(obs)
        logp_all = torch.log_softmax(logits, dim=-1)
        action = torch.multinomial(logp_all.exp(), 1, generator=generator)
        logp = logp_all.gather(-1, action)[:, 0]
        return action[:, 0], logp, value


class QNetworkModule(_MLP):
    """MLP state-action value network: obs -> Q[B, A] (reference:
    DQN's default model — same torso family as the policy module)."""

    heads = (("q", None, 0.01),)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.q(self._torso(obs))
