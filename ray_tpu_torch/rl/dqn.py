"""DQNLearner: the double-DQN update and its target network on the card.

Counterpart of ``ray_tpu/rl/dqn.py:27,65-135`` (``NEXT_OBS``,
``DQNLearner``): the online net picks a' and the target net evaluates it, a
Huber loss at ``huber_delta``, Adam without a clip
(``models.training.Optimizer``), and the target network copied from the
online one every ``target_update_freq`` updates.

The replay-buffer actor and ``DQN``/``DQNConfig`` wait for the port's
runtime core.
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import torch

from ..models.gpt import resolve_device
from . import sample_batch as SB
from .convert import params_to_jax
from .learner import Batch, Stats, adam, sgd_step, to_device
from .module import QNetworkModule

NEXT_OBS = "next_obs"


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
