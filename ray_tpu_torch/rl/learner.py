"""Learner: the policy's SGD update on the card.

Counterpart of ``ray_tpu/rl/learner.py:25-141`` (``Learner``). The JAX
learner's update is one jitted program on the accelerator; here it is one
forward, one backward and one clipped Adam update on ``device`` (the card by
default). The optimizer is ``models.training.Optimizer`` with optax's
``chain(clip_by_global_norm(grad_clip), adam(lr))``: b1 0.9, b2 0.999, eps
1e-8, no decay, a constant learning rate. The batch moves to the device
once per update, and the stats come back as Python floats in one copy.

The actor forms (``_LearnerActor``, ``LearnerGroup``) wait for the port's
runtime core.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.gpt import resolve_device
from ..models.training import Optimizer
from . import sample_batch as SB
from .convert import params_from_jax, params_to_jax
from .module import DiscretePolicyModule

Batch = Dict[str, torch.Tensor]
Stats = Dict[str, torch.Tensor]


def to_device(batch, device: torch.device) -> Batch:
    """A batch of numpy columns -> tensors on `device`, one copy each."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def sgd_step(module: torch.nn.Module, optimizer: Optimizer, opt_state: Dict,
             loss_fn: Callable[[Batch], Tuple[torch.Tensor, Stats]],
             batch: Batch) -> Dict[str, float]:
    """One step of `optimizer` on `module`'s parameters against
    ``loss_fn(batch)``; the stats as Python floats."""
    params = dict(module.named_parameters())
    for p in params.values():
        p.grad = None
    loss, stats = loss_fn(batch)
    loss.backward()
    with torch.no_grad():
        optimizer.update_(params, [p.grad for p in params.values()],
                          opt_state)
        values = torch.stack([v.detach().float() for v in stats.values()])
    for p in params.values():
        p.grad = None
    return dict(zip(stats, values.tolist()))


def adam(lr: float, grad_clip: float) -> Optimizer:
    """optax's ``adam(lr)`` after ``clip_by_global_norm(grad_clip)``
    (``grad_clip=inf``: no clip)."""
    return Optimizer(learning_rate=lr, weight_decay=0.0, b2=0.999,
                     grad_clip=grad_clip, schedule="constant")


class Learner:
    """PPO-style clipped surrogate learner (the loss fn is pluggable).

    The learner owns `module`: it draws its weights from `seed`, as JAX's
    ``module.init(PRNGKey(seed))``, and moves it to `device`. ``loss_fn``,
    where given, is ``loss_fn(module, batch) -> (loss, stats)`` on a batch
    of device tensors (JAX's takes the params pytree in place of the
    module)."""

    def __init__(self, module: DiscretePolicyModule,
                 *, lr: float = 3e-4, clip: float = 0.2,
                 vf_coeff: float = 0.5, entropy_coeff: float = 0.0,
                 grad_clip: float = 0.5, seed: int = 0,
                 gamma: float = 0.99,
                 rho_clip: float = 1.0, c_clip: float = 1.0,
                 loss: str = "ppo",
                 loss_fn: Optional[Callable] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        module.init_weights(seed)
        self.module = module.to(self.device)
        self.clip = clip
        self.vf_coeff = vf_coeff
        self.entropy_coeff = entropy_coeff
        self.gamma = gamma
        self.rho_clip = rho_clip
        self.c_clip = c_clip
        self.optimizer = adam(lr, grad_clip)
        with torch.no_grad():
            self.opt_state = self.optimizer.init(
                dict(module.named_parameters()))
        builtin = {"ppo": self._ppo_loss, "vtrace": self._vtrace_loss}
        self._loss_fn = loss_fn or builtin[loss]

    # --------------------------------------------------------------- losses
    def _ppo_loss(self, module, batch) -> Tuple[torch.Tensor, Stats]:
        logits, values = module(batch[SB.OBS])
        logp_all = torch.log_softmax(logits, dim=-1)
        actions = batch[SB.ACTIONS].long()
        logp = logp_all.gather(-1, actions[:, None])[:, 0]
        ratio = torch.exp(logp - batch[SB.LOGP])
        adv = batch[SB.ADVANTAGES]
        # jnp.std is the population std
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1 - self.clip, 1 + self.clip) * adv
        pg_loss = -torch.minimum(pg1, pg2).mean()
        vf_loss = 0.5 * ((values - batch[SB.VALUE_TARGETS]) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        loss = (pg_loss + self.vf_coeff * vf_loss
                - self.entropy_coeff * entropy)
        stats = {"pg_loss": pg_loss, "vf_loss": vf_loss,
                 "entropy": entropy, "total_loss": loss,
                 "approx_kl": (batch[SB.LOGP] - logp).mean()}
        return loss, stats

    def vtrace_targets(self, values: torch.Tensor, bootstrap: torch.Tensor,
                       rho: torch.Tensor, batch: Batch
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """V-trace targets (Espeholt et al. 2018) over [B, T] fragments, and
        the policy-gradient advantages, both without gradient: JAX's
        ``lax.scan`` over time in reverse becomes a loop over T on [B]
        tensors."""
        values, bootstrap, rho = (x.detach() for x in (values, bootstrap,
                                                       rho))
        rho_c = torch.clamp(rho, max=self.rho_clip)
        cs = torch.clamp(rho, max=self.c_clip)
        discounts = self.gamma * (1.0 - batch[SB.DONES].float())
        values_tp1 = torch.cat([values[:, 1:], bootstrap[:, None]], dim=1)
        rewards = batch[SB.REWARDS]
        deltas = rho_c * (rewards + discounts * values_tp1 - values)
        acc = torch.zeros_like(bootstrap)
        accs = []
        for t in range(values.shape[1] - 1, -1, -1):
            acc = deltas[:, t] + discounts[:, t] * cs[:, t] * acc
            accs.append(acc)
        vs = values + torch.stack(accs[::-1], dim=1)           # (B,T)
        vs_tp1 = torch.cat([vs[:, 1:], bootstrap[:, None]], dim=1)
        pg_adv = rho_c * (rewards + discounts * vs_tp1 - values)
        return vs, pg_adv

    def _vtrace_loss(self, module, batch) -> Tuple[torch.Tensor, Stats]:
        """IMPALA's V-trace off-policy actor-critic loss over env-major
        fragments. Batch layout: obs (B,T,D), actions/rewards/dones/
        action_logp (B,T), bootstrap_obs (B,D)."""
        obs = batch[SB.OBS]
        bsz, horizon = obs.shape[0], obs.shape[1]
        logits, values = module(obs.reshape(bsz * horizon, -1))
        logits = logits.reshape(bsz, horizon, -1)
        values = values.reshape(bsz, horizon)
        logp_all = torch.log_softmax(logits, dim=-1)
        actions = batch[SB.ACTIONS].long()
        tlogp = logp_all.gather(-1, actions[..., None])[..., 0]
        rho = torch.exp(tlogp - batch[SB.LOGP])
        with torch.no_grad():
            _, bootstrap = module(batch["bootstrap_obs"])
        vs, pg_adv = self.vtrace_targets(values, bootstrap, rho, batch)
        pg_loss = -(tlogp * pg_adv).mean()
        vf_loss = 0.5 * ((vs - values) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        loss = (pg_loss + self.vf_coeff * vf_loss
                - self.entropy_coeff * entropy)
        stats = {"pg_loss": pg_loss, "vf_loss": vf_loss,
                 "entropy": entropy, "total_loss": loss,
                 "mean_rho": rho.mean()}
        return loss, stats

    # --------------------------------------------------------------- update
    def update(self, batch: SB.SampleBatch) -> Dict[str, float]:
        return sgd_step(self.module, self.optimizer, self.opt_state,
                        lambda b: self._loss_fn(self.module, b),
                        to_device(batch, self.device))

    def get_weights(self):
        return params_to_jax(self.module.state_dict())

    def set_weights(self, weights) -> None:
        self.module.load_state_dict(params_from_jax(weights))
