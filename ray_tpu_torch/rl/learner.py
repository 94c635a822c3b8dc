"""Learner: the policy's SGD update on the card.

Counterpart of ``ray_tpu/rl/learner.py:25-141`` (``Learner``). The JAX
learner's update is one jitted program on the accelerator; here it is one
forward, one backward and one clipped Adam update on ``device`` (the card by
default). The optimizer is ``models.training.Optimizer`` with optax's
``chain(clip_by_global_norm(grad_clip), adam(lr))``: b1 0.9, b2 0.999, eps
1e-8, no decay, a constant learning rate. The batch moves to the device
once per update, and the stats come back as Python floats in one copy.

The actor forms: ``_LearnerActor`` holds a ``Learner`` in an actor of the
port's runtime, which gets its card through a GPU slot, and
``LearnerGroup`` (``ray_tpu/rl/learner.py:144-224``) places one or more of
them, splits each batch over them and averages their weights in numpy, as
JAX's does. Weights cross actors as ``get_weights`` gives them, JAX's
pytree layout with numpy leaves.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.gpt import resolve_device
from ..models.training import Optimizer
from . import sample_batch as SB
from ._remote import RemoteMixin
from .convert import params_from_jax, params_to_jax
from .module import DiscretePolicyModule

Batch = Dict[str, torch.Tensor]
Stats = Dict[str, torch.Tensor]


def to_device(batch, device: torch.device) -> Batch:
    """A batch of numpy columns -> tensors on `device`, one copy each (a
    read-only column, as an actor gets it from the object store, is copied
    on the CPU too)."""
    return {k: torch.as_tensor(v if getattr(v, "flags", None) is None
                               or v.flags.writeable else v.copy(),
                               device=device)
            for k, v in batch.items()}


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


class _LearnerActor(RemoteMixin):
    """A `Learner` in an actor; with a GPU slot its device "cuda" is the
    slot's card."""

    def __init__(self, module_config: dict, learner_kwargs: dict):
        module = DiscretePolicyModule(**module_config)
        self.learner = Learner(module, **learner_kwargs)

    def update(self, batch) -> Dict[str, float]:
        return self.learner.update(SB.SampleBatch(batch))

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights) -> None:
        self.learner.set_weights(weights)

    def kernel_launches(self, reset: bool = False) -> Dict[str, int]:
        """This process's flash-kernel launch counts (`ops.attention`),
        set to 0 after reading when `reset`."""
        from ..ops import attention
        counts = dict(attention.launches)
        if reset:
            attention.reset_launch_counts()
        return counts


def learner_actor_options(resources: Optional[dict], device) -> dict:
    """Actor options for a learner: ``resources_per_learner`` as
    num_cpus / num_gpus / custom resources; by default one GPU slot when
    the learner's device is the card."""
    if resources is None:
        resources = ({"GPU": 1} if torch.device(device).type == "cuda"
                     else {})
    res = dict(resources)
    opts = {}
    if "CPU" in res:
        opts["num_cpus"] = res.pop("CPU")
    if "GPU" in res:
        opts["num_gpus"] = res.pop("GPU")
    if res:
        opts["resources"] = res
    return opts


def mean_weights(trees):
    """The element-wise mean of weight pytrees (dicts and lists with numpy
    leaves), in numpy, as JAX's ``tree_map(np.mean(np.stack(...)))``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: mean_weights([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(mean_weights(list(ws)) for ws in zip(*trees))
    return np.mean(np.stack(trees), axis=0)


class LearnerGroup:
    """Placement wrapper: run the learner on its own actor, on a card of
    its own unless `device` (a learner kwarg) is "cpu".

    num_learners>1 splits each batch and averages weights after update —
    only useful across cards; on one card prefer one learner.
    """

    def __init__(self, module: DiscretePolicyModule, *,
                 num_learners: int = 1,
                 resources_per_learner: Optional[dict] = None,
                 **learner_kwargs):
        opts = learner_actor_options(resources_per_learner,
                                     learner_kwargs.get("device", "cuda"))
        cfg = {"observation_size": module.observation_size,
               "action_size": module.action_size,
               "hidden": module.hidden}
        self._actors = [
            _LearnerActor.options(**opts).remote(cfg, learner_kwargs)
            for _ in range(num_learners)]

    def update(self, batch: SB.SampleBatch) -> Dict[str, float]:
        from .. import get
        b = len(batch)
        # never hand a learner an empty slice: with fewer rows than
        # learners (async algorithms often deliver a single fragment)
        # only the first len(batch) actors participate this round
        parts = self._actors[:max(1, min(len(self._actors), b))]
        n = len(parts)
        if n == 1:
            stats = [get(parts[0].update.remote(dict(batch)))]
        else:
            size = b // n
            refs = []
            for i, a in enumerate(parts):
                hi = b if i == n - 1 else (i + 1) * size
                refs.append(a.update.remote(dict(batch.slice(i * size,
                                                             hi))))
            stats = get(refs)
        if len(self._actors) > 1:
            # data-parallel consensus over the participants, broadcast
            # to everyone (non-participants hold pre-update weights)
            weights = get([a.get_weights.remote() for a in parts])
            mean_w = mean_weights(weights)
            get([a.set_weights.remote(mean_w) for a in self._actors])
        return {k: float(np.mean([s[k] for s in stats]))
                for k in stats[0]}

    def get_weights(self):
        from .. import get
        return get(self._actors[0].get_weights.remote())

    def kernel_launches(self, reset: bool = False) -> Dict[str, int]:
        """The learners' flash-kernel launch counts, summed over their
        processes (each set to 0 after reading when `reset`)."""
        from .. import get
        counts = get([a.kernel_launches.remote(reset)
                      for a in self._actors])
        return {k: sum(c[k] for c in counts) for k in counts[0]}

    def shutdown(self) -> None:
        from .. import kill
        for a in self._actors:
            try:
                kill(a)
            except Exception:
                pass
