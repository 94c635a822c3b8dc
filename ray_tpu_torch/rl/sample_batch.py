"""SampleBatch: columnar rollout data (reference:
``rllib/policy/sample_batch.py:98``).

The port's own copy of ``ray_tpu/rl/sample_batch.py`` (numpy only): the
same column names, and GAE columns equal to the JAX package's exactly."""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
LOGP = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"


class SampleBatch(dict):
    """Dict of equal-length numpy arrays."""

    def __len__(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @property
    def count(self) -> int:
        return len(self)

    def shuffle(self, seed=None) -> "SampleBatch":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self))
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        n = len(self)
        for lo in range(0, n - size + 1, size):
            yield SampleBatch({k: v[lo:lo + size]
                               for k, v in self.items()})

    def slice(self, lo: int, hi: int) -> "SampleBatch":
        return SampleBatch({k: v[lo:hi] for k, v in self.items()})


def concat_batches(batches: Sequence[SampleBatch]) -> SampleBatch:
    batches = [b for b in batches if len(b)]
    if not batches:
        return SampleBatch()
    keys = batches[0].keys()
    return SampleBatch({k: np.concatenate([b[k] for b in batches])
                        for k in keys})


def compute_gae(batch: SampleBatch, *, gamma: float = 0.99,
                lam: float = 0.95,
                last_value: float = 0.0) -> SampleBatch:
    """Generalized advantage estimation over a (possibly multi-episode)
    trajectory; ``dones`` cuts bootstrapping (reference:
    ``rllib/evaluation/postprocessing.py`` compute_advantages)."""
    rewards = batch[REWARDS]
    values = batch[VF_PREDS]
    dones = batch[DONES].astype(np.float32)
    n = len(rewards)
    adv = np.zeros(n, np.float32)
    next_value = last_value
    next_adv = 0.0
    for t in range(n - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        next_adv = delta + gamma * lam * nonterminal * next_adv
        adv[t] = next_adv
        next_value = values[t]
    out = SampleBatch(batch)
    out[ADVANTAGES] = adv
    out[VALUE_TARGETS] = (adv + values).astype(np.float32)
    return out
