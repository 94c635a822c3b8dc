"""Replay buffer library.

Reference: ``rllib/utils/replay_buffers/`` (ReplayBuffer,
PrioritizedReplayBuffer with proportional sampling + importance
weights, per Schaul et al. 2016). The port's own copy of
``ray_tpu/rl/replay_buffers.py`` (numpy only): sampling under a seed equals
the JAX package's exactly. The in-process form only: the actor form
(``as_remote``) waits for the port's runtime core.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class ReplayBuffer:
    """Uniform-sampling FIFO ring of items (transitions or fragments)."""

    def __init__(self, capacity: int, seed: Optional[int] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._items: List[Any] = []
        self._next = 0
        self._rng = np.random.default_rng(seed)
        self.num_added = 0

    def __len__(self) -> int:
        return len(self._items)

    def add(self, item: Any) -> None:
        if len(self._items) < self.capacity:
            self._items.append(item)
        else:
            self._items[self._next] = item
        self._next = (self._next + 1) % self.capacity
        self.num_added += 1

    def sample(self, n: int) -> List[Any]:
        """n items uniformly with replacement (empty buffer -> [])."""
        if not self._items:
            return []
        idx = self._rng.integers(0, len(self._items), size=n)
        return [self._items[i] for i in idx]

    def stats(self) -> Dict[str, Any]:
        return {"size": len(self._items), "num_added": self.num_added,
                "capacity": self.capacity}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference:
    ``prioritized_replay_buffer.py``; Schaul et al. 2016).

    ``sample`` draws with probability p_i^alpha / sum p^alpha and
    returns importance weights w_i = (N * P(i))^-beta normalized by
    max w; ``update_priorities`` feeds TD errors back.
    """

    def __init__(self, capacity: int, *, alpha: float = 0.6,
                 seed: Optional[int] = None):
        super().__init__(capacity, seed=seed)
        if alpha < 0:
            raise ValueError("alpha must be >= 0")
        self.alpha = alpha
        self._prios = np.zeros(capacity, dtype=np.float64)
        self._max_prio = 1.0

    def add(self, item: Any, priority: Optional[float] = None) -> None:
        slot = (len(self._items) if len(self._items) < self.capacity
                else self._next)
        super().add(item)
        # same signed-TD normalization as update_priorities: raw TD
        # errors are signed, and a negative base under fractional alpha
        # would go complex
        p = (float(abs(priority)) + 1e-6 if priority is not None
             else self._max_prio)
        self._max_prio = max(self._max_prio, p)
        self._prios[slot] = p ** self.alpha

    def sample(self, n: int, beta: float = 0.4
               ) -> Tuple[List[Any], np.ndarray, np.ndarray]:
        """Returns (items, indices, importance_weights)."""
        size = len(self._items)
        if not size:
            return [], np.asarray([], np.int64), np.asarray([])
        p = self._prios[:size]
        total = p.sum()
        probs = (p / total) if total > 0 else np.full(size, 1.0 / size)
        idx = self._rng.choice(size, size=n, p=probs)
        weights = (size * probs[idx]) ** (-beta)
        weights = weights / weights.max()
        return [self._items[i] for i in idx], idx, weights

    def update_priorities(self, indices: np.ndarray,
                          priorities: np.ndarray) -> None:
        for i, p in zip(np.asarray(indices), np.asarray(priorities)):
            p = float(abs(p)) + 1e-6
            self._max_prio = max(self._max_prio, p)
            if 0 <= int(i) < len(self._items):
                self._prios[int(i)] = p ** self.alpha
