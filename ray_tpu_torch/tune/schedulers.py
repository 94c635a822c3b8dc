"""Trial schedulers: FIFO, ASHA, PBT.

Reference: ``tune/schedulers/async_hyperband.py`` (AsyncHyperBand/ASHA),
``tune/schedulers/pbt.py`` (PopulationBasedTraining),
``tune/schedulers/trial_scheduler.py`` (decision protocol CONTINUE/STOP).
Decisions are made on every reported result.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"
# PBT: restart the trial from a better trial's checkpoint w/ mutated config
EXPLOIT = "EXPLOIT"


class FIFOScheduler:
    def on_result(self, trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial) -> None:
        pass


class ASHAScheduler:
    """Asynchronous Successive Halving.

    Rungs at max_t / reduction_factor^k. When a trial reaches a rung, it
    continues only if its metric is in the top 1/reduction_factor of
    completed entries at that rung (async: decided against results so
    far, no waiting for a full bracket).
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 3.0,
                 time_attr: str = "training_iteration"):
        assert mode in ("min", "max")
        self.metric, self.mode = metric, mode
        self.max_t, self.grace = max_t, grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        # rung thresholds (ascending)
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(int(t))
            t *= reduction_factor
        # rung -> list of recorded metric values
        self._recorded: Dict[int, List[float]] = {r: [] for r in self.rungs}
        # trial -> highest rung already judged (so a trial whose
        # time_attr jumps over a rung value still gets judged exactly
        # once per rung, at the first report past it)
        self._trial_rung: Dict[Any, int] = {}

    def _better(self, value: float, peers: List[float]) -> bool:
        """Is value in the top 1/rf quantile of peers (self included)?"""
        all_vals = sorted(peers + [value],
                          reverse=(self.mode == "max"))
        cutoff_idx = max(0, int(math.ceil(len(all_vals) / self.rf)) - 1)
        cutoff = all_vals[cutoff_idx]
        return (value >= cutoff) if self.mode == "max" else (value <= cutoff)

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, 0)
        if t >= self.max_t:
            return STOP
        value = result.get(self.metric)
        if value is None:
            return CONTINUE
        judged = self._trial_rung.get(trial, -1)
        for rung in reversed(self.rungs):
            # first report at-or-past a rung not yet judged for this
            # trial triggers the halving decision (exact equality let
            # trials whose time_attr skips rung values run to max_t)
            if t >= rung and rung > judged:
                self._trial_rung[trial] = rung
                peers = self._recorded[rung]
                keep = self._better(float(value), peers)
                peers.append(float(value))
                return CONTINUE if keep else STOP
        return CONTINUE

    def on_trial_complete(self, trial) -> None:
        self._trial_rung.pop(trial, None)


class PopulationBasedTraining:
    """PBT: at each perturbation interval, bottom-quantile trials clone a
    top-quantile trial's checkpoint and mutate its config (explore)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 2,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 time_attr: str = "training_iteration",
                 seed: int = 0):
        assert mode in ("min", "max")
        self.metric, self.mode = metric, mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.time_attr = time_attr
        self.rng = random.Random(seed)
        self._last: Dict[Any, Dict[str, Any]] = {}   # trial -> last result

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        self._last[trial] = result
        t = result.get(self.time_attr, 0)
        if t == 0 or t % self.interval:
            return CONTINUE
        ranked = self._ranked_trials()
        if len(ranked) < 2:
            return CONTINUE
        n_q = max(1, int(len(ranked) * self.quantile))
        bottom = ranked[-n_q:]
        if trial in bottom and trial is not ranked[0]:
            return EXPLOIT
        return CONTINUE

    def exploit_target(self, trial):
        """Pick a top-quantile trial to clone from."""
        ranked = self._ranked_trials()
        n_q = max(1, int(len(ranked) * self.quantile))
        top = [t for t in ranked[:n_q] if t is not trial]
        return self.rng.choice(top) if top else None

    def explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Mutate hyperparams (reference: perturb by 0.8/1.2 or resample)."""
        from .search import Domain
        new = dict(config)
        for key, spec in self.mutations.items():
            if key not in new:
                continue
            if isinstance(spec, list):
                new[key] = self.rng.choice(spec)
            elif isinstance(spec, Domain):
                new[key] = spec.sample(self.rng)
            elif callable(spec):
                new[key] = spec()
            elif isinstance(new[key], (int, float)):
                factor = self.rng.choice((0.8, 1.2))
                new[key] = type(new[key])(new[key] * factor)
        return new

    def _ranked_trials(self) -> List[Any]:
        scored = [(t, r.get(self.metric)) for t, r in self._last.items()
                  if r.get(self.metric) is not None]
        return [t for t, v in sorted(
            scored, key=lambda kv: kv[1],
            reverse=(self.mode == "max"))]

    def on_trial_complete(self, trial) -> None:
        self._last.pop(trial, None)
