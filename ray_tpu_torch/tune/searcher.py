"""Pluggable search algorithms.

Reference: ``python/ray/tune/search/searcher.py`` (Searcher base:
suggest / on_trial_result / on_trial_complete / save / restore),
``tune/search/concurrency_limiter.py`` and the suggestion-based
adapters (``tune/search/optuna``). The TPE searcher is an original
lite implementation of tree-structured Parzen estimation over this
module's Domain types — good/bad split + per-dimension kernel density
ratio — not a port of hyperopt.
"""

from __future__ import annotations

import math
import pickle
import random
from typing import Any, Dict, List, Optional

from .search import (BasicVariantGenerator, Categorical, Domain,
                     LogUniform, RandInt, Uniform, _set_path, _split_spec)

# suggest() sentinel: the searcher will never produce another config
FINISHED = "FINISHED"


class Searcher:
    """Base class for search algorithms.

    Lifecycle: the Tuner calls ``set_search_properties`` once, then
    ``suggest(trial_id)`` per new trial (``None`` = nothing right now,
    ``FINISHED`` = exhausted), ``on_trial_result`` per report, and
    ``on_trial_complete`` exactly once per trial.
    """

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric: Optional[str],
                              mode: Optional[str],
                              param_space: Dict[str, Any]) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str,
                        result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        pass

    # -- persistence (experiment resume) --------------------------------
    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.__dict__, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            self.__dict__.update(pickle.load(f))


class BasicVariantSearcher(Searcher):
    """The default grid x random generator on the Searcher interface."""

    def __init__(self, param_space: Optional[Dict[str, Any]] = None,
                 num_samples: int = 1, seed: int = 0, **kw):
        super().__init__(**kw)
        self._param_space = param_space
        self._num_samples = num_samples
        self._seed = seed
        self._it = None

    def set_search_properties(self, metric, mode, param_space) -> bool:
        super().set_search_properties(metric, mode, param_space)
        if self._param_space is None:
            self._param_space = param_space
        return True

    def suggest(self, trial_id: str):
        if self._it is None:
            self._it = BasicVariantGenerator(
                self._param_space or {}, self._num_samples,
                seed=self._seed).variants()
        try:
            return next(self._it)
        except StopIteration:
            return FINISHED

    def save(self, path: str) -> None:  # iterator isn't picklable
        state = {k: v for k, v in self.__dict__.items() if k != "_it"}
        with open(path, "wb") as f:
            pickle.dump(state, f)


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions from the wrapped searcher
    (reference: ``tune/search/concurrency_limiter.py``)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def set_search_properties(self, metric, mode, param_space) -> bool:
        super().set_search_properties(metric, mode, param_space)
        return self.searcher.set_search_properties(metric, mode,
                                                   param_space)

    def suggest(self, trial_id: str):
        if len(self._live) >= self.max_concurrent:
            return None
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None and cfg is not FINISHED:
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id, result) -> None:
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None,
                          error: bool = False) -> None:
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)

    def save(self, path: str) -> None:
        self.searcher.save(path)

    def restore(self, path: str) -> None:
        self.searcher.restore(path)


class TPESearcher(Searcher):
    """Tree-structured Parzen estimator, lite.

    Completed trials are split into good (best ``gamma`` quantile) and
    bad sets; each continuous dimension gets a 1-D Parzen (Gaussian
    kernel) density per set, and ``n_candidates`` draws from the good
    density are scored by l(x)/g(x) — highest ratio wins. Categorical
    dimensions use count-weighted draws with a uniform prior. Falls
    back to random sampling for the first ``n_initial`` trials.
    """

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None, *, n_initial: int = 8,
                 gamma: float = 0.25, n_candidates: int = 24,
                 seed: int = 0):
        super().__init__(metric, mode)
        self.n_initial = n_initial
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._space: List = []          # [(path, Domain)]
        self._param_space: Dict[str, Any] = {}
        self._suggested: Dict[str, Dict[str, Any]] = {}
        self._obs: List = []            # [(flat_values, score)]

    def set_search_properties(self, metric, mode, param_space) -> bool:
        super().set_search_properties(metric, mode, param_space)
        self._param_space = param_space or {}
        self._space = [(p, d) for p, d in _split_spec(self._param_space)
                       if isinstance(d, Domain)]
        return True

    # -- domain helpers --------------------------------------------------
    @staticmethod
    def _to_unit(dom: Domain, v):
        """Map a value into the dimension's working space (log for
        LogUniform) or None for categoricals."""
        if isinstance(dom, LogUniform):
            return math.log(v)
        if isinstance(dom, (Uniform, RandInt)):
            return float(v)
        return None

    @staticmethod
    def _from_unit(dom: Domain, x):
        if isinstance(dom, LogUniform):
            return math.exp(x)
        if isinstance(dom, RandInt):
            v = int(round(x))
            v = max(dom.low, min(dom.high - 1, v))
            if dom.q:
                v = int(round(v / dom.q) * dom.q)
            return v
        if isinstance(dom, Uniform):
            v = max(dom.low, min(dom.high, x))
            if dom.q:
                v = round(v / dom.q) * dom.q
            return v
        return x

    def _bounds(self, dom: Domain):
        if isinstance(dom, LogUniform):
            return math.log(dom.low), math.log(dom.high)
        return float(dom.low), float(dom.high)

    def _sample_parzen(self, xs: List[float], lo: float, hi: float):
        """Draw one point from a Parzen mixture over xs."""
        if not xs:
            return self._rng.uniform(lo, hi)
        sigma = max((hi - lo) / max(len(xs), 1), 1e-12)
        mu = self._rng.choice(xs)
        return min(hi, max(lo, self._rng.gauss(mu, sigma)))

    @staticmethod
    def _parzen_pdf(x: float, xs: List[float], lo: float, hi: float):
        if not xs:
            return 1.0 / max(hi - lo, 1e-12)
        sigma = max((hi - lo) / max(len(xs), 1), 1e-12)
        acc = 0.0
        for mu in xs:
            z = (x - mu) / sigma
            acc += math.exp(-0.5 * z * z) / sigma
        return acc / len(xs) + 1e-12

    # -- searcher interface ----------------------------------------------
    def suggest(self, trial_id: str):
        if not self._space:
            return {}          # nothing to search; Tuner caps count
        flat: Dict[int, Any] = {}
        if len(self._obs) < self.n_initial:
            for i, (_, dom) in enumerate(self._space):
                flat[i] = dom.sample(self._rng)
        else:
            scored = sorted(self._obs, key=lambda o: o[1])
            n_good = max(1, int(math.ceil(self.gamma * len(scored))))
            good, bad = scored[:n_good], scored[n_good:]
            for i, (_, dom) in enumerate(self._space):
                if isinstance(dom, Categorical):
                    counts = {c: 1.0 for c in dom.categories}  # prior
                    for values, _ in good:
                        if values[i] in counts:
                            counts[values[i]] += 1.0
                    cats = list(counts)
                    flat[i] = self._rng.choices(
                        cats, weights=[counts[c] for c in cats])[0]
                    continue
                lo, hi = self._bounds(dom)
                gx = [self._to_unit(dom, v[i]) for v, _ in good]
                bx = [self._to_unit(dom, v[i]) for v, _ in bad]
                best_x, best_ratio = None, -1.0
                for _ in range(self.n_candidates):
                    x = self._sample_parzen(gx, lo, hi)
                    ratio = (self._parzen_pdf(x, gx, lo, hi)
                             / self._parzen_pdf(x, bx, lo, hi))
                    if ratio > best_ratio:
                        best_x, best_ratio = x, ratio
                flat[i] = self._from_unit(dom, best_x)
        config: Dict[str, Any] = {}
        for i, (path, _) in enumerate(self._space):
            _set_path(config, path, flat[i])
        self._suggested[trial_id] = {
            i: flat[i] for i in range(len(self._space))}
        return config

    def on_trial_complete(self, trial_id, result=None,
                          error: bool = False) -> None:
        values = self._suggested.pop(trial_id, None)
        if values is None or error or not result:
            return
        score = result.get(self.metric)
        if score is None:
            return
        score = float(score)
        if (self.mode or "min") == "max":
            score = -score
        self._obs.append((values, score))

    def save(self, path: str) -> None:
        state = dict(self.__dict__)
        state["_rng"] = self._rng.getstate()
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def restore(self, path: str) -> None:
        with open(path, "rb") as f:
            state = pickle.load(f)
        rng_state = state.pop("_rng")
        self.__dict__.update(state)
        self._rng = random.Random()
        self._rng.setstate(rng_state)


class OptunaSearcher(Searcher):
    """Adapter for an installed optuna (reference:
    ``tune/search/optuna/optuna_search.py``). Gated: optuna is an
    optional dependency and absent from the target image."""

    def __init__(self, metric: Optional[str] = None,
                 mode: Optional[str] = None, *, seed: int = 0,
                 sampler: Any = None):
        try:
            import optuna  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "OptunaSearcher requires the optional 'optuna' package, "
                "which is not installed. Use TPESearcher for a "
                "dependency-free suggestion searcher.") from e
        import optuna
        super().__init__(metric, mode)
        self._seed = seed
        direction = "maximize" if (mode or "min") == "max" else "minimize"
        self._study = optuna.create_study(
            direction=direction,
            sampler=sampler or optuna.samplers.TPESampler(seed=seed))
        self._space: List = []
        self._trials: Dict[str, Any] = {}

    def set_search_properties(self, metric, mode, param_space) -> bool:
        super().set_search_properties(metric, mode, param_space)
        self._space = [(p, d) for p, d in _split_spec(param_space or {})
                       if isinstance(d, Domain)]
        return True

    def suggest(self, trial_id: str):
        ot = self._study.ask()
        config: Dict[str, Any] = {}
        for path, dom in self._space:
            name = ".".join(path)
            if isinstance(dom, Categorical):
                v = ot.suggest_categorical(name, dom.categories)
            elif isinstance(dom, LogUniform):
                v = ot.suggest_float(name, dom.low, dom.high, log=True)
            elif isinstance(dom, RandInt):
                v = ot.suggest_int(name, dom.low, dom.high - 1)
            elif isinstance(dom, Uniform):
                v = ot.suggest_float(name, dom.low, dom.high)
            else:
                v = dom.sample(random.Random(self._seed))
            _set_path(config, path, v)
        self._trials[trial_id] = ot
        return config

    def on_trial_complete(self, trial_id, result=None,
                          error: bool = False) -> None:
        ot = self._trials.pop(trial_id, None)
        if ot is None:
            return
        import optuna
        if error or not result or result.get(self.metric) is None:
            self._study.tell(ot,
                             state=optuna.trial.TrialState.FAIL)
        else:
            self._study.tell(ot, float(result[self.metric]))
