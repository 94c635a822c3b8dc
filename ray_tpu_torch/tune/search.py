"""Search spaces + variant generation.

Reference: ``tune/search/sample.py`` (Domain/Categorical/Float/Integer,
grid_search) and ``tune/search/basic_variant.py`` (BasicVariantGenerator
— cartesian grid expansion x num_samples random draws).
"""

from __future__ import annotations

import math
import random
from typing import Any, Callable, Dict, Iterator, List


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, low, high, q=None):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        v = rng.uniform(self.low, self.high)
        if self.q:
            v = round(v / self.q) * self.q
        return v


class LogUniform(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low),
                                    math.log(self.high)))


class RandInt(Domain):
    def __init__(self, low, high, q=None):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        v = rng.randrange(self.low, self.high)
        if self.q:
            v = int(round(v / self.q) * self.q)
        return v


class Function(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        return self.fn(None)


class _GridSearch:
    def __init__(self, values):
        self.values = list(values)


# -- public constructors (reference: ``tune/search/sample.py``) -----------

def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def quniform(low, high, q) -> Uniform:
    return Uniform(low, high, q)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def randint(low, high) -> RandInt:
    return RandInt(low, high)


def qrandint(low, high, q) -> RandInt:
    return RandInt(low, high, q)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values) -> Dict[str, Any]:
    return {"grid_search": list(values)}


# -- variant generation ----------------------------------------------------

def _split_spec(spec: Dict[str, Any], path=()):
    """Walk a (possibly nested) param space, yielding (path, domain)."""
    for key, value in spec.items():
        p = path + (key,)
        if isinstance(value, dict) and "grid_search" in value \
                and len(value) == 1:
            yield p, _GridSearch(value["grid_search"])
        elif isinstance(value, dict):
            yield from _split_spec(value, p)
        elif isinstance(value, Domain):
            yield p, value


def _set_path(config: Dict[str, Any], path, value) -> None:
    d = config
    for key in path[:-1]:
        d = d.setdefault(key, {})
    d[path[-1]] = value


def _deep_copy_static(spec):
    if isinstance(spec, dict):
        if "grid_search" in spec and len(spec) == 1:
            return None
        return {k: _deep_copy_static(v) for k, v in spec.items()}
    if isinstance(spec, Domain):
        return None
    return spec


class BasicVariantGenerator:
    """Grid cartesian product x num_samples random draws."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: int = 0):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)

    def variants(self) -> Iterator[Dict[str, Any]]:
        entries = list(_split_spec(self.param_space))
        grids = [(p, d) for p, d in entries if isinstance(d, _GridSearch)]
        domains = [(p, d) for p, d in entries
                   if not isinstance(d, _GridSearch)]

        def grid_combos(i, acc):
            if i == len(grids):
                yield list(acc)
                return
            path, g = grids[i]
            for v in g.values:
                acc.append((path, v))
                yield from grid_combos(i + 1, acc)
                acc.pop()

        for _ in range(self.num_samples):
            for combo in grid_combos(0, []):
                config = _deep_copy_static(self.param_space) or {}
                for path, v in combo:
                    _set_path(config, path, v)
                for path, d in domains:
                    _set_path(config, path, d.sample(self.rng))
                yield config
