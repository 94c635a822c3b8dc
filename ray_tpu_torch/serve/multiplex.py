"""Model multiplexing: many models share one replica pool.

Reference: ``python/ray/serve/multiplex.py`` (_ModelMultiplexWrapper —
per-replica LRU of loaded models keyed by model id, evicting beyond
``max_num_models_per_replica``) and ``serve/api.py``
``get_multiplexed_model_id``. Requests carry the model id through
``handle.options(multiplexed_model_id=...)``; the handle routes
requests for one model to the replica that already loaded it (cache
locality), and the replica's wrapper loads/evicts on demand.
"""

from __future__ import annotations

import contextvars

from .._private import locksan
from collections import OrderedDict
from typing import Any, Callable, Optional

_current_model_id: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("rtpu_serve_model_id", default=None)


def get_multiplexed_model_id() -> str:
    """Inside a deployment handler: the model id of the current request
    (empty string when the request carried none)."""
    return _current_model_id.get() or ""


def _set_request_model_id(model_id: Optional[str]):
    return _current_model_id.set(model_id)


def _reset_request_model_id(token) -> None:
    _current_model_id.reset(token)


class _MultiplexCache:
    """Per-replica-instance LRU of loaded models."""

    def __init__(self, loader: Callable, max_models: int):
        self._loader = loader
        self._max = max_models
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = locksan.lock("serve.multiplex")

    def get(self, instance, model_id: str):
        with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
        # load OUTSIDE the lock (loads can be slow); a racing duplicate
        # load is wasted work, not an error
        model = self._loader(instance, model_id)
        with self._lock:
            self._models[model_id] = model
            self._models.move_to_end(model_id)
            while len(self._models) > self._max:
                _, old = self._models.popitem(last=False)
                # cooperative unload hook; NOT __del__ (invoking a
                # finalizer directly would run it again at GC time)
                unload = getattr(old, "unload", None)
                if callable(unload):
                    try:
                        unload()
                    except Exception:   # noqa: BLE001 — eviction is
                        pass            # best-effort
        return model

    def model_ids(self):
        with self._lock:
            return list(self._models)


def multiplexed(max_num_models_per_replica: int = 3):
    """Decorator for a deployment method ``def get_model(self, model_id)``
    that loads one model; calls are LRU-cached per replica up to
    ``max_num_models_per_replica`` (reference: ``serve.multiplexed``)."""
    if max_num_models_per_replica < 1:
        raise ValueError("max_num_models_per_replica must be >= 1")

    def deco(fn: Callable):
        cache_attr = f"__rtpu_mux_{fn.__name__}"

        def wrapper(self, model_id: str):
            cache = getattr(self, cache_attr, None)
            if cache is None:
                cache = _MultiplexCache(fn, max_num_models_per_replica)
                setattr(self, cache_attr, cache)
            return cache.get(self, model_id)

        wrapper.__name__ = fn.__name__
        wrapper.__rtpu_multiplexed__ = cache_attr
        return wrapper
    return deco
