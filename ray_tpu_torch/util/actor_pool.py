"""ActorPool — load-balance tasks over a fixed set of actors.

Reference: ``python/ray/util/actor_pool.py`` (same public surface:
map/map_unordered/submit/get_next/get_next_unordered/has_next).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, TypeVar

from .. import get, wait

V = TypeVar("V")


class ActorPool:
    def __init__(self, actors: List[Any]):
        if not actors:
            raise ValueError("ActorPool needs at least one actor")
        self._idle = list(actors)
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0

    def map(self, fn: Callable[[Any, V], Any],
            values: Iterable[V]) -> Iterable[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, V], Any],
                      values: Iterable[V]) -> Iterable[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def submit(self, fn: Callable[[Any, V], Any], value: V) -> None:
        """fn(actor, value) -> ObjectRef; blocks if no actor is idle."""
        if not self._idle:
            # wait for any in-flight call to finish, then reuse its actor
            ready, _ = wait(list(self._future_to_actor), num_returns=1)
            self._reclaim(ready[0])
        actor = self._idle.pop()
        ref = fn(actor, value)
        self._future_to_actor[ref] = actor
        self._index_to_future[self._next_task_index] = ref
        self._next_task_index += 1

    def _reclaim(self, ref) -> None:
        actor = self._future_to_actor.pop(ref, None)
        if actor is not None:
            self._idle.append(actor)

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def get_next(self, timeout: float = None) -> Any:
        if not self.has_next():
            raise StopIteration("no pending results")
        idx = self._next_return_index
        ref = self._index_to_future[idx]
        if timeout is not None:
            # only consume the slot once the result is actually ready, so
            # a timeout leaves the pool state untouched and retryable
            ready, _ = wait([ref], num_returns=1, timeout=timeout)
            if not ready:
                raise TimeoutError(f"task {idx} not ready within {timeout}s")
        value = get(ref)
        del self._index_to_future[idx]
        self._next_return_index += 1
        self._reclaim(ref)
        return value

    def get_next_unordered(self, timeout: float = None) -> Any:
        if not self.has_next():
            raise StopIteration("no pending results")
        ready, _ = wait(list(self._index_to_future.values()), num_returns=1,
                        timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        for idx, fut in list(self._index_to_future.items()):
            if fut == ref:
                del self._index_to_future[idx]
                break
        value = get(ref)
        self._reclaim(ref)
        return value

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def push(self, actor) -> None:
        self._idle.append(actor)
