"""Distributed FIFO queue backed by an actor.

Reference: ``python/ray/util/queue.py`` (Queue with put/get/
put_nowait/get_nowait/qsize/empty/full, Empty/Full exceptions).
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

from ..api import remote


class Empty(Exception):
    pass


class Full(Exception):
    pass


@remote(num_cpus=0)
class _QueueActor:
    def __init__(self, maxsize: int):
        from collections import deque
        self._maxsize = maxsize
        self._q = deque()

    def qsize(self) -> int:
        return len(self._q)

    def put(self, item) -> bool:
        if self._maxsize > 0 and len(self._q) >= self._maxsize:
            return False
        self._q.append(item)
        return True

    def get(self):
        if not self._q:
            return False, None
        return True, self._q.popleft()

    def put_batch(self, items) -> bool:
        if self._maxsize > 0 and len(self._q) + len(items) > self._maxsize:
            return False
        self._q.extend(items)
        return True

    def get_batch(self, n: int):
        """All-or-nothing: never dequeues unless n items are available."""
        if len(self._q) < n:
            return None
        return [self._q.popleft() for _ in range(n)]


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = actor_options or {}
        self.maxsize = maxsize
        self.actor = _QueueActor.options(**opts).remote(maxsize)

    def __reduce__(self):
        return (_rebuild_queue, (self.maxsize, self.actor))

    def qsize(self) -> int:
        from .. import get
        return get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        from .. import get
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if get(self.actor.put.remote(item)):
                return
            if not block:
                raise Full
            if deadline is not None and time.monotonic() >= deadline:
                raise Full
            time.sleep(0.01)

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        from .. import get as rget
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = rget(self.actor.get.remote())
            if ok:
                return item
            if not block:
                raise Empty
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty
            time.sleep(0.01)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        from .. import get
        if not get(self.actor.put_batch.remote(list(items))):
            raise Full

    def get_nowait_batch(self, n: int) -> List[Any]:
        from .. import get
        items = get(self.actor.get_batch.remote(n))
        if items is None:
            raise Empty(f"queue has fewer than {n} items")
        return items

    def shutdown(self) -> None:
        from .. import kill
        kill(self.actor)


def _rebuild_queue(maxsize, actor):
    q = Queue.__new__(Queue)
    q.maxsize = maxsize
    q.actor = actor
    return q
