"""``multiprocessing.Pool`` drop-in backed by cluster tasks.

Reference analogue: ``python/ray/util/multiprocessing/pool.py`` — the
same surface (``map``/``starmap``/``imap``/``imap_unordered``/
``apply``/``apply_async``/context manager) so existing Pool code runs
on the cluster by changing one import. Work is submitted as chunked
remote tasks; results stream back through the object store.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch
from .._private import serialization as _ser


@ray_tpu_torch.remote
def _run_chunk(fn_blob: bytes, chunk: list, star: bool) -> list:
    fn = _ser.loads_function(fn_blob)
    if star:
        return [fn(*args) for args in chunk]
    return [fn(x) for x in chunk]


@ray_tpu_torch.remote
def _run_call(fn_blob: bytes):
    return _ser.loads_function(fn_blob)()


class AsyncResult:
    """Matches ``multiprocessing.pool.AsyncResult``."""

    def __init__(self, refs: List, chunked: bool, callback=None,
                 error_callback=None, single: bool = False):
        self._refs = refs
        self._chunked = chunked
        self._single = single
        self._result: Optional[list] = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        t = threading.Thread(target=self._collect,
                             args=(callback, error_callback), daemon=True)
        t.start()

    def _collect(self, callback, error_callback) -> None:
        try:
            chunks = ray_tpu_torch.get(self._refs)
            if self._chunked:
                self._result = list(itertools.chain.from_iterable(chunks))
            elif self._single:
                self._result = chunks[0]    # apply(): one scalar result
            else:
                self._result = chunks
            if callback is not None:
                callback(self._result)
        except BaseException as e:  # noqa: BLE001 — delivered via get()
            self._error = e
            if error_callback is not None:
                error_callback(e)
        finally:
            self._done.set()

    def wait(self, timeout: Optional[float] = None) -> None:
        self._done.wait(timeout)

    def ready(self) -> bool:
        return self._done.is_set()

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        return self._error is None

    def get(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("result not ready within timeout")
        if self._error is not None:
            raise self._error
        return self._result


class Pool:
    """Task-backed process pool (reference: ``ray.util.multiprocessing``).

    ``processes`` bounds in-flight chunks, not real processes — workers
    come from the node's shared pool.
    """

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = ()):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._processes = processes or int(
            ray_tpu_torch.cluster_resources().get("CPU", 4))
        self._initializer = initializer
        self._initargs = initargs
        self._closed = False

    # -- helpers -------------------------------------------------------
    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)], chunksize

    def _wrap(self, fn):
        if self._initializer is None:
            return fn
        initializer, initargs = self._initializer, self._initargs
        # worker-local one-time init, keyed per process
        def wrapped(*a, **kw):
            import os
            flag = f"_rtpu_pool_init_{os.getpid()}"
            import builtins
            if not getattr(builtins, flag, False):
                initializer(*initargs)
                setattr(builtins, flag, True)
            return fn(*a, **kw)
        return wrapped

    def _check_open(self) -> None:
        if self._closed:
            raise ValueError("Pool not running")

    def _submit_chunks(self, fn, chunks: list, star: bool) -> list:
        # cloudpickle by value: a user callable from the driver's script
        # or test module is not importable inside workers
        blob = _ser.dumps_function(self._wrap(fn))
        return [_run_chunk.remote(blob, chunk, star) for chunk in chunks]

    # -- the multiprocessing.Pool surface ------------------------------
    def apply(self, fn, args: tuple = (), kwds: Optional[dict] = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn, args: tuple = (), kwds: Optional[dict] = None,
                    callback=None, error_callback=None) -> AsyncResult:
        self._check_open()
        kwds = kwds or {}
        wrapped = self._wrap(fn)
        blob = _ser.dumps_function(lambda: wrapped(*args, **kwds))
        ref = _run_call.remote(blob)
        return AsyncResult([ref], chunked=False, single=True,
                           callback=callback,
                           error_callback=error_callback)

    def map(self, fn, iterable: Iterable,
            chunksize: Optional[int] = None) -> list:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn, iterable: Iterable,
                  chunksize: Optional[int] = None, callback=None,
                  error_callback=None) -> AsyncResult:
        self._check_open()
        chunks, _ = self._chunks(iterable, chunksize)
        refs = self._submit_chunks(fn, chunks, star=False)
        return AsyncResult(refs, chunked=True, callback=callback,
                           error_callback=error_callback)

    def starmap(self, fn, iterable: Iterable,
                chunksize: Optional[int] = None) -> list:
        self._check_open()
        chunks, _ = self._chunks(iterable, chunksize)
        refs = self._submit_chunks(fn, chunks, star=True)
        return AsyncResult(refs, chunked=True).get()

    def starmap_async(self, fn, iterable: Iterable,
                      chunksize: Optional[int] = None, callback=None,
                      error_callback=None) -> AsyncResult:
        self._check_open()
        chunks, _ = self._chunks(iterable, chunksize)
        refs = self._submit_chunks(fn, chunks, star=True)
        return AsyncResult(refs, chunked=True, callback=callback,
                          error_callback=error_callback)

    def imap(self, fn, iterable: Iterable, chunksize: Optional[int] = None):
        """Ordered streaming results."""
        self._check_open()
        chunks, _ = self._chunks(iterable, chunksize)
        refs = self._submit_chunks(fn, chunks, star=False)
        for ref in refs:
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, fn, iterable: Iterable,
                       chunksize: Optional[int] = None):
        """Results in completion order (chunk granularity)."""
        self._check_open()
        chunks, _ = self._chunks(iterable, chunksize)
        refs = self._submit_chunks(fn, chunks, star=False)
        pending = list(refs)
        while pending:
            done, pending = ray_tpu_torch.wait(pending, num_returns=1)
            yield from ray_tpu_torch.get(done[0])

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()
