"""Streaming dataset shards for distributed ingest.

Counterpart of ``ray_tpu/data/iterator.py`` on the port's runtime and its
``util/queue.py``. ``DataIterator.iter_device_batches`` yields torch
tensors on a device (``_device.py``) where JAX's yields jax Arrays.

Reference analogue: ``python/ray/train/_internal/data_config.py`` +
``DataIterator`` (``python/ray/data/iterator.py``): a Dataset is split
into N live streams, one consumed by each training worker while the
read/transform pipeline keeps running on the cluster.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterator, List, Optional

from .. import get
from .block import Block, block_concat, block_num_rows, block_slice


class DataIterator:
    """One worker's shard of a streaming split: block refs arrive
    through a bounded queue (backpressure: the driver-side feeder stalls
    when consumers lag). Picklable — pass into remote workers."""

    def __init__(self, queue):
        self._queue = queue

    # ------------------------------------------------------------ blocks
    def iter_block_refs(self) -> Iterator[Any]:
        while True:
            item = self._queue.get(block=True, timeout=None)
            if item is None:
                # the stream's end: its queue actor goes with it (each
                # holds a worker process, and a node's worker cap counts
                # them: leftover queues starved later tasks of workers)
                self.shutdown()
                return
            if isinstance(item, tuple) and item[0] == "__stream_error__":
                # the pipeline died upstream: surface it instead of
                # hanging the consumer on a stream that will never end
                self.shutdown()
                raise RuntimeError(
                    f"dataset stream failed upstream: {item[1]}")
            # refs ride WRAPPED in a 1-list: a bare ObjectRef queue item
            # would be auto-resolved into its value at the actor call
            # boundary (nested refs pass through as borrowed refs)
            yield item[0]

    def shutdown(self) -> None:
        """Tear down this shard's queue actor (at the stream's end, and at
        trainer teardown between elastic restarts); the feeder thread
        exits on its next put."""
        try:
            self._queue.shutdown()
        except Exception:
            pass

    def iter_blocks(self) -> Iterator[Block]:
        for ref in self.iter_block_refs():
            yield get(ref)

    # ----------------------------------------------------------- batches
    def iter_batches(self, *, batch_size: int = 256,
                     drop_last: bool = False) -> Iterator[Block]:
        """Re-batch across block boundaries to exactly batch_size."""
        carry: Optional[Block] = None
        for blk in self.iter_blocks():
            if not blk:
                continue
            if carry:
                blk = block_concat([carry, blk])
                carry = None
            n = block_num_rows(blk)
            lo = 0
            while n - lo >= batch_size:
                yield block_slice(blk, lo, lo + batch_size)
                lo += batch_size
            if lo < n:
                carry = block_slice(blk, lo, n)
        if carry and not drop_last:
            yield carry

    def iter_device_batches(self, *, batch_size: int = 256,
                            device: Optional[Any] = None,
                            mesh: Optional[Any] = None,
                            dtype: Optional[Any] = None
                            ) -> Iterator[Dict[str, Any]]:
        """Batches as torch tensors on `device` (default: the current CUDA
        device; raises without CUDA), one batch prefetched; with a port
        ``Mesh``, this rank's rows of each batch (``act_batch``, as
        ``shard_batch`` cuts them); with `dtype`, every column cast to it.
        Partial final batches are dropped — a train step takes a fixed
        batch. See ``_device.device_batches``."""
        from ._device import device_batches
        return device_batches(
            self.iter_batches(batch_size=batch_size, drop_last=True),
            device=device, mesh=mesh, dtype=dtype)

    def __reduce__(self):
        return (DataIterator, (self._queue,))


def streaming_split(dataset, n: int, *,
                    queue_size: int = 4) -> List[DataIterator]:
    """Split a dataset into ``n`` concurrently-consumable streams.

    A driver-side feeder thread drives the dataset's streaming executor
    and deals block refs round-robin into n bounded queues; total
    cluster residency stays (operator windows + n*queue_size) blocks.
    Round-robin + bounded queues couple the shards' pace — which is what
    lockstep SPMD training wants (every rank steps together anyway).
    """
    from ..util.queue import Queue

    if n < 1:
        raise ValueError("streaming_split needs n >= 1")
    queues = [Queue(maxsize=queue_size) for _ in range(n)]

    def feed() -> None:
        end_item: Any = None
        try:
            for i, ref in enumerate(dataset.streaming_block_refs()):
                queues[i % n].put([ref], block=True, timeout=None)
        except Exception as e:  # noqa: BLE001 — delivered to consumers
            # the PIPELINE failed (bad file, missing optional dep, task
            # error): every consumer must see the error, not hang on a
            # stream that never ends
            end_item = ("__stream_error__", repr(e))
        from ..util.queue import Full
        # The sentinel MUST land: a consumer that is merely slow
        # (bounded queue full across a long train step) raises Full on
        # timeout — keep retrying. Round-robin over the still-pending
        # queues so one permanently-full queue (dead consumer, live
        # queue actor) can't starve the others of their sentinel. Drop
        # a queue only when its actor is gone (shutdown/teardown).
        pending = list(queues)
        while pending:
            still = []
            for q in pending:
                try:
                    q.put(end_item, block=True, timeout=2.0)
                except Full:
                    still.append(q)
                except Exception:
                    pass
            pending = still

    threading.Thread(target=feed, daemon=True,
                     name="rtpt-data-feeder").start()
    return [DataIterator(q) for q in queues]
