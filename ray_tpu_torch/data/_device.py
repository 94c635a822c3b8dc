"""Host batches -> torch tensors on a device, one batch ahead.

The port's counterpart of the ``jax.device_put`` in JAX's two device-batch
iterators (``ray_tpu/data/dataset.py:536-557`` and
``ray_tpu/data/iterator.py:77-96``); both iterators call `device_batches`.
On CUDA each batch goes:

1. each column into a pinned staging buffer of one of two buffer sets, one
   per batch in flight; a set is refilled only after the event of its last
   copy has passed, so a copy still in flight never sees its source change;
2. to the device with ``non_blocking=True`` on a side stream, which then
   records the set's event;
3. when the consumer takes the batch, its current stream waits on that
   event, and each tensor is ``record_stream``-ed for it, so the caching
   allocator does not hand the memory to the side stream while the
   consumer still reads it.

Batch i+1's copy starts before batch i is yielded, as JAX's
``Dataset.iter_device_batches`` transfers one batch ahead. A column is
always copied out of the host block, which may be a read-only view of a
shared-memory mapping that goes away with the block: no yielded tensor
aliases it. Columns keep numpy's dtype unless `dtype` is given (JAX
without x64 turns int64 and float64 into 32-bit types); a column of
strings or objects raises, as ``jnp.asarray`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..models.gpt import resolve_device
from ..parallel.sharding import DEFAULT_RULES, logical_sharding
from .block import Block

Batch = Dict[str, torch.Tensor]


def device_batches(host_batches: Iterator[Block], *, device: Any = None,
                   mesh: Any = None, dtype: Any = None) -> Iterator[Batch]:
    """`host_batches` as dicts of tensors on `device` (default: the current
    CUDA device; raises at once without CUDA, never falls back to the
    CPU). With a port ``Mesh``, each batch is this rank's rows of it: the
    rows ``shard_batch`` gives the rank (``act_batch`` over dp x fsdp),
    those of its addressable shard in JAX. `dtype` (a torch or numpy
    dtype) casts every column on the device."""
    device = resolve_device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    dtype = _torch_dtype(dtype)
    if device.type == "cuda":
        return _cuda_batches(host_batches, device, mesh, dtype)
    return ({k: _cast(torch.from_numpy(np.array(v)).to(device), dtype)
             for k, v in _columns(batch, mesh).items()}
            for batch in host_batches)


def _cuda_batches(host_batches: Iterator[Block], device: torch.device,
                  mesh: Any, dtype: Optional[torch.dtype]) -> Iterator[Batch]:
    stream = torch.cuda.Stream(device)
    slots = (_Staging(), _Staging())
    pending = None
    for i, batch in enumerate(host_batches):
        nxt = slots[i % 2].load(_columns(batch, mesh), device, stream, dtype)
        if pending is not None:
            yield _take(*pending, device)
        pending = nxt
    if pending is not None:
        yield _take(*pending, device)


class _Staging:
    """One batch's pinned buffers (kept across batches of one shape) and
    the event of their last copy to the device."""

    def __init__(self):
        self.buffers: Dict[str, torch.Tensor] = {}
        self.event = torch.cuda.Event()

    def load(self, columns: Block, device: torch.device,
             stream: torch.cuda.Stream, dtype: Optional[torch.dtype]):
        self.event.synchronize()      # the last copy has left the buffers
        out = {}
        with torch.cuda.stream(stream):
            for k, v in columns.items():
                host_dtype = _torch_dtype(v.dtype)
                buf = self.buffers.get(k)
                if (buf is None or tuple(buf.shape) != v.shape
                        or buf.dtype != host_dtype):
                    buf = self.buffers[k] = torch.empty(
                        v.shape, dtype=host_dtype, pin_memory=True)
                np.copyto(buf.numpy(), v)
                out[k] = _cast(buf.to(device, non_blocking=True), dtype)
            self.event.record(stream)
        return out, self.event


def _take(batch: Batch, event: torch.cuda.Event,
          device: torch.device) -> Batch:
    consumer = torch.cuda.current_stream(device)
    consumer.wait_event(event)
    for t in batch.values():
        t.record_stream(consumer)
    return batch


def _columns(batch: Block, mesh: Any) -> Block:
    """The batch's columns as numpy arrays, this rank's rows of each on a
    mesh; refuses columns that are not numbers or bools."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.dtype.kind not in "biufc":
            raise TypeError(f"column {k!r} of dtype {v.dtype} cannot go to "
                            "a device: only numbers and bools can")
        if not v.dtype.isnative:     # torch takes the host's byte order only
            v = v.astype(v.dtype.newbyteorder("="))
        if mesh is not None:
            v = v[logical_sharding(mesh, DEFAULT_RULES, ("act_batch",),
                                   (len(v),))[0]]
        out[k] = v
    return out


def _torch_dtype(dtype: Any) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _cast(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if dtype is None else t.to(dtype)
