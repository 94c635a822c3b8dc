"""Zero-copy serialization for task args, returns and stored objects.

Equivalent role to the reference's serialization layer
(``python/ray/_private/serialization.py`` + cloudpickle + plasma buffer
protocol): we use pickle protocol 5 with out-of-band buffers so that numpy
arrays round-trip without copies when the destination is a shared-memory
segment, and cloudpickle (``pickle`` fallback) for closures/lambdas.

Torch tensors go out of band too, as one buffer of their bytes (so bf16,
which numpy lacks, travels as raw bytes); the meta keeps only dtype, shape,
``requires_grad`` and device. A CUDA tensor is stored as its host bytes
(one copy from the device) and restored on the receiver's current CUDA
device; a receiver that sees no card raises ``TensorDeviceError``. A
restored tensor owns a copy of its bytes, so writing to it never changes
the stored object. This module never imports torch: it handles tensors
only once the process has imported torch itself.

Wire format of a serialized object:

    [8B total_len][8B meta_len][meta pickle][buf0][buf1]...

where ``meta`` is ``(payload_pickle_bytes, [buf_len, ...])`` and the
payload pickle references the buffers out-of-band (PickleBuffer).
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import sys
from typing import Any, List, Tuple

try:
    import cloudpickle as _function_pickler
except ImportError:  # the GPU image ships without it
    import pickle as _function_pickler

_HEADER = struct.Struct("<QQ")


class TensorDeviceError(RuntimeError):
    """A stored CUDA tensor reached a process that sees no CUDA device."""


def _main_without_cloudpickle(obj) -> pickle.PicklingError:
    return pickle.PicklingError(
        f"{obj!r} is defined in __main__, which a worker process cannot "
        "import, and cloudpickle (which would send it by value) is not "
        "installed: define it in a module the workers can import")


class _MainDetectingPickler(pickle.Pickler):
    """C-speed pickler that flags global references into ``__main__``
    (classes/functions pickled by reference that a worker process could
    never import), and sends torch tensors out of band."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        torch = sys.modules.get("torch")
        self._tensor = getattr(torch, "Tensor", None)
        self.main_ref = None

    def reducer_override(self, obj):
        if self._tensor is not None and isinstance(obj, self._tensor):
            return _reduce_tensor(obj)
        if getattr(obj, "__module__", None) == "__main__":
            # abort THIS dump immediately — finishing it just to throw
            # the result away would pay the full pickle twice
            self.main_ref = obj
            raise pickle.PicklingError("__main__ reference")
        return NotImplemented        # standard reduction continues


def _reduce_tensor(t):
    """A dense CPU or CUDA tensor as one out-of-band buffer of its bytes;
    anything else (sparse, quantized, subclasses) pickles as torch does."""
    torch = sys.modules["torch"]
    if (type(t) not in (torch.Tensor, torch.nn.Parameter)
            or t.layout != torch.strided or t.is_quantized
            or t.device.type not in ("cpu", "cuda")):
        return NotImplemented
    data = t.detach().resolve_conj().resolve_neg()
    if data.device.type == "cuda":
        data = data.cpu()
    raw = data.contiguous().reshape(-1).view(torch.uint8).numpy()
    return _restore_tensor, (
        pickle.PickleBuffer(raw), str(t.dtype).removeprefix("torch."),
        tuple(t.shape), t.requires_grad, str(t.device),
        isinstance(t, torch.nn.Parameter))


def _restore_tensor(buf, dtype: str, shape: tuple, requires_grad: bool,
                    device: str, parameter: bool):
    import numpy as np
    import torch
    t = torch.empty(shape, dtype=getattr(torch, dtype))
    t.reshape(-1).view(torch.uint8).numpy()[:] = np.frombuffer(buf, np.uint8)
    if device != "cpu":
        if not torch.cuda.is_available():
            raise TensorDeviceError(
                f"the object holds a tensor from {device}, and this process "
                "sees no CUDA device (CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}); ask for the "
                "card with num_gpus=, or move the tensor to the CPU before "
                "put")
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad)


def dumps_function(fn) -> bytes:
    """Pickle a function/class including closures (cloudpickle)."""
    if (_function_pickler is pickle
            and getattr(fn, "__module__", None) == "__main__"):
        raise _main_without_cloudpickle(fn)
    return _function_pickler.dumps(fn)


def loads_function(data: bytes):
    return pickle.loads(data)


def serialize(obj: Any) -> Tuple[bytes, List[memoryview]]:
    """Serialize to (meta_bytes, out_of_band_buffers).

    Buffers are memoryviews into the original object's storage — the caller
    writes them into shm (or the socket) without an intermediate copy.

    Plain pickle is the fast path, but it "succeeds" on
    ``__main__``-defined classes/functions by pickling them BY REFERENCE,
    which then fails to resolve in a worker whose ``__main__`` is the
    worker module. A reducer_override hook detects actual global
    references into ``__main__`` (no false positives on data that merely
    CONTAINS the string) and redoes those — and anything plain pickle
    rejects outright — with cloudpickle, which pickles by value.
    """
    buffers: List[pickle.PickleBuffer] = []
    f = io.BytesIO()
    pickler = _MainDetectingPickler(f, protocol=5,
                                    buffer_callback=buffers.append)
    try:
        pickler.dump(obj)
        payload = f.getvalue()
    except (pickle.PicklingError, AttributeError, TypeError):
        if pickler.main_ref is not None and _function_pickler is pickle:
            raise _main_without_cloudpickle(pickler.main_ref) from None
        buffers = []
        payload = _function_pickler.dumps(obj, protocol=5,
                                          buffer_callback=buffers.append)
    views = [b.raw() for b in buffers]
    meta = pickle.dumps((payload, [len(v) for v in views]), protocol=5)
    return meta, views


def serialized_size(meta: bytes, views: List[memoryview]) -> int:
    return _HEADER.size + len(meta) + sum(len(v) for v in views)


def write_to(buf: memoryview, meta: bytes, views: List[memoryview]) -> int:
    """Write the full wire format into ``buf``; returns bytes written."""
    total = serialized_size(meta, views)
    _HEADER.pack_into(buf, 0, total, len(meta))
    off = _HEADER.size
    buf[off:off + len(meta)] = meta
    off += len(meta)
    for v in views:
        n = len(v)
        buf[off:off + n] = v.cast("B") if v.format != "B" or v.ndim != 1 else v
        off += n
    return total


def write_file(f, meta: bytes, views: List[memoryview]) -> int:
    """Stream the wire format to a file object without assembling a
    contiguous buffer first (used to spill a lazy object straight from
    the owner's heap to disk); returns bytes written."""
    total = serialized_size(meta, views)
    f.write(_HEADER.pack(total, len(meta)))
    f.write(meta)
    for v in views:
        f.write(v.cast("B") if v.format != "B" or v.ndim != 1 else v)
    return total


def to_bytes(obj: Any) -> bytes:
    """One-shot serialize into a contiguous bytes object."""
    meta, views = serialize(obj)
    out = bytearray(serialized_size(meta, views))
    write_to(memoryview(out), meta, views)
    return bytes(out)


def read_from(buf: memoryview) -> Any:
    """Deserialize from the wire format. Buffers are zero-copy views into
    ``buf`` — keep the backing storage alive while the object is in use
    (numpy arrays returned from shm keep a reference via the memoryview)."""
    total, meta_len = _HEADER.unpack_from(buf, 0)
    off = _HEADER.size
    meta = bytes(buf[off:off + meta_len])
    off += meta_len
    payload, buf_lens = pickle.loads(meta)
    oob = []
    for n in buf_lens:
        oob.append(buf[off:off + n])
        off += n
    return pickle.loads(payload, buffers=oob)


def from_bytes(data: bytes) -> Any:
    return read_from(memoryview(data))
