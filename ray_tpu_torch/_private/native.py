"""ctypes bindings for the native runtime (``csrc/object_arena.cpp``).

The shared library is built on demand with g++ into ``_build/`` beside the
CUDA kernels (pybind11 is not in the image, so the ABI is plain C via
ctypes). Everything degrades gracefully: if the toolchain or build is
unavailable, callers fall back to pure-Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

from . import locksan

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_ROOT, "csrc", "object_arena.cpp")
_BUILD_DIR = os.path.join(_PKG_ROOT, "_build")
_CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]

_lib = None
_lib_lock = locksan.lock("native.lib")
_build_failed = False


def _lib_path() -> str:
    """The library for this source and these flags (a changed source builds
    a new file; an old build is never loaded)."""
    h = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libobject_arena-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile the arena under an inter-process flock: many workers may race
    the first build; exactly one runs g++ (to a temporary name, renamed
    into place), the rest wait on the lock and find the library built."""
    import fcntl
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "object_arena.lock"), "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        if os.path.exists(path):
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run([shutil.which("g++") or "g++", *_CXXFLAGS,
                        "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            path = _lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
        lib.arena_create.restype = ctypes.c_void_p
        lib.arena_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.arena_attach.restype = ctypes.c_void_p
        lib.arena_attach.argtypes = [ctypes.c_char_p]
        lib.arena_alloc.restype = ctypes.c_int64
        lib.arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.arena_free.restype = ctypes.c_int
        lib.arena_free.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.arena_base.restype = ctypes.POINTER(ctypes.c_ubyte)
        lib.arena_base.argtypes = [ctypes.c_void_p]
        lib.arena_capacity.restype = ctypes.c_uint64
        lib.arena_capacity.argtypes = [ctypes.c_void_p]
        lib.arena_used.restype = ctypes.c_uint64
        lib.arena_used.argtypes = [ctypes.c_void_p]
        lib.arena_num_blocks.restype = ctypes.c_uint64
        lib.arena_num_blocks.argtypes = [ctypes.c_void_p]
        lib.arena_close.restype = None
        lib.arena_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        try:
            # mapper refcounts; absent in .so builds from older sources
            # (refcount callers degrade to the time quarantine)
            for sym in ("arena_incref", "arena_decref", "arena_refcount"):
                fn = getattr(lib, sym)
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        except AttributeError:
            pass
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class _RefcountMixin:
    """Per-block mapper refcounts, shared by owner and reader handles.
    All three degrade to None/no-op on a library built from an older
    source (no arena_incref symbol)."""

    def incref(self, offset: int) -> Optional[int]:
        fn = getattr(self._lib, "arena_incref", None)
        if fn is None or not self._handle:
            return None
        n = fn(self._handle, offset)
        return None if n < 0 else n

    def decref(self, offset: int) -> Optional[int]:
        fn = getattr(self._lib, "arena_decref", None)
        if fn is None or not self._handle:
            return None
        n = fn(self._handle, offset)
        return None if n < 0 else n

    def refcount(self, offset: int) -> Optional[int]:
        fn = getattr(self._lib, "arena_refcount", None)
        if fn is None or not self._handle:
            return None
        n = fn(self._handle, offset)
        return None if n < 0 else n


class Arena(_RefcountMixin):
    """Owner-side arena (the node store process allocates; readers use
    ``ArenaReader``)."""

    def __init__(self, path: str, capacity: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native arena unavailable")
        self._lib = lib
        self.path = path
        self._handle = lib.arena_create(path.encode(), capacity)
        if not self._handle:
            raise RuntimeError(f"arena_create failed for {path}")
        self.capacity = lib.arena_capacity(self._handle)

    def alloc(self, size: int) -> Optional[int]:
        off = self._lib.arena_alloc(self._handle, size)
        return None if off < 0 else off

    def free(self, offset: int) -> None:
        self._lib.arena_free(self._handle, offset)

    def view(self, offset: int, size: int) -> memoryview:
        base = self._lib.arena_base(self._handle)
        addr = ctypes.addressof(base.contents) + offset
        return (ctypes.c_ubyte * size).from_address(addr)

    def buffer(self, offset: int, size: int) -> memoryview:
        return memoryview(self.view(offset, size)).cast("B")

    @property
    def used(self) -> int:
        return self._lib.arena_used(self._handle)

    @property
    def num_blocks(self) -> int:
        return self._lib.arena_num_blocks(self._handle)

    def close(self, unlink: bool = True) -> None:
        if self._handle:
            self._lib.arena_close(self._handle, 1 if unlink else 0)
            self._handle = None


class ArenaReader(_RefcountMixin):
    """Reader-side attachment (one mmap per process per arena)."""

    _cache: dict = {}
    _cache_lock = locksan.lock("native.arena_cache")

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native arena unavailable")
        self._lib = lib
        self._handle = lib.arena_attach(path.encode())
        if not self._handle:
            raise RuntimeError(f"arena_attach failed for {path}")

    @classmethod
    def get(cls, path: str) -> "ArenaReader":
        with cls._cache_lock:
            reader = cls._cache.get(path)
            if reader is None:
                reader = cls(path)
                cls._cache[path] = reader
            return reader

    def buffer(self, offset: int, size: int) -> memoryview:
        base = self._lib.arena_base(self._handle)
        addr = ctypes.addressof(base.contents) + offset
        return memoryview((ctypes.c_ubyte * size).from_address(addr)) \
            .cast("B")

    def tracked_buffer(self, offset: int, size: int) -> memoryview:
        """Zero-copy view that holds a mapper reference on the block:
        increfs now, decrefs when the last derived view is collected
        (weakref.finalize on the backing ctypes array — every numpy
        view/memoryview slice keeps that array alive). The owner defers
        free/spill of the block while the count is nonzero, so user code
        can hold views indefinitely without a reuse-corruption window.
        Raises FileNotFoundError when the block was already freed (the
        meta was stale) — callers retry through a fresh GET exactly like
        a spilled-and-unlinked segment."""
        base = self._lib.arena_base(self._handle)
        addr = ctypes.addressof(base.contents) + offset
        arr = (ctypes.c_ubyte * size).from_address(addr)
        if getattr(self._lib, "arena_incref", None) is not None:
            if self.incref(offset) is None:
                raise FileNotFoundError(
                    f"arena block @{offset} already freed")
            import weakref
            weakref.finalize(arr, self.decref, offset)
        return memoryview(arr).cast("B")

    def close(self) -> None:
        if self._handle:
            self._lib.arena_close(self._handle, 0)
            self._handle = None
