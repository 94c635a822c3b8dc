"""Guarded-by field sanitizer: runtime checking of declared data ownership.

The successor layer to ``locksan``: locksan declares every *lock* and
checks acquisition order; this module declares what **data** each lock
protects (``locksan.FIELDS`` — the single Python source of truth behind
DESIGN.md's "Shared-state ownership map", cross-checked both directions
by ``scripts/check_concurrency.py`` rule (h)) and checks, at runtime,
that threads actually follow those declarations. Reference analogue:
Clang ``GUARDED_BY`` thread-safety annotations on ``absl::Mutex``-held
members throughout the C++ core (``src/ray/common/``) — a Python
runtime gets the equivalent from this module (dynamic) plus the AST
pass (static).

Three guard classes, by ``FIELDS`` value:

- ``"<lock name>"`` (a ``locksan.REGISTRY`` row): the field is guarded
  by that lock. Accesses through the instrumentation record
  ``(thread, read|write, guard-held?)``; a cross-thread **read-write or
  write-write pair whose write side did not hold the guard** is
  reported with both sides' stacks. Unguarded *reads* beside guarded
  writes stay silent — single reads are GIL-atomic and several hot
  paths deliberately probe lock-free (e.g. ``gcs.sweep_ref_zeros``);
  the race class that corrupts state in Python is the unguarded
  *write*, and that is what trips the report. For throughput, guarded
  reads are noted 1-in-8 and a *clean* guarded write whose record
  already exists short-cuts to an O(1) held-name probe (the
  ``fieldsan_ab`` gate pins the instrumented path < 1.25x) — an
  UNGUARDED access never takes a short-cut.
- ``"thread:<pat>"``: single-thread-confined — only threads whose name
  contains ``<pat>`` may WRITE (e.g. ``thread:rtpu-dispatch`` for the
  node dispatcher's scheduling state). Reads from other threads are
  tolerated dirty reads by design (the sampler reading queue lengths).
  A write from a foreign thread is reported immediately.
- ``"<lock name>|static"``: guarded by that lock and fully verified by
  the STATIC rule-(h) pass, but exempt from runtime instrumentation —
  the documented hot-path form (per-message transport innards, metric
  shards, per-submission client buffers) where a per-access hook costs
  more than the residual risk of the small audited module it guards.
- ``"atomic:<reason>"``: deliberately lock-free shared state relying on
  GIL-atomic single operations (a counters dict, a write-once flag, an
  idempotent cache fill). Declared so the rule-(h) inference pass can't
  flag it as an *undeclared* shared field; not instrumented.

With ``RTPU_FIELDSAN`` unset/0 everything here is inert: ``guarded``
returns the class unchanged and ``instrument_module`` is a no-op, so a
declaration costs nothing (bench_telemetry's ``fieldsan_ab`` gate pins
the off path at parity). With ``RTPU_FIELDSAN=1`` (tier-1 sets this in
conftest beside RTPU_LOCKSAN) declared instance fields become data
descriptors and declared containers are wrapped in mutation-checking
proxy subclasses (dict/list/set/deque/OrderedDict), so plain attribute
code keeps working unchanged.

Violations go to ``violations()`` and stderr
(``RTPU_FIELDSAN_MODE=log``, the default) or raise
``FieldRaceViolation`` **before the write applies** in ``raise`` mode
(``RTPU_FIELDSAN_MODE=raise`` / ``set_mode("raise")``) — the seeded
two-thread race test demonstrates the access being refused with both
threads surviving. Stack capture on clean (guard-held) accesses is
sampled 1-in-``RTPU_FIELDSAN_SAMPLE`` (default 16) to keep the
instrumented hot path inside the fieldsan_ab budget; unguarded accesses
— the interesting side of any pair — always capture.
"""

from __future__ import annotations

import sys
import threading
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from . import locksan
from .config import CONFIG

__all__ = [
    "guarded", "instrument_module", "enabled", "set_mode", "violations",
    "clear_violations", "FieldRaceViolation", "construction",
]

# read once at import: descriptors install at class-creation time, so
# these are environment knobs (RTPU_FIELDSAN / RTPU_FIELDSAN_MODE /
# RTPU_FIELDSAN_SAMPLE via the CONFIG table), not live toggles
_ENABLED = bool(CONFIG.fieldsan)
_MODE = str(CONFIG.fieldsan_mode)
_SAMPLE = max(1, int(CONFIG.fieldsan_sample))

_LOCK, _THREAD, _ATOMIC = 0, 1, 2

_tls = threading.local()

# (owner id, attr) -> (thread id, kind, guard_held, ctx). Plain dict
# with GIL-atomic single ops — this IS the sanitizer, it can't take
# runtime locks. Thread NAMES are resolved only at report time (a
# current_thread() per access was a third of the instrumented-path
# cost). Capped: pathological object churn clears the pairing table
# rather than growing it (one lost pairing window).
_last: Dict[tuple, tuple] = {}
_LAST_CAP = 200_000

_violations: List[dict] = []
_reported: set = set()
_sample_tick = 0
# guarded READS are noted 1-in-N (writes always): a read only matters
# as the pairing partner of an unguarded write, and persistent access
# patterns survive sampling; the refusal semantics live on writes
_read_tick = 0
_READ_SAMPLE = 8


class FieldRaceViolation(RuntimeError):
    """Raised at the access site in ``raise`` mode, BEFORE a write
    applies (the access is refused; both threads survive)."""


def enabled() -> bool:
    return _ENABLED


def set_mode(mode: str) -> str:
    """``log`` (default) or ``raise``; returns the previous mode."""
    global _MODE
    prev, _MODE = _MODE, mode
    return prev


def violations() -> List[dict]:
    return list(_violations)


def clear_violations() -> None:
    _violations.clear()
    _reported.clear()
    _last.clear()


def _init_ids() -> set:
    ids = getattr(_tls, "init_ids", None)
    if ids is None:
        ids = _tls.init_ids = set()
    return ids


class construction:
    """Mark ``obj`` as still under single-threaded construction on this
    thread: accesses to its declared fields are exempt (happens-before
    via the eventual publication). ``guarded`` wraps ``__init__`` in
    this automatically; use it explicitly for post-``__init__`` setup
    that still runs before the object is shared (``NodeService.start``
    hands scheduling state to its freshly-spawned threads)."""

    __slots__ = ("_id", "_mine")

    def __init__(self, obj: Any):
        self._id = id(obj)

    def __enter__(self):
        ids = _init_ids()
        self._mine = self._id not in ids
        if self._mine:
            ids.add(self._id)
        return self

    def __exit__(self, *exc):
        if self._mine:
            _init_ids().discard(self._id)
        return False


def _ctx_capture(skip: int = 2, limit: int = 10) -> tuple:
    """Compact stack: (file, line, func) triples, cheapest to capture
    (no formatting, no frame retention — a retained frame would pin its
    locals for the record's lifetime)."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return ()
    out = []
    while f is not None and len(out) < limit:
        co = f.f_code
        if not co.co_filename.endswith("fieldsan.py"):
            out.append((co.co_filename, f.f_lineno, co.co_name))
        f = f.f_back
    return tuple(out)


def _fmt_ctx(ctx: Optional[tuple]) -> str:
    if not ctx:
        return "  (stack not sampled)"
    return "\n".join(f"  {fn}:{ln} in {name}" for fn, ln, name in ctx)


def _report(kind: str, field: str, message: str,
            cur_ctx: tuple, other_ctx: Optional[tuple],
            other_thread: Optional[str]) -> None:
    site = cur_ctx[0] if cur_ctx else None
    rec = {"kind": kind, "field": field, "message": message,
           "thread": threading.current_thread().name,
           "other_thread": other_thread,
           "stack": cur_ctx, "other_stack": other_ctx}
    _violations.append(rec)
    dedup = (kind, field, site)
    if dedup not in _reported:
        _reported.add(dedup)
        other = ("" if other_ctx is None and other_thread is None else
                 f"--- other side (thread {other_thread}) ---\n"
                 f"{_fmt_ctx(other_ctx)}\n")
        print(f"[fieldsan] {kind}: {message} "
              f"(thread {rec['thread']})\n{_fmt_ctx(cur_ctx)}\n{other}",
              file=sys.stderr)
    if _MODE == "raise":
        raise FieldRaceViolation(f"{kind}: {message}")


class _Guard:
    """Parsed FIELDS value."""

    __slots__ = ("kind", "name", "field")

    def __init__(self, field: str, spec: str):
        self.field = field
        if spec.startswith("thread:"):
            self.kind = _THREAD
            self.name = spec[len("thread:"):]
        elif spec.startswith("atomic:"):
            self.kind = _ATOMIC
            self.name = spec[len("atomic:"):]
        elif spec.endswith("|static"):
            # statically verified only (rule (h) checks every lexical
            # write): the documented hot-path exemption for per-message
            # transport/metric-shard innards, where a per-access
            # descriptor hook costs more than the residual risk of the
            # small, audited module it guards
            self.kind = _ATOMIC
            self.name = spec[:-len("|static")]
        else:
            self.kind = _LOCK
            self.name = spec


def _thread_name(tid: Optional[int]) -> str:
    """Best-effort id -> name, resolved only at report time."""
    if tid is None:
        return "?"
    th = threading._active.get(tid)       # noqa: SLF001 — report path
    return th.name if th is not None else f"tid:{tid}"


_lk_tls = locksan._tls


def _note(guard: _Guard, key: tuple, kind: str) -> bool:
    """One access to a declared field. May raise in ``raise`` mode —
    callers invoke it BEFORE applying a write. Returns True when the
    access was clean AND guard-held/owner-matched (callers may memoize
    a clean verdict behind their own held-name probe)."""
    global _sample_tick
    if guard.kind == _THREAD:
        if kind != "w":
            # write confinement only; reads (sampled through the
            # container proxies) are tolerated dirty reads
            return True
        # Per-thread memo of the name match: current_thread() per write
        # was measurable on the dispatcher's inner loop
        memo = getattr(_tls, "owner_ok", None)
        if memo is None:
            memo = _tls.owner_ok = {}
        ok = memo.get(guard.name)
        if ok is None:
            ok = memo[guard.name] = (
                guard.name in threading.current_thread().name)
        if not ok:
            ctx = _ctx_capture()
            _report("confined-write",
                    guard.field,
                    f"write to {guard.field!r} from thread "
                    f"{threading.current_thread().name!r} — declared "
                    f"{guard.name!r}-confined",
                    ctx, None, None)
        return ok
    names = getattr(_lk_tls, "held_names", None)
    ok = names is not None and guard.name in names
    rec = _last.get(key)
    if (rec is not None and ok and rec[1] == kind and rec[2]):
        # CLEAN access repeating the stored clean shape (any thread):
        # the record already carries everything a future unguarded
        # access needs to pair against — skip the re-record. This is
        # the hot-path common case, and under the n_n bench's
        # 8-driver-thread contention it is what keeps clean traffic
        # O(1) allocation-free. (Unguarded accesses never short-cut.)
        return ok
    tid = threading.get_ident()
    _sample_tick += 1
    ctx = (_ctx_capture() if (not ok or _sample_tick % _SAMPLE == 0)
           else None)
    if (rec is not None and rec[0] != tid
            and (kind == "w" or rec[1] == "w")
            and ((kind == "w" and not ok) or (rec[1] == "w" and not rec[2]))):
        what = ("write-write" if kind == "w" and rec[1] == "w"
                else "read-write")
        other_name = _thread_name(rec[0])
        side = "this write" if (kind == "w" and not ok) else \
            f"the {('write' if rec[1] == 'w' else 'read')} on " \
            f"thread {other_name!r}"
        if ctx is None:
            ctx = _ctx_capture()
        # raise mode propagates from _report BEFORE the record below:
        # a REFUSED write never applied, so it must not become the
        # "last access" later readers pair against
        _report("race", guard.field,
                f"{what} race on {guard.field!r}: accessed by two "
                f"threads with {side} not holding declared guard "
                f"{guard.name!r}",
                ctx, rec[3], other_name)
        _last[key] = (tid, kind, ok, ctx)
        return False
    if len(_last) > _LAST_CAP:
        _last.clear()
    _last[key] = (tid, kind, ok, ctx)
    return ok


# ------------------------------------------------------------- proxies
#
# Container subclasses that route mutations (and, for module-level
# fields, the common reads) through ``_note``. They pickle/copy as the
# PLAIN base type (a proxy must never cross a process boundary), and
# ``dict.copy()``-style methods already return base types in CPython.

def _in_init(owner_id: int) -> bool:
    """Is ``owner_id`` inside THIS thread's construction window? A
    purely thread-local probe — construction exemptions never cross
    threads, so there is no shared counter (a shared fast-path counter
    was a lost-update race under concurrent constructions)."""
    ids = getattr(_tls, "init_ids", None)
    return ids is not None and owner_id in ids


def _p_note(proxy, kind: str) -> None:
    spec = proxy._fs_spec
    if spec is None:
        return
    guard, key = spec
    if kind == "w":
        # clean-verdict memo — the hot-path fast exit that holds the
        # instrumented path inside the fieldsan_ab budget. Thread-
        # confined: the owning thread's verdict never changes, memo is
        # its id. Lock-guarded: once ONE clean write is recorded in
        # _last (memo=True), a further write while the guard is HELD
        # adds no pairing information — the only accesses that matter
        # are unguarded ones, and they fail the held probe and take
        # the full path.
        memo = proxy._fs_memo
        if memo is not None:
            if guard.kind == _THREAD:
                if memo == threading.get_ident():
                    return
            else:
                names = getattr(_lk_tls, "held_names", None)
                if names is not None and guard.name in names:
                    return
    if _in_init(key[0]):
        return
    ok = _note(guard, key, kind)
    if ok and kind == "w":
        proxy._fs_memo = (threading.get_ident()
                          if guard.kind == _THREAD else True)


def _p_note_r(proxy) -> None:
    """Sampled read note for proxy read methods (1-in-_READ_SAMPLE)."""
    global _read_tick
    _read_tick += 1
    if _read_tick % _READ_SAMPLE:
        return
    spec = proxy._fs_spec
    if spec is None or _in_init(spec[1][0]):
        return
    _note(spec[0], spec[1], "r")


class _GDict(dict):
    __slots__ = ("_fs_spec", "_fs_memo")

    def __reduce_ex__(self, protocol):
        return (dict, (dict(self),))

    def __setitem__(self, k, v):
        _p_note(self, "w")
        dict.__setitem__(self, k, v)

    def __delitem__(self, k):
        _p_note(self, "w")
        dict.__delitem__(self, k)

    def __getitem__(self, k):
        _p_note_r(self)
        return dict.__getitem__(self, k)

    def get(self, k, default=None):
        _p_note_r(self)
        return dict.get(self, k, default)

    def pop(self, *a):
        _p_note(self, "w")
        return dict.pop(self, *a)

    def popitem(self):
        _p_note(self, "w")
        return dict.popitem(self)

    def clear(self):
        _p_note(self, "w")
        dict.clear(self)

    def update(self, *a, **k):
        _p_note(self, "w")
        dict.update(self, *a, **k)

    def setdefault(self, k, default=None):
        _p_note(self, "w")
        return dict.setdefault(self, k, default)


class _GODict(OrderedDict):
    __slots__ = ("_fs_spec", "_fs_memo")

    def __reduce_ex__(self, protocol):
        return (OrderedDict, (list(self.items()),))

    def __setitem__(self, k, v):
        _p_note(self, "w")
        OrderedDict.__setitem__(self, k, v)

    def __delitem__(self, k):
        _p_note(self, "w")
        OrderedDict.__delitem__(self, k)

    def pop(self, *a):
        _p_note(self, "w")
        return OrderedDict.pop(self, *a)

    def popitem(self, last=True):
        _p_note(self, "w")
        return OrderedDict.popitem(self, last)

    def clear(self):
        _p_note(self, "w")
        OrderedDict.clear(self)

    def update(self, *a, **k):
        _p_note(self, "w")
        OrderedDict.update(self, *a, **k)

    def setdefault(self, k, default=None):
        _p_note(self, "w")
        return OrderedDict.setdefault(self, k, default)

    def move_to_end(self, k, last=True):
        _p_note(self, "w")
        OrderedDict.move_to_end(self, k, last)


class _GList(list):
    __slots__ = ("_fs_spec", "_fs_memo")

    def __reduce_ex__(self, protocol):
        return (list, (list(self),))

    def __setitem__(self, i, v):
        _p_note(self, "w")
        list.__setitem__(self, i, v)

    def __delitem__(self, i):
        _p_note(self, "w")
        list.__delitem__(self, i)

    def __iadd__(self, other):
        _p_note(self, "w")
        list.extend(self, other)
        return self

    def append(self, v):
        _p_note(self, "w")
        list.append(self, v)

    def extend(self, it):
        _p_note(self, "w")
        list.extend(self, it)

    def insert(self, i, v):
        _p_note(self, "w")
        list.insert(self, i, v)

    def remove(self, v):
        _p_note(self, "w")
        list.remove(self, v)

    def pop(self, *a):
        _p_note(self, "w")
        return list.pop(self, *a)

    def clear(self):
        _p_note(self, "w")
        list.clear(self)

    def sort(self, **k):
        _p_note(self, "w")
        list.sort(self, **k)

    def reverse(self):
        _p_note(self, "w")
        list.reverse(self)


class _GSet(set):
    __slots__ = ("_fs_spec", "_fs_memo")

    def __reduce_ex__(self, protocol):
        return (set, (set(self),))

    def add(self, v):
        _p_note(self, "w")
        set.add(self, v)

    def discard(self, v):
        _p_note(self, "w")
        set.discard(self, v)

    def remove(self, v):
        _p_note(self, "w")
        set.remove(self, v)

    def pop(self):
        _p_note(self, "w")
        return set.pop(self)

    def clear(self):
        _p_note(self, "w")
        set.clear(self)

    def update(self, *a):
        _p_note(self, "w")
        set.update(self, *a)

    def difference_update(self, *a):
        _p_note(self, "w")
        set.difference_update(self, *a)


class _GDeque(deque):
    # deque disallows __slots__ with nonzero instance size on some
    # builds; plain class attribute slots keep it simple
    _fs_spec: Any = None
    _fs_memo: Any = None

    def __reduce_ex__(self, protocol):
        return (deque, (list(self), self.maxlen))

    def __setitem__(self, i, v):
        _p_note(self, "w")
        deque.__setitem__(self, i, v)

    def __delitem__(self, i):
        _p_note(self, "w")
        deque.__delitem__(self, i)

    def append(self, v):
        _p_note(self, "w")
        deque.append(self, v)

    def appendleft(self, v):
        _p_note(self, "w")
        deque.appendleft(self, v)

    def extend(self, it):
        _p_note(self, "w")
        deque.extend(self, it)

    def extendleft(self, it):
        _p_note(self, "w")
        deque.extendleft(self, it)

    def pop(self):
        _p_note(self, "w")
        return deque.pop(self)

    def popleft(self):
        _p_note(self, "w")
        return deque.popleft(self)

    def remove(self, v):
        _p_note(self, "w")
        deque.remove(self, v)

    def clear(self):
        _p_note(self, "w")
        deque.clear(self)

    def rotate(self, n=1):
        _p_note(self, "w")
        deque.rotate(self, n)


# exact-type wrapping only: subclasses (defaultdict, user types) keep
# their behavior and stay uninstrumented beyond the binding itself
_WRAP: Dict[type, type] = {dict: _GDict, OrderedDict: _GODict,
                           list: _GList, set: _GSet, deque: _GDeque}
_PROXIES = (_GDict, _GODict, _GList, _GSet, _GDeque)


def _wrap(value: Any, guard: _Guard, key: tuple) -> Any:
    if isinstance(value, _PROXIES):
        return value
    cls = _WRAP.get(type(value))
    if cls is None:
        return value
    if cls is _GDeque:
        out = (_GDeque(value, value.maxlen) if value.maxlen is not None
               else _GDeque(value))
    elif cls is _GODict:
        out = _GODict(value.items())
    else:
        out = cls(value)
    out._fs_spec = (guard, key)
    out._fs_memo = None
    return out


# ---------------------------------------------------------- descriptor

class _GuardedField:
    """Data descriptor over a declared instance field. Values live in
    the instance ``__dict__`` under the plain attribute name (or the
    wrapped ``__slots__`` descriptor), so pickling / ``vars()`` /
    dataclass-style code see ordinary state."""

    __slots__ = ("attr", "guard", "inner", "memo_key")

    def __init__(self, attr: str, guard: _Guard, inner: Any = None):
        self.attr = attr
        self.guard = guard
        self.inner = inner
        self.memo_key = "_fs_memo#" + attr

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        if self.inner is not None:
            val = self.inner.__get__(obj, objtype)
        else:
            try:
                val = obj.__dict__[self.attr]
            except KeyError:
                raise AttributeError(self.attr) from None
        if self.guard.kind == _LOCK:
            global _read_tick
            _read_tick += 1
            if not _read_tick % _READ_SAMPLE and not _in_init(id(obj)):
                _note(self.guard, (id(obj), self.attr), "r")
        return val

    def __set__(self, obj, value):
        key = (id(obj), self.attr)
        if self.inner is None and obj.__dict__.get(self.memo_key):
            # clean-verdict memo (see _p_note): once a clean write is
            # recorded, a guarded rebind adds no pairing information
            names = getattr(_lk_tls, "held_names", None)
            if names is not None and self.guard.name in names:
                obj.__dict__[self.attr] = _wrap(value, self.guard, key)
                return
        if not _in_init(key[0]):
            ok = _note(self.guard, key, "w")   # raise mode refuses here
            if ok and self.inner is None:
                obj.__dict__[self.memo_key] = True
        value = _wrap(value, self.guard, key)
        if self.inner is not None:
            self.inner.__set__(obj, value)
        else:
            obj.__dict__[self.attr] = value

    def __delete__(self, obj):
        key = (id(obj), self.attr)
        if not _in_init(key[0]):
            _note(self.guard, key, "w")
        if self.inner is not None:
            self.inner.__delete__(obj)
        else:
            del obj.__dict__[self.attr]

    def __repr__(self):
        return f"<GuardedField {self.guard.field!r}>"


class _WriteGuardedField:
    """Write-only data descriptor for thread-confined fields backed by
    the instance ``__dict__``: defining ``__set__`` without ``__get__``
    lets CPython serve READS straight from the instance dict at native
    speed (confined reads are unchecked dirty reads by design), while
    every write still routes through the confinement check."""

    __slots__ = ("attr", "guard", "memo_key")

    def __init__(self, attr: str, guard: _Guard):
        self.attr = attr
        self.guard = guard
        self.memo_key = "_fs_memo#" + attr

    def __set__(self, obj, value):
        key = (id(obj), self.attr)
        if obj.__dict__.get(self.memo_key) == threading.get_ident():
            obj.__dict__[self.attr] = _wrap(value, self.guard, key)
            return
        if not _in_init(key[0]):
            if _note(self.guard, key, "w"):
                obj.__dict__[self.memo_key] = threading.get_ident()
        obj.__dict__[self.attr] = _wrap(value, self.guard, key)

    def __delete__(self, obj):
        key = (id(obj), self.attr)
        if not _in_init(key[0]):
            _note(self.guard, key, "w")
        del obj.__dict__[self.attr]

    def __repr__(self):
        return f"<WriteGuardedField {self.guard.field!r}>"


def _class_fields(prefix: str) -> Dict[str, str]:
    plen = len(prefix) + 1
    return {key[plen:]: spec for key, spec in locksan.FIELDS.items()
            if key.startswith(prefix + ".") and "." not in key[plen:]}


def guarded(cls: type) -> type:
    """Class decorator installing fieldsan instrumentation for every
    ``locksan.FIELDS`` row declared under ``<module short name>.<class
    name>.<attr>``. A pure pass-through when RTPU_FIELDSAN is off —
    declaring ownership costs nothing in production."""
    if not _ENABLED:
        return cls
    prefix = cls.__module__.rsplit(".", 1)[-1] + "." + cls.__name__
    fields = _class_fields(prefix)
    installed = False
    for attr, spec in fields.items():
        guard = _Guard(f"{prefix}.{attr}", spec)
        if guard.kind == _ATOMIC:
            continue
        inner = cls.__dict__.get(attr)
        if inner is not None and not (hasattr(inner, "__get__")
                                      and hasattr(inner, "__set__")):
            inner = None            # plain class default, not a slot
        if guard.kind == _THREAD and inner is None:
            setattr(cls, attr, _WriteGuardedField(attr, guard))
        else:
            setattr(cls, attr, _GuardedField(attr, guard, inner))
        installed = True
    if installed:
        orig_init = cls.__init__
        attrs = tuple(fields)

        def __init__(self, *a, _fs_orig=orig_init, **k):
            # records are keyed by id(): a new object can take a dead
            # one's id, and must not pair with the dead one's accesses
            for attr in attrs:
                _last.pop((id(self), attr), None)
            with construction(self):
                _fs_orig(self, *a, **k)

        __init__.__wrapped__ = orig_init
        cls.__init__ = __init__
    return cls


def instrument_module(namespace: Dict[str, Any], modshort: str) -> None:
    """Wrap a module's declared module-level containers (two-part
    FIELDS keys, ``"<modshort>.<name>"``) in checking proxies. Call at
    the bottom of the module. No-op when fieldsan is off."""
    if not _ENABLED:
        return
    for key, spec in locksan.FIELDS.items():
        parts = key.split(".")
        if len(parts) != 2 or parts[0] != modshort:
            continue
        guard = _Guard(key, spec)
        if guard.kind == _ATOMIC:
            continue
        attr = parts[1]
        val = namespace.get(attr)
        if val is None:
            continue
        namespace[attr] = _wrap(val, guard, (modshort, attr))
