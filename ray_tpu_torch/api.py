"""Task and actor API: the ``@remote`` decorator and handles.

Equivalent role to the reference's ``RemoteFunction``
(``python/ray/remote_function.py:40``), ``ActorClass``/``ActorHandle``
(``python/ray/actor.py:384/1025``) and the ``ray.remote`` decorator
(``python/ray/_private/worker.py:3027``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ._private import context
from ._private import locksan
from ._private import protocol as P
from ._private import serialization as ser
from ._private.client import function_id_of
from ._private.config import CONFIG
from ._private.ids import ActorID, ObjectID
from ._private.object_ref import ObjectRef

_DEFAULT_TASK_CPUS = 1.0
# Alive actors hold NO cpu by default (reference semantics: the implicit
# 1 CPU applies to the creation task only — ``actor.py:384`` "num_cpus:
# ... default 1 for creation, 0 for running"). A lifetime CPU charge per
# actor starves task dispatch on small nodes; explicit num_cpus= still
# reserves for the actor's lifetime.
_DEFAULT_ACTOR_CPUS = 0.0


def _norm_num_returns(n) -> int:
    """\"streaming\"/\"dynamic\" -> -1 (dynamic returns via
    ObjectRefGenerator; reference: ``num_returns=\"streaming\"``)."""
    if n in ("streaming", "dynamic"):
        return -1
    return int(n)


def _build_resources(opts: Dict[str, Any], default_cpus: float) -> Dict[str, float]:
    res: Dict[str, float] = {}
    num_cpus = opts.get("num_cpus")
    res["CPU"] = float(default_cpus if num_cpus is None else num_cpus)
    if opts.get("num_gpus"):
        res["GPU"] = float(opts["num_gpus"])
    if opts.get("num_tpus"):  # accepted for scripts written for ray_tpu
        res["GPU"] = float(opts["num_tpus"])
    if opts.get("memory"):
        res["memory"] = float(opts["memory"])
    for k, v in (opts.get("resources") or {}).items():
        res[k] = float(v)
    for k, v in res.items():
        if v > 1 and not float(v).is_integer():
            # fractional shares are only meaningful within one unit —
            # 1.5 GPUs cannot map to exclusive card slots (reference:
            # fractional quantities must be <= 1)
            raise ValueError(
                f"resource quantities over 1 must be whole numbers, "
                f"got {k}={v}")
    out = {k: v for k, v in res.items() if v}
    if num_cpus is not None and "CPU" not in out:
        # an EXPLICIT num_cpus=0 must survive into the spec: it opts the
        # actor out of the implicit 1-CPU creation charge (reference:
        # "default 1 for creation, 0 for running" — explicit 0 means
        # 0/0). Without it a 0-CPU helper actor (e.g. a collective
        # group's coordinator) can never start on a saturated node,
        # deadlocking the very ranks that wait on it while holding
        # every CPU.
        out["CPU"] = 0.0
    return out


def _resolve_runtime_env(opts, client):
    """Merge the job-level runtime env (init(runtime_env=...)) with the
    per-task/actor one; env_vars merge key-wise, other keys override
    (reference: runtime-env inheritance semantics)."""
    from ._private import runtime_env as renv
    job_env = getattr(client, "job_runtime_env", None)
    task_env = renv.validate(opts.get("runtime_env"))
    if not job_env:
        return task_env
    if not task_env:
        return job_env
    merged = {**job_env, **task_env}
    if "env_vars" in job_env or "env_vars" in task_env:
        merged["env_vars"] = {**job_env.get("env_vars", {}),
                              **task_env.get("env_vars", {})}
    return merged


class RemoteFunction:
    """A function callable via ``.remote()`` (reference:
    ``remote_function.py:40``; submission path ``_remote`` :257)."""

    def __init__(self, fn, **options):
        self._fn = fn
        self._options = options
        self._name = options.get("name") or getattr(fn, "__qualname__",
                                                    str(fn))
        self._blob: Optional[bytes] = None
        self._function_id: Optional[bytes] = None
        self._lock = locksan.lock("api.remote_fn")

    def options(self, **options) -> "RemoteFunction":
        merged = {**self._options, **options}
        rf = RemoteFunction(self._fn, **merged)
        rf._blob = self._blob
        rf._function_id = self._function_id
        return rf

    def _ensure_exported(self, client) -> bytes:
        with self._lock:
            if self._function_id is None:
                self._blob = ser.dumps_function(self._fn)
                self._function_id = function_id_of(self._blob)
        client.ensure_function(self._function_id, lambda: self._blob)
        return self._function_id

    def remote(self, *args, **kwargs):
        client = context.require_client()
        fid = self._ensure_exported(client)
        opts = self._options
        num_returns = _norm_num_returns(opts.get("num_returns", 1))
        refs = client.submit_task(
            function_id=fid,
            name=self._name,
            args=args, kwargs=kwargs,
            num_returns=num_returns,
            resources=_build_resources(opts, _DEFAULT_TASK_CPUS),
            max_retries=opts.get("max_retries",
                                 CONFIG.task_max_retries_default),
            scheduling_strategy=opts.get("scheduling_strategy"),
            retry_exceptions=opts.get("retry_exceptions", False),
            runtime_env=_resolve_runtime_env(opts, client))
        if num_returns == -1:
            return refs                 # ObjectRefGenerator
        if num_returns == 1:
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """Lazy DAG node instead of immediate submission (reference:
        ``dag/function_node.py``)."""
        from .dag import FunctionNode
        return FunctionNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self._name} cannot be called directly; "
            f"use {self._name}.remote(...)")

    def __reduce__(self):
        # Exported already: ship the cached blob (plain-pickle-friendly,
        # keeps one function id across processes). NOT exported yet —
        # which includes mid-export, when a recursive function's closure
        # reaches back to itself — pickle the RAW function inside the
        # ENCLOSING dump: a nested dump here would deadlock on
        # self._lock and then recurse forever, while the enclosing
        # pickler's memo handles the closure cycle fine. The rebuilt
        # instance re-exports lazily on first .remote().
        blob = self._blob
        if blob is not None:
            return (_rebuild_remote_function_blob,
                    (blob, self._options))
        return (_rebuild_remote_function, (self._fn, self._options))


def _rebuild_remote_function(fn, options: dict) -> "RemoteFunction":
    return RemoteFunction(fn, **options)


def _rebuild_remote_function_blob(blob: bytes,
                                  options: dict) -> "RemoteFunction":
    rf = RemoteFunction(ser.loads_function(blob), **options)
    rf._blob = blob
    rf._function_id = function_id_of(blob)
    return rf


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str):
        self._handle = handle
        self._method_name = method_name

    def options(self, **opts) -> "ActorMethod":
        m = ActorMethod(self._handle, self._method_name)
        m._opts = opts
        return m

    def bind(self, *args, **kwargs):
        """DAG node calling this method on the LIVE handle (reference:
        binding methods of an existing actor into a DAG)."""
        from .dag import FunctionNode
        return FunctionNode(self, args, kwargs)

    @property
    def _name(self):
        return f"{self._handle._class_name}.{self._method_name}"

    def remote(self, *args, **kwargs):
        client = context.require_client()
        # precedence: .options() > @method defaults on the class
        opts = {**self._handle._method_opts.get(self._method_name, {}),
                **getattr(self, "_opts", {})}
        num_returns = _norm_num_returns(opts.get("num_returns", 1))
        refs = client.submit_actor_task(
            actor_id=self._handle._actor_id,
            method_name=self._method_name,
            args=args, kwargs=kwargs,
            num_returns=num_returns,
            seq_no=self._handle._next_seq(),
            name=f"{self._handle._class_name}.{self._method_name}")
        if num_returns == -1:
            return refs                 # ObjectRefGenerator
        if num_returns == 1:
            return refs[0]
        return refs


def _rebuild_handle(actor_id_bytes: bytes, class_name: str,
                    method_opts: Optional[dict] = None):
    return ActorHandle(ActorID(actor_id_bytes), class_name, method_opts)


class ActorHandle:
    """Reference to a live actor; methods via attribute access (reference:
    ``actor.py:1025``). Picklable: reconstructs against the local client."""

    def __init__(self, actor_id: ActorID, class_name: str,
                 method_opts: Optional[Dict[str, dict]] = None):
        self._actor_id = actor_id
        self._class_name = class_name
        self._method_opts = method_opts or {}
        self._seq = 0
        self._seq_lock = locksan.lock("api.actor_seq")

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def _next_seq(self) -> int:
        with self._seq_lock:
            self._seq += 1
            return self._seq

    def __getattr__(self, name: str) -> ActorMethod:
        # Underscore attributes fail lookup (pickle/inspect/duck-typing
        # probes expect AttributeError) — except the framework's own
        # actor hooks (_rtpu_*), which are remote-callable.
        if name.startswith("_") and not name.startswith("_rtpu_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (_rebuild_handle, (self._actor_id.binary(), self._class_name,
                                  self._method_opts))


class ActorClass:
    """Produced by ``@remote`` on a class (reference: ``actor.py:384``)."""

    def __init__(self, cls, **options):
        self._cls = cls
        self._options = options
        self._blob: Optional[bytes] = None
        self._lock = locksan.lock("api.actor_class")

    def options(self, **options) -> "ActorClass":
        merged = {**self._options, **options}
        ac = ActorClass(self._cls, **merged)
        ac._blob = self._blob
        return ac

    def remote(self, *args, **kwargs) -> ActorHandle:
        client = context.require_client()
        with self._lock:
            if self._blob is None:
                self._blob = ser.dumps_function(self._cls)
        opts = self._options
        actor_id = ActorID.from_random()
        packed, pkw = client.pack_args(args, kwargs)
        creation_return = ObjectID.for_put(client.worker_id)
        spec = P.ActorSpec(
            actor_id=actor_id,
            job_id=client.job_id,
            name=self._cls.__name__,
            registered_name=opts.get("name"),
            namespace=opts.get("namespace") or context.active_namespace(),
            class_blob=self._blob,
            args=packed, kwargs=pkw,
            resources=_build_resources(opts, _DEFAULT_ACTOR_CPUS),
            max_restarts=opts.get("max_restarts",
                                  CONFIG.actor_max_restarts_default),
            max_concurrency=opts.get("max_concurrency", 1),
            is_async=self._detect_async(),
            lifetime=opts.get("lifetime"),
            scheduling_strategy=opts.get("scheduling_strategy"),
            creation_return_id=creation_return,
            runtime_env=_resolve_runtime_env(opts, client))
        client.create_actor(spec)
        handle = ActorHandle(actor_id, self._cls.__name__,
                             self._method_options())
        handle._ready_ref = ObjectRef(creation_return)
        return handle

    def _method_options(self) -> Dict[str, dict]:
        """Collect ``@method(...)`` defaults declared on the class."""
        out: Dict[str, dict] = {}
        for name in dir(self._cls):
            member = getattr(self._cls, name, None)
            opts = getattr(member, "_rtpu_method_opts", None)
            if opts:
                out[name] = opts
        return out

    def _detect_async(self) -> bool:
        import inspect
        for name, member in inspect.getmembers(self._cls):
            if not name.startswith("__") and inspect.iscoroutinefunction(member):
                return True
        return False

    def bind(self, *args, **kwargs):
        """Lazy actor-creation DAG node (reference: ``dag/class_node.py``)."""
        from .dag import ClassNode
        return ClassNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._cls.__name__} cannot be instantiated "
            f"directly; use {self._cls.__name__}.remote(...)")

    def __reduce__(self):
        with self._lock:
            if self._blob is None:
                self._blob = ser.dumps_function(self._cls)
        return (_rebuild_actor_class, (self._blob, self._options))


def _rebuild_actor_class(blob: bytes, options: dict) -> "ActorClass":
    ac = ActorClass(ser.loads_function(blob), **options)
    ac._blob = blob
    return ac


def remote(*args, **kwargs):
    """``@remote`` / ``@remote(num_cpus=..., num_gpus=..., ...)``."""
    if len(args) == 1 and not kwargs and callable(args[0]):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)
    if args:
        raise TypeError("remote() takes keyword options only")

    def decorator(target):
        if isinstance(target, type):
            return ActorClass(target, **kwargs)
        return RemoteFunction(target, **kwargs)

    return decorator


def method(**opts):
    """Decorator for actor methods carrying default options (reference:
    ``ray.method``)."""

    def decorator(fn):
        fn._rtpu_method_opts = opts
        return fn

    return decorator
