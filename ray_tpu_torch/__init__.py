"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu``, for NVIDIA Hopper.

A package of its own beside ``ray_tpu``: it imports ``torch`` and
``numpy`` and nothing of JAX or of ``ray_tpu``. Its core is the runtime's
own copy: tasks, actors and a shared-memory object store (``init``,
``remote``, ``get``, ``put``, ``wait`` …), where ``num_gpus`` gives a task or
actor exclusive cards and torch tensors travel through the store. Beside it
sit the flagship decoder's training step (``models``), with its attention
on hand-written CUDA flash kernels and ring attention over them (``ops``),
on one device or over a dp x fsdp x tp x sp mesh (``parallel``), and the RL
compute core (``rl``: the policy and Q modules, the PPO, V-trace and
double-DQN learners, GAE, replay buffers and the env runners' sampling),
the gang trainer (``train``) and its hyperparameter search (``tune``),
streaming datasets whose device batches land on the card as torch tensors
(``data``), the host collectives with ``MeshGroup`` (``comm``), which
take torch tensors, CUDA and bf16 ones included, model serving from
replica actors (``serve``), durable workflows (``workflow``) and the
autoscaler (``autoscaler``); node processes (``_private/main.py``,
``cluster_utils.Cluster(process_isolated=True)``) with the head's job
service (``job``) and dashboard (``dashboard``), and the CLI
(``scripts.cli``).
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; callers that sample on the CPU as the JAX runners do pass
it to the env runners.

The ML subpackages, ``data``, ``comm`` and ``tune`` are imported lazily, on
first attribute access: the runtime imports no torch, so worker processes
stay light.
"""

from __future__ import annotations

import atexit
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Union

from . import exceptions  # noqa: F401
from ._private import context as _ctx
from ._private import protocol as _P
from ._private.client import CoreClient
from ._private.config import CONFIG
from ._private.gcs import GlobalControlPlane, JobRecord
from ._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID  # noqa: F401
from ._private.node import NodeService
from ._private.object_ref import ObjectRef, ObjectRefGenerator
from .api import ActorClass, ActorHandle, RemoteFunction, method, remote  # noqa: F401
from .runtime_context import get_runtime_context  # noqa: F401

__version__ = "0.1.0"

_LAZY_SUBPACKAGES = ("comm", "data", "models", "ops", "parallel", "rl",
                     "train", "tune")


def __getattr__(name: str):
    if name in _LAZY_SUBPACKAGES:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

_global_node: Optional[NodeService] = None
_global_gcs: Optional[GlobalControlPlane] = None
_session_dir: Optional[str] = None
_owns_cluster = False


def init(address: Optional[Any] = None,
         num_cpus: Optional[int] = None,
         num_gpus: Optional[int] = None,
         resources: Optional[Dict[str, float]] = None,
         namespace: str = "default",
         object_store_memory: Optional[int] = None,
         ignore_reinit_error: bool = False,
         runtime_env: Optional[Dict[str, Any]] = None,
         _system_config: Optional[Dict[str, Any]] = None,
         num_tpus: Optional[int] = None) -> None:
    """Start a local node (head) and connect, or connect to an existing
    cluster: a ``cluster_utils.Cluster`` (in-process or process-isolated)
    or the ``"host:port"`` of a head's GCS.

    The node's ``"GPU"`` resource is ``num_gpus`` (``num_tpus`` is accepted
    for scripts written for ``ray_tpu`` and means the same), else
    ``resources["GPU"]``, else the number of CUDA devices this process sees
    (counted without torch or a CUDA context, ``_private/gpus.py``).

    Reference analogue: ``ray.init`` (``_private/worker.py:1139``) — the
    local-bootstrap path spawns the control plane + node service + worker
    pool; here they live in this process with workers as subprocesses.
    """
    global _global_node, _global_gcs, _session_dir, _owns_cluster
    if _ctx.current_client is not None:
        if ignore_reinit_error:
            return
        raise RuntimeError("ray_tpu_torch.init() called twice; "
                           "call ray_tpu_torch.shutdown() first")
    if _system_config:
        CONFIG.reload(_system_config)

    job_id = JobID.from_random()
    head_tcp_address = None
    if address is not None:
        from . import cluster_utils
        if isinstance(address, cluster_utils.Cluster):
            if address.process_isolated:
                address = address.gcs_address
            else:
                # attach to an in-process multi-node cluster (tests/tools)
                cluster = address
                _global_gcs = cluster.gcs
                _global_node = cluster.head
                _session_dir = cluster.session_dir
                _owns_cluster = False
                address = None
        if isinstance(address, str):
            # attach to a networked cluster: "host:port" of the head GCS
            # (reference analogue: ``ray.init(address=...)`` joining a
            # running cluster). The driver must share a host with the
            # head node — object payloads ride /dev/shm.
            from ._private.gcs_service import RemoteControlPlane
            import json as _json
            _global_gcs = RemoteControlPlane(address)
            try:
                head = _global_gcs.kv_get(b"__rtpu_head_node")
                if head is None:
                    raise ConnectionError(
                        f"no head node registered at {address}")
            except BaseException:
                # don't leak the channel/reader thread or a stale global
                _global_gcs.close()
                _global_gcs = None
                raise
            head = _json.loads(head)
            head_tcp_address = head["address"]
            _global_node = None
            _session_dir = None
            _owns_cluster = False
        elif address is not None and not isinstance(
                address, cluster_utils.Cluster):
            raise ValueError(f"unsupported address: {address!r}")
    else:
        _session_dir = tempfile.mkdtemp(prefix="rtpt_session_")
        _global_gcs = GlobalControlPlane()
        res = dict(resources or {})
        res.setdefault("CPU", float(num_cpus if num_cpus is not None
                                    else os.cpu_count() or 4))
        if num_gpus is None:
            num_gpus = num_tpus
        if num_gpus is not None:
            res.setdefault("GPU", float(num_gpus))
        elif "GPU" not in res:
            from ._private.gpus import visible_gpu_count
            detected = visible_gpu_count()
            if detected:
                res["GPU"] = float(detected)
        if object_store_memory:
            CONFIG._values["object_store_memory_mb"] = (
                object_store_memory // (1 << 20))
        _global_node = NodeService(_global_gcs, _session_dir, res)
        _global_node.start()
        _owns_cluster = True

    if _global_node is not None:
        conn = _P.connect_unix(_global_node.socket_path)
        node_id = _global_node.node_id
    else:
        from ._private.ids import NodeID as _NodeID
        conn = _P.connect_address(head_tcp_address)
        node_id = _NodeID.from_hex(head["node_id"])
    client = CoreClient(conn, job_id, WorkerID.from_random(), _P.KIND_DRIVER)
    if _global_node is not None:
        # head driver: large puts go straight to the in-process store
        # (alloc/write/seal, no control-plane round trips)
        client.local_node = _global_node
    if _global_node is None:
        # Ray-Client-equivalent attach: when this driver does not share
        # /dev/shm with the head node, object payloads must ride the
        # socket instead of shared memory. Primary signal: read the
        # head's shm probe token back (a direct capability test —
        # hostname equality lies when containers share names). The
        # RTPU_NODE_HOST override keeps the test hook for simulating
        # foreign hosts on one machine.
        my_host = os.environ.get("RTPU_NODE_HOST")
        head_host = head.get("host")
        if my_host:
            client.wire_data_plane = bool(head_host) and head_host != my_host
        else:
            probe = head.get("shm_probe") or (None, None)
            same_shm = False
            if probe[0]:
                try:
                    with open(probe[0]) as _f:
                        same_shm = _f.read().strip() == probe[1]
                except OSError:
                    same_shm = False
            else:
                import socket as _socket
                same_shm = (not head_host
                            or head_host == _socket.gethostname())
            client.wire_data_plane = not same_shm
    conn.send((_P.REGISTER, (_P.KIND_DRIVER, client.worker_id.binary(),
                             os.getpid())))
    client.start_reader()
    client.namespace = namespace
    client.node_id = node_id
    from ._private import runtime_env as _renv
    client.job_runtime_env = _renv.validate(runtime_env)
    _ctx.current_client = client
    _global_gcs.register_job(JobRecord(job_id=job_id, driver_pid=os.getpid(),
                                       start_time=time.time()))
    _install_driver_failure_hook()
    atexit.register(shutdown)


_prev_excepthook = None


def _install_driver_failure_hook() -> None:
    """Driver shutdown on an uncaught error is a terminal failure: hook
    ``sys.excepthook`` (once per process, chained) so the dying driver
    auto-captures a post-mortem debug bundle while its client is still
    connected — the corpse `rtpu autopsy` reads after the session is
    gone. Gated by ``debug_bundle_on_failure``."""
    global _prev_excepthook
    import sys as _sys
    if _prev_excepthook is not None:
        return
    _prev_excepthook = _sys.excepthook

    def _hook(tp, val, tb):
        try:
            if (_ctx.current_client is not None
                    and not issubclass(tp, KeyboardInterrupt)):
                from ._private import debug_bundle
                debug_bundle.auto_capture(
                    "driver_error",
                    fields={"error": f"{tp.__name__}: {val}"})
        except Exception:   # noqa: BLE001 — never mask the real error
            pass
        _prev_excepthook(tp, val, tb)

    _sys.excepthook = _hook


def is_initialized() -> bool:
    return _ctx.current_client is not None


def shutdown() -> None:
    global _global_node, _global_gcs, _session_dir, _owns_cluster
    client = _ctx.current_client
    if client is None:
        return
    if CONFIG.tracing_enabled:
        from .util import tracing as _tracing
        _tracing.flush()          # ship driver-side spans before detach
    _ctx.current_client = None
    try:
        client.close()
    except Exception:
        pass
    if _owns_cluster and _global_node is not None:
        _global_node.stop()
        if _session_dir:
            import shutil
            shutil.rmtree(_session_dir, ignore_errors=True)
    if _global_gcs is not None and hasattr(_global_gcs, "close"):
        try:
            _global_gcs.close()   # remote attach: drop the GCS channel
        except Exception:
            pass
    _global_node = None
    _global_gcs = None
    _session_dir = None
    _owns_cluster = False
    # telemetry is session-scoped too: the next init() gets a fresh
    # control plane, so local shard totals must not leak deltas into it
    from ._private import telemetry as _telemetry
    _telemetry.reset()
    # so are the collective flight-recorder's ring and watermark tables
    # (a stale ring would bleed this session's collective spans into the
    # next session's state.timeline())
    from ._private import flight_recorder as _flight_recorder
    _flight_recorder.reset()
    # and tracing's local span buffer: the rate-limited maybe_flush can
    # leave the session's last request spans buffered here — shipping
    # them after the next init() would graft a dead session's request
    # lane onto the new plane's timeline
    from .util import tracing as _tracing
    _tracing.drain()
    # _system_config is session-scoped: the next init() must not inherit
    # this session's overrides (they'd silently change its behavior)
    CONFIG.reload()
    atexit.unregister(shutdown)


def put(value: Any) -> ObjectRef:
    """Store a value in the object store (reference: ``worker.py:2590``)."""
    return _ctx.require_client().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None) -> Any:
    """Fetch object values, blocking (reference: ``worker.py:2475``)."""
    client = _ctx.require_client()
    if isinstance(refs, ObjectRef):
        return client.get([refs], timeout=timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"get() expects ObjectRef or list, got {type(refs)}")
    if not refs:
        return []
    return client.get(list(refs), timeout=timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    """Wait for ``num_returns`` of ``refs`` to complete (reference:
    ``worker.py:2653``)."""
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds number of refs")
    return _ctx.require_client().wait(list(refs), num_returns, timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    """Forcibly terminate an actor (reference: ``ray.kill``)."""
    _ctx.require_client().kill_actor(actor.actor_id, no_restart)


def exit_actor() -> None:
    """Intentionally terminate the CURRENT actor from inside one of its
    methods (reference: ``ray.actor.exit_actor``): the node kills this
    actor's worker with restarts suppressed, and the executing method
    unwinds — its caller observes the actor's death rather than a
    return value."""
    aid = _ctx.current_actor_id
    if aid is None:
        raise RuntimeError(
            "exit_actor() can only be called inside an actor method")
    client = _ctx.require_client()
    try:
        client.actor_exit(aid, "exit_actor()")
    except OSError:
        # the node never hears the intent, so restart suppression is
        # lost — the conn-death path will treat this as a crash (and
        # may restart the actor); say so instead of silently diverging
        import sys as _sys
        print(f"[ray_tpu_torch] exit_actor(): ACTOR_EXIT send failed for "
              f"{aid.hex()[:12]} (connection down); the actor may be "
              "restarted as a crash", file=_sys.stderr)
    raise SystemExit(0)


def actor_checkpoint() -> int:
    """Snapshot the CURRENT actor's state now, from inside one of its
    methods: calls the actor's opt-in ``save_checkpoint()`` and
    persists the result in the control plane (synchronously — when this
    returns, a restart restores at least this state). A restarted actor
    whose class defines ``restore_checkpoint(state)`` replays its
    latest snapshot before any queued call drains. Returns the
    checkpoint's sequence number. See also the periodic trigger,
    ``actor_checkpoint_interval_calls``."""
    hook = _ctx.actor_checkpoint_hook
    if hook is None or _ctx.current_actor_id is None:
        raise RuntimeError(
            "actor_checkpoint() can only be called inside a method of "
            "an actor that defines save_checkpoint()")
    return hook()


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    """Cancel the task that produces ``ref`` (reference: ``ray.cancel``)."""
    _ctx.require_client().cancel_task(ref.task_id(), force)


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    """Look up a named actor (reference: ``worker.py:2784``). Defaults to
    the namespace passed to ``init()``."""
    client = _ctx.require_client()
    namespace = namespace or _ctx.active_namespace()
    info = client.get_named_actor(name, namespace)
    if info is None:
        raise ValueError(f"no actor named {name!r} in namespace {namespace!r}")
    return ActorHandle(info["actor_id"], info["name"])


def free(refs: Sequence[ObjectRef]) -> None:
    if isinstance(refs, ObjectRef):
        refs = [refs]
    _ctx.require_client().free(list(refs))


def nodes() -> List[dict]:
    return _ctx.require_client().cluster_info("nodes")


def cluster_resources() -> Dict[str, float]:
    return _ctx.require_client().cluster_info("resources_total")


def available_resources() -> Dict[str, float]:
    return _ctx.require_client().cluster_info("resources_available")
