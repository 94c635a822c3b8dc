"""Durable workflows: run a task DAG with per-step checkpointing and
crash-resume.

Reference analogue: ``python/ray/workflow/`` (``api.py`` run/resume/
get_output/list_all, ``workflow_executor.py``, ``workflow_storage.py``).
Same core contract: each step's result is checkpointed to storage as it
completes; a re-run (or ``resume`` after a crash) skips every
checkpointed step and recomputes only what's missing; the DAG and its
inputs are persisted so resume works from a fresh driver process.

Scope notes (explicit descopes, mirroring the reference's deprecations):
virtual actors and workflow events are not implemented; actor nodes
(``ClassNode``/``ClassMethodNode``) are rejected in workflows because
actor state cannot be checkpointed durably — use task nodes.
"""

from __future__ import annotations

import json
import os
import pickle
import sys
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

from .._private import locksan
from .._private import serialization as ser
from ..dag import (ClassMethodNode, ClassNode, DAGInputData, DAGNode,
                   FunctionNode, InputAttributeNode, InputNode,
                   MultiOutputNode)

# statuses (reference: workflow_state WorkflowStatus)
RUNNING = "RUNNING"
SUCCESSFUL = "SUCCESSFUL"
FAILED = "FAILED"
RESUMABLE = "RESUMABLE"

_storage_dir: Optional[str] = None
_lock = locksan.lock("workflow.registry")


def init(storage: Optional[str] = None) -> None:
    """Set the workflow storage root (default:
    ``$RTPU_WORKFLOW_STORAGE`` or ``~/rtpt_workflows``)."""
    global _storage_dir
    _storage_dir = storage


def _storage() -> str:
    return (_storage_dir or os.environ.get("RTPU_WORKFLOW_STORAGE")
            or os.path.expanduser("~/rtpt_workflows"))


class _WorkflowStorage:
    """Filesystem layout: <root>/<workflow_id>/{state.json, dag.pkl,
    input.pkl, output.pkl, steps/<step_id>.pkl} (reference:
    ``workflow_storage.py`` key scheme)."""

    def __init__(self, workflow_id: str):
        self.dir = os.path.join(_storage(), workflow_id)
        self.steps_dir = os.path.join(self.dir, "steps")

    def create(self, dag: DAGNode, args: tuple, kwargs: dict) -> None:
        os.makedirs(self.steps_dir, exist_ok=True)
        with open(os.path.join(self.dir, "dag.pkl"), "wb") as f:
            f.write(ser.dumps_function(dag))
        with open(os.path.join(self.dir, "input.pkl"), "wb") as f:
            f.write(ser.dumps_function((args, kwargs)))
        with open(os.path.join(self.dir, "plan.json"), "w") as f:
            json.dump(_plan_fingerprint(dag, args, kwargs), f)
        self.set_status(RUNNING)

    def check_same_plan(self, dag: DAGNode, args: tuple,
                        kwargs: dict) -> None:
        try:
            with open(os.path.join(self.dir, "plan.json")) as f:
                stored = json.load(f)
        except (OSError, ValueError):
            return
        current = _plan_fingerprint(dag, args, kwargs)
        if stored.get("hash_v") != current.get("hash_v"):
            # encoding changed between releases: only the structural
            # fields are comparable
            stored = {k: v for k, v in stored.items()
                      if k in ("steps", "edges")}
            current = {k: v for k, v in current.items()
                       if k in ("steps", "edges")}
        if stored != current:
            raise ValueError(
                "workflow id already exists with a DIFFERENT dag or "
                "inputs; reusing its checkpoints would return results "
                "of the old computation. Use a new workflow_id, "
                "resume() the old one, or delete() it first.")

    def load_dag(self):
        with open(os.path.join(self.dir, "dag.pkl"), "rb") as f:
            dag = ser.loads_function(f.read())
        with open(os.path.join(self.dir, "input.pkl"), "rb") as f:
            args, kwargs = ser.loads_function(f.read())
        return dag, args, kwargs

    def set_status(self, status: str, error: str = "") -> None:
        state = {"status": status, "updated_at": time.time()}
        if error:
            state["error"] = error
        tmp = os.path.join(self.dir, "state.json.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, os.path.join(self.dir, "state.json"))

    def status(self) -> Optional[str]:
        try:
            with open(os.path.join(self.dir, "state.json")) as f:
                return json.load(f)["status"]
        except (OSError, KeyError, ValueError):
            return None

    def save_step(self, step_id: str, value: Any) -> None:
        tmp = os.path.join(self.steps_dir, step_id + ".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(value, f, protocol=5)
        os.replace(tmp, os.path.join(self.steps_dir, step_id + ".pkl"))

    def load_step(self, step_id: str):
        path = os.path.join(self.steps_dir, step_id + ".pkl")
        if not os.path.exists(path):
            return False, None
        with open(path, "rb") as f:
            return True, pickle.load(f)

    def save_output(self, value: Any) -> None:
        self.save_step("__output__", value)
        self.set_status(SUCCESSFUL)

    def load_output(self):
        return self.load_step("__output__")

    def exists(self) -> bool:
        return os.path.isdir(self.dir)


def _step_ids(dag: DAGNode) -> Dict[int, str]:
    """Deterministic step ids: post-order index + node label. The walk
    order depends only on DAG structure, so ids are stable across the
    pickle/unpickle boundary resume crosses."""
    ids = {}
    for idx, node in enumerate(dag.walk()):
        if isinstance(node, (ClassNode, ClassMethodNode)):
            raise ValueError(
                "workflows cannot contain actor nodes (actor state is "
                "not durable); use task nodes")
        if isinstance(node, FunctionNode):
            if getattr(node._remote_fn, "_handle", None) is not None:
                # a live-handle ActorMethod bound via .bind(): the pickled
                # handle in dag.pkl would point at a dead actor on resume
                raise ValueError(
                    "workflows cannot contain live actor-method nodes "
                    "(the actor will not exist at resume time); use "
                    "task nodes")
            label = getattr(node._remote_fn, "_name", "fn")
            ids[id(node)] = f"{idx:04d}-{label}"
    return ids


def _plan_fingerprint(dag: DAGNode, args: tuple, kwargs: dict) -> dict:
    """Structural fingerprint persisted at creation so a later
    ``run(other_dag, workflow_id=same)`` is rejected instead of silently
    served stale checkpoints: step ids, dependency edges, and a hash of
    the constant bound args + workflow inputs."""
    import hashlib

    ids = _step_ids(dag)
    nodes = list(dag.walk())
    index = {id(n): i for i, n in enumerate(nodes)}
    # JSON-native shapes only (the stored copy round-trips through json)
    edges = sorted([index[id(c)], index[id(n)]]
                   for n in nodes for c in n._children())
    # Hash a canonical value encoding, not repr(): reprs truncate large
    # arrays (different inputs would collide) and embed object addresses
    # (identical re-runs would spuriously differ). Raw pickle bytes are
    # also not enough — set iteration order varies across interpreter
    # hash seeds — so containers are canonicalized first.
    consts = [([a for a in n._bound_args if not isinstance(a, DAGNode)],
               {k: v for k, v in sorted(n._bound_kwargs.items())
                if not isinstance(v, DAGNode)})
              for n in nodes]
    h = hashlib.sha256()
    _stable_update(h, (consts, args, kwargs))
    # "hash_v" versions the encoding: plans checkpointed under an older
    # scheme skip the args comparison instead of spuriously rejecting an
    # identical re-run (structure — steps/edges — is still compared)
    return {"steps": sorted(ids.values()), "edges": edges,
            "args_hash": h.hexdigest(), "hash_v": 2}


def _stable_update(h, obj) -> None:
    """Feed ``obj`` into hash ``h`` as a canonical, process-stable byte
    encoding. Containers are walked with type tags; unordered containers
    are sorted by their members' canonical digests (set pickle bytes
    depend on the interpreter hash seed); arrays and torch tensors hash
    their raw buffer; anything else falls back to its pickled bytes."""
    import hashlib
    import numpy as _np

    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        h.update(f"{type(obj).__name__}:{obj!r};".encode())
    elif isinstance(obj, (list, tuple)):
        h.update(f"{type(obj).__name__}[{len(obj)}](".encode())
        for item in obj:
            _stable_update(h, item)
        h.update(b")")
    elif isinstance(obj, dict):
        h.update(f"dict[{len(obj)}](".encode())
        for key, sub in sorted(obj.items(),
                               key=lambda kv: _stable_digest(kv[0])):
            _stable_update(h, key)
            _stable_update(h, sub)
        h.update(b")")
    elif isinstance(obj, (set, frozenset)):
        h.update(f"{type(obj).__name__}[{len(obj)}](".encode())
        for d in sorted(_stable_digest(item) for item in obj):
            h.update(d)
        h.update(b")")
    elif isinstance(obj, _np.ndarray):
        if obj.dtype == object:
            # object arrays' raw buffer is PyObject pointers — hash the
            # elements by value instead
            h.update(f"ndarray:object:{obj.shape}(".encode())
            for item in obj.ravel():
                _stable_update(h, item)
            h.update(b")")
        else:
            arr = _np.ascontiguousarray(obj)
            h.update(f"ndarray:{arr.dtype}:{arr.shape};".encode())
            h.update(arr.tobytes())
    elif _is_dense_tensor(obj):
        # a torch tensor hashes as an array does: torch's own pickle of a
        # tensor embeds its storage's address, so those bytes differ from
        # process to process (ray_tpu's jax.Array pickles stably)
        t = obj.detach().resolve_conj().resolve_neg().cpu().contiguous()
        h.update(f"tensor:{t.dtype}:{tuple(t.shape)};".encode())
        h.update(t.reshape(-1).view(sys.modules["torch"].uint8)
                 .numpy().tobytes())
    else:
        h.update(b"pickle:")
        h.update(ser.dumps_function(obj))


def _is_dense_tensor(obj) -> bool:
    """A strided, unquantized torch tensor (torch found through
    ``sys.modules``, never imported here)."""
    torch = sys.modules.get("torch")
    return (torch is not None and isinstance(obj, torch.Tensor)
            and obj.layout == torch.strided and not obj.is_quantized)


def _stable_digest(obj) -> bytes:
    import hashlib
    h = hashlib.sha256()
    _stable_update(h, obj)
    return h.digest()


def _execute_durable(wf: _WorkflowStorage, dag: DAGNode, args: tuple,
                     kwargs: dict) -> Any:
    """Wave-scheduled execution: every FunctionNode whose deps are
    resolved is submitted concurrently; results are checkpointed as they
    arrive (parallel branches stay parallel, like the reference's
    executor)."""
    from .. import get, wait

    ids = _step_ids(dag)
    nodes = list(dag.walk())
    values: Dict[int, Any] = {}
    in_flight: Dict[Any, DAGNode] = {}            # ref -> node

    def deps_of(node: DAGNode) -> List[DAGNode]:
        return node._children()

    def resolve_inline(node: DAGNode):
        """Non-task nodes evaluate on the driver from resolved deps."""
        if isinstance(node, InputNode):
            if not args and not kwargs:
                raise ValueError("workflow DAG has an InputNode but no "
                                 "input args were given")
            if len(args) == 1 and not kwargs:
                return args[0]
            return DAGInputData(args, kwargs)
        if isinstance(node, InputAttributeNode):
            base = values[id(node._bound_args[0])]
            return (base[node._key] if node._kind == "item"
                    else getattr(base, node._key))
        if isinstance(node, MultiOutputNode):
            return [values[id(a)] if isinstance(a, DAGNode) else a
                    for a in node._bound_args]
        raise TypeError(f"unsupported workflow node {type(node)}")

    def ready(node) -> bool:
        return all(id(d) in values for d in deps_of(node))

    def submit_ready():
        for node in nodes:
            if id(node) in values or node in in_flight.values():
                continue
            if not ready(node):
                continue
            if isinstance(node, FunctionNode):
                done, val = wf.load_step(ids[id(node)])
                if done:
                    values[id(node)] = val
                    continue
                call_args = [values[id(a)] if isinstance(a, DAGNode) else a
                             for a in node._bound_args]
                call_kwargs = {
                    k: values[id(v)] if isinstance(v, DAGNode) else v
                    for k, v in node._bound_kwargs.items()}
                ref = node._remote_fn.remote(*call_args, **call_kwargs)
                in_flight[ref] = node
            else:
                values[id(node)] = resolve_inline(node)

    submit_ready()
    while id(dag) not in values:
        if not in_flight:
            submit_ready()
            if not in_flight and id(dag) not in values:
                raise RuntimeError("workflow made no progress "
                                   "(cycle or unresolvable node)")
            continue
        done_refs, _ = wait(list(in_flight), num_returns=1)
        ref = done_refs[0]
        node = in_flight.pop(ref)
        val = get(ref)
        wf.save_step(ids[id(node)], val)
        values[id(node)] = val
        submit_ready()
    return values[id(dag)]


def run(dag: DAGNode, *dag_args, workflow_id: Optional[str] = None,
        **dag_kwargs) -> Any:
    """Execute a DAG durably; returns the final output. A re-run with
    the same ``workflow_id`` skips checkpointed steps (idempotent)."""
    if workflow_id is None:
        workflow_id = f"wf-{int(time.time() * 1000):x}-{os.getpid():x}"
    wf = _WorkflowStorage(workflow_id)
    with _lock:
        if wf.exists():
            wf.check_same_plan(dag, dag_args, dag_kwargs)
            has_out, out = wf.load_output()
            if has_out:
                return out
            wf.set_status(RUNNING)       # an active retry is not FAILED
        else:
            wf.create(dag, dag_args, dag_kwargs)
    try:
        out = _execute_durable(wf, dag, dag_args, dag_kwargs)
    except Exception as e:
        wf.set_status(FAILED, error=repr(e))
        raise
    wf.save_output(out)
    return out


def run_async(dag: DAGNode, *dag_args,
              workflow_id: Optional[str] = None, **dag_kwargs) -> Future:
    """``run`` on a background thread; returns a Future."""
    fut: Future = Future()

    def target():
        try:
            fut.set_result(run(dag, *dag_args, workflow_id=workflow_id,
                               **dag_kwargs))
        except BaseException as e:  # noqa: BLE001 - delivered via Future
            fut.set_exception(e)

    threading.Thread(target=target, daemon=True,
                     name=f"rtpu-workflow-{workflow_id}").start()
    return fut


def resume(workflow_id: str) -> Any:
    """Re-drive a crashed/failed workflow from its checkpoints."""
    wf = _WorkflowStorage(workflow_id)
    if not wf.exists():
        raise ValueError(f"no workflow {workflow_id!r} in {_storage()}")
    has_out, out = wf.load_output()
    if has_out:
        return out
    dag, args, kwargs = wf.load_dag()
    wf.set_status(RUNNING)
    try:
        out = _execute_durable(wf, dag, args, kwargs)
    except Exception as e:
        wf.set_status(FAILED, error=repr(e))
        raise
    wf.save_output(out)
    return out


def get_status(workflow_id: str) -> Optional[str]:
    st = _WorkflowStorage(workflow_id).status()
    if st == RUNNING:
        # a RUNNING state with no live driver is a crashed run; we cannot
        # detect liveness across processes cheaply, so report RESUMABLE
        # (resume of a genuinely-running workflow is a user error, as in
        # the reference)
        return RESUMABLE
    return st


def get_output(workflow_id: str) -> Any:
    has_out, out = _WorkflowStorage(workflow_id).load_output()
    if not has_out:
        raise ValueError(f"workflow {workflow_id!r} has no output "
                         f"(status={get_status(workflow_id)})")
    return out


def list_all() -> List[tuple]:
    root = _storage()
    out = []
    if os.path.isdir(root):
        for wid in sorted(os.listdir(root)):
            st = _WorkflowStorage(wid).status()
            if st is not None:
                out.append((wid, RESUMABLE if st == RUNNING else st))
    return out


def delete(workflow_id: str) -> None:
    import shutil
    wf = _WorkflowStorage(workflow_id)
    if wf.exists():
        shutil.rmtree(wf.dir)
