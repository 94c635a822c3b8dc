"""Worker process entrypoint: executes tasks and hosts actor instances.

Equivalent role to the reference's ``default_worker.py`` +
``CoreWorker::RunTaskExecutionLoop`` (``python/ray/_private/workers/
default_worker.py``, ``_raylet.pyx:3035`` run_task_loop,
``task_execution_handler`` ``_raylet.pyx:1972``): registers with the node
service, pulls pushed tasks off its socket, loads functions from the
control-plane KV (cached by content hash), executes, and seals returns
either inline or into shared memory. Nested API calls (a task calling
``remote``/``get``) reuse the same connection through the process-global
``CoreClient``.
"""

from __future__ import annotations

import asyncio
import ctypes
import inspect
import itertools
import os
import signal
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, SimpleQueue
from typing import Any, Dict, List, Optional

from .. import exceptions
from . import context
from . import failpoints
from . import fieldsan
from . import protocol as P
from . import telemetry
from .client import CoreClient
from .config import CONFIG
from .ids import JobID, NodeID, ObjectID, WorkerID
from .object_store import ObjectMeta, create_segment
from . import serialization as ser

M_ACTOR_CKPTS = telemetry.define(
    "counter", "rtpu_actor_checkpoints_total",
    "Actor state snapshots captured by this worker (periodic per "
    "actor_checkpoint_interval_calls, or on demand via "
    "ray_tpu.actor_checkpoint()) and persisted in the control plane")
M_ACTOR_RESTORES = telemetry.define(
    "counter", "rtpu_actor_restores_total",
    "Restarted actors whose state was replayed from their latest "
    "checkpoint (restore_checkpoint ran before any queued call) "
    "instead of starting empty from __init__")


def _set_visible_devices(ids: Optional[List[int]]) -> None:
    """Point CUDA_VISIBLE_DEVICES at GPU slots `ids` (no slots: no card)
    before a task body runs; slot i is the node's i-th visible device.
    The node spawned this worker for these slots and hands it no others
    (``node._worker_key``): torch reads the variable once, at CUDA's first
    use."""
    node_devs = os.environ.get("RTPU_NODE_CUDA_DEVICES", "")
    devs = node_devs.split(",") if node_devs else None
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(
        devs[i] if devs else str(i) for i in ids or ())


def _set_cpu_threads(resources: Dict[str, float]) -> None:
    """Run a task or an actor on as many intra-op threads as it holds CPUs
    (at least one), as Ray sets ``OMP_NUM_THREADS`` from ``num_cpus``:
    torch's default of one thread per core spins every core for small
    ops, and a few such workers on a busy host crowd each other out.
    torch reads the variable when it starts; one already started is set
    directly."""
    n = max(1, int(resources.get("CPU", 0)))
    os.environ["OMP_NUM_THREADS"] = str(n)
    torch = sys.modules.get("torch")
    if torch is not None:
        torch.set_num_threads(n)


@fieldsan.guarded
class WorkerRuntime:
    def __init__(self, socket_path: str, node_id: NodeID,
                 worker_id: WorkerID):
        self.node_id = node_id
        self.worker_id = worker_id
        self.conn = P.connect_unix(socket_path)
        self.client = CoreClient(self.conn, JobID.nil(), worker_id,
                                 P.KIND_WORKER)
        self.client.node_id = node_id
        context.current_client = self.client
        context.in_worker = True
        self._functions: Dict[bytes, Any] = {}
        self._actor_instance: Any = None
        self._actor_spec: Optional[P.ActorSpec] = None
        self._exec_queue: "SimpleQueue" = SimpleQueue()
        self._cancelled_queued: set = set()
        # True while the exec thread sits in a blocking get(); the
        # reader bounces task leases that arrive in that window (the
        # exec-thread drain at block entry can't see them)
        self._blocked_in_get = False
        self.client.on_worker_block = self._return_leased_tasks
        self.client.on_worker_unblock = self._on_unblock
        # named so `rtpu stack` dumps and profiles identify task code at
        # a glance (and the profiler's runtime-thread filter keeps it)
        self._exec_thread = threading.Thread(target=self._exec_loop,
                                             name="task-exec", daemon=True)
        # TASK_DONE coalescing: a DONE sent while MORE tasks are queued
        # is enqueued lazily (no inline drain) so back-to-back tiny-task
        # completions pack into one frame — the symmetric half of the
        # node's EXECUTE_BATCH. The kicker thread bounds withholding to
        # ~1-2ms: a slow successor task can never sit on a predecessor's
        # result (any direct send on the conn also flushes it earlier).
        self._kick_ev = threading.Event()
        self._kicker: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._aio_loop: Optional[asyncio.AbstractEventLoop] = None
        self._current_task_thread: Optional[int] = None
        # checkpointable-actor bookkeeping: atomic snapshot-sequence
        # allocator (itertools.count — concurrent on-demand checkpoints
        # from a threaded actor get distinct seqs without a lock;
        # re-seeded past the restored checkpoint so a restart never
        # allocates behind the plane) and completed calls since the
        # last capture (the periodic trigger)
        self._ckpt_counter = itertools.count(1)
        self._ckpt_calls = 0
        self._ckpt_last_t = time.monotonic()

    # ------------------------------------------------------------ main loop
    def run(self) -> None:
        signal.signal(signal.SIGINT, self._on_sigint)
        self.conn.send((P.REGISTER, (P.KIND_WORKER,
                                     self.worker_id.binary(), os.getpid())))
        self._exec_thread.start()
        while True:
            # burst receive: leases the node's writer coalesced enqueue
            # in one wakeup (the exec thread drains them back-to-back)
            msgs = self.conn.recv_many()
            if msgs is None:
                os._exit(0)
            for op, payload in msgs:
                if op == P.EXECUTE_TASK:
                    if not self._maybe_bounce(payload):
                        self._enqueue_execute(payload)
                elif op == P.EXECUTE_BATCH:
                    # the batch frame amortizes the node->worker side;
                    # each task's DONE still leaves per task (withholding
                    # an early result until a batch's last task finished
                    # would stall callers behind a slow successor) —
                    # transport write-coalescing batches the frames
                    for item in payload:
                        if not self._maybe_bounce(item):
                            self._enqueue_execute(item)
                elif op == P.CANCEL_QUEUED:
                    self._cancelled_queued.add(payload)
                elif op == P.SHUTDOWN:
                    # drain queued outbound frames (a TASK_DONE may still
                    # sit in the writer queue) before dying
                    self.conn.close()
                    os._exit(0)
                else:
                    self.client.handle_message(op, payload)

    def _maybe_bounce(self, payload) -> bool:
        """Reader-side: a plain-task lease arriving while the exec
        thread is blocked in get() would park until it unblocks; hand
        it straight back instead (it never enters the queue, so it can
        never also run here). The bounce echoes the grant's lease seq
        so the node can match it to the exact grant (a bounce landing
        after the grant was superseded is dropped as stale)."""
        if not self._blocked_in_get or payload[0] != "task" \
                or self._actor_spec is not None:
            return False
        self.conn.send((P.RETURN_LEASED, [(payload[1].task_id, payload[4])]))
        return True

    def _on_unblock(self) -> None:
        self._blocked_in_get = False

    def _return_leased_tasks(self) -> None:
        """Called on the exec thread as its current task enters a
        blocking get(): drain our own queue of unstarted plain tasks
        and hand them back to the node (they may be the children this
        get() waits on — leaving them parked behind us deadlocks
        nested submission). We are the queue's only consumer, so a
        drained task can never also run here: requeueing is
        double-execution-free."""
        if self._actor_instance is not None or self._actor_spec is not None:
            return          # actor queues hold ordered actor calls
        self._blocked_in_get = True
        returned: List = []
        while True:
            try:
                item = self._exec_queue.get_nowait()
            except Empty:
                break
            if item[0] == "task":
                returned.append((item[1].task_id, item[4]))
            else:           # not leaseable work; keep it queued
                self._exec_queue.put(item)
                break
        if returned:
            self.conn.send((P.RETURN_LEASED, returned))

    def _enqueue_execute(self, payload) -> None:
        kind, spec, deps = payload[0], payload[1], payload[2]
        if kind == "actor_call" and spec.request_ctx is not None:
            # arrival stamp for the request's skew-free local queue
            # wait (in-process attribute — never serialized)
            spec._rtpu_recv_t = time.monotonic()
        if kind == "actor_call" and (
                self._pool is not None or self._aio_loop is not None):
            self._dispatch_concurrent(spec, deps)
        else:
            self._exec_queue.put(payload)

    def _on_sigint(self, signum, frame) -> None:
        """Cancellation: raise TaskCancelledError inside the task thread
        (reference analogue: KeyboardInterrupt injection on CancelTask)."""
        tid = self._current_task_thread
        if tid is not None:
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(tid),
                ctypes.py_object(exceptions.TaskCancelledError))

    def _exec_loop(self) -> None:
        try:
            self._exec_loop_inner()
        except BaseException:
            # a dying exec thread must not leave a zombie worker (reader
            # alive, nothing executing): surface and exit so the node
            # reaps the process and retries its tasks
            traceback.print_exc(file=sys.stderr)
            os._exit(1)

    def _exec_loop_inner(self) -> None:
        while True:
            kind, spec, deps, actor_spec, _seq = self._exec_queue.get()
            if spec.task_id in self._cancelled_queued:
                # skipped, not executed: report NO return metas — for a
                # rescued lease the task re-runs elsewhere and owns
                # these return ids; for a user cancel the node already
                # failed the returns itself
                self._cancelled_queued.discard(spec.task_id)
                self.conn.send((P.TASK_DONE,
                                (spec.task_id, [], None, kind, None)))
                continue
            self._current_task_thread = threading.get_ident()
            try:
                self._run_one(kind, spec, deps, actor_spec)
            finally:
                self._current_task_thread = None

    def _ensure_kicker(self) -> None:
        if self._kicker is None:
            t = threading.Thread(target=self._kick_loop,
                                 name="done-kicker", daemon=True)
            self._kicker = t
            t.start()
        self._kick_ev.set()

    def _kick_loop(self) -> None:
        """Flush lazily-queued TASK_DONE frames ~1ms after the first one
        was held — the upper bound on how long a completed task's result
        can wait for batchmates."""
        while True:
            self._kick_ev.wait()
            self._kick_ev.clear()
            time.sleep(0.001)
            try:
                self.conn.kick()
            except OSError:
                return

    def _dispatch_concurrent(self, spec: P.TaskSpec, deps) -> None:
        if self._aio_loop is not None:
            asyncio.run_coroutine_threadsafe(
                self._run_async(spec, deps), self._aio_loop)
        else:
            self._pool.submit(self._run_one, "actor_call", spec, deps, None)

    # ------------------------------------------------------------ execution
    def _run_one(self, kind: str, spec: P.TaskSpec, deps,
                 actor_spec: Optional[P.ActorSpec]) -> None:
        context.current_task_id = spec.task_id
        context.current_task_name = spec.name
        context.current_accel_ids = spec.accel_ids
        _set_visible_devices(spec.accel_ids)
        if kind != "actor_call":
            _set_cpu_threads((actor_spec or spec).resources)
        # inherit the submitting job's namespace so nested named-actor
        # lookups/creations resolve where the driver's would (ContextVar:
        # concurrent calls on a threaded actor don't race each other)
        context.current_namespace.set(
            actor_spec.namespace if actor_spec else spec.namespace)
        # request-scoped baggage: re-bound for the call's duration so
        # the request's nested submissions carry it onward and a serve
        # replica reads its request context without paying an arg slot
        req_token = context.request_ctx.set(spec.request_ctx)
        recv_token = (context.request_recv_t.set(
            getattr(spec, "_rtpu_recv_t", None))
            if spec.request_ctx is not None else None)
        span_cm = self._task_span(kind, spec)
        try:
            with span_cm:
                if kind == "task":
                    fn = self._get_function(spec.function_id)
                    args, kwargs = self._load_args(spec, deps)
                    failpoints.fp("worker.task.begin", name=spec.name)
                    result = fn(*args, **kwargs)
                elif kind == "actor_create":
                    result = self._create_actor(actor_spec, spec, deps)
                else:  # actor_call
                    args, kwargs = self._load_args(spec, deps)
                    failpoints.fp("actor.call.begin",
                                  method=spec.method_name, name=spec.name)
                    method = getattr(self._actor_instance, spec.method_name)
                    result = method(*args, **kwargs)
                    if inspect.iscoroutine(result):
                        # sync actor defining an async method: run it here
                        result = asyncio.new_event_loop(
                        ).run_until_complete(result)
            if kind == "actor_call":
                # BEFORE the result is reported: a completion the
                # caller observed is never newer than the checkpoint a
                # restart would restore (a capture failure fails the
                # call — resuming silently behind would break that)
                self._maybe_checkpoint()
            self._send_done(spec, kind, result, None)
        except BaseException as e:  # noqa: BLE001
            self._send_done(spec, kind, None, e)
        finally:
            context.request_ctx.reset(req_token)
            if recv_token is not None:
                context.request_recv_t.reset(recv_token)
            context.current_task_id = None
            context.current_task_name = None
            # slot may be recycled next; CUDA_VISIBLE_DEVICES stays, as
            # this worker only ever runs on these slots
            context.current_accel_ids = None
            # don't leak this task's trace into spans a later codepath
            # might open on the same pool thread
            from ..util import tracing
            tracing.set_remote_parent(None)

    @staticmethod
    def _task_span(kind: str, spec: P.TaskSpec):
        """Span around execution, parented to the submitter's context
        carried in the spec (no-op context manager when neither this
        process nor the submitter is tracing). A non-None trace_context
        — even an empty one — means the SUBMITTER had tracing on, which
        overrides this node's own config (remote nodes never see the
        driver's _system_config)."""
        from ..util import tracing
        if not (tracing.enabled() or spec.trace_context is not None):
            import contextlib
            return contextlib.nullcontext()
        tracing.set_remote_parent(spec.trace_context or None)
        # literal prefixes (not f"{kind}::"): the span-name registry lint
        # (scripts/check_metrics.py) extracts them statically
        return tracing.start_span(
            ("task::" if kind == "task" else
             "actor_create::" if kind == "actor_create" else
             "actor_call::") + spec.name,
            attributes={"task_id": spec.task_id.hex()}, force=True)

    async def _run_async(self, spec: P.TaskSpec, deps) -> None:
        context.current_namespace.set(spec.namespace)
        req_token = context.request_ctx.set(spec.request_ctx)
        # actor-wide slots: identical for every call of this actor, so
        # the module-global is safe under asyncio interleaving
        context.current_accel_ids = spec.accel_ids
        _set_visible_devices(spec.accel_ids)
        context.current_task_name = spec.name   # best-effort (interleaved)
        # stackless span: concurrent async calls interleave on one loop
        # thread, so the thread-local span stack would mis-nest them
        from ..util import tracing
        span = None
        if tracing.enabled() or spec.trace_context is not None:
            span = tracing.begin_span(
                "actor_call::" + spec.name, spec.trace_context or None,
                attributes={"task_id": spec.task_id.hex()})
        try:
            args, kwargs = self._load_args(spec, deps)
            method = getattr(self._actor_instance, spec.method_name)
            result = method(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = await result
            tracing.end_span(span)
            self._send_done(spec, "actor_call", result, None)
        except BaseException as e:  # noqa: BLE001
            tracing.end_span(span, error=type(e).__name__)
            self._send_done(spec, "actor_call", None, e)
        finally:
            context.request_ctx.reset(req_token)
            # best-effort under interleaving (another call's name may be
            # re-set right after) — but a stale name on an IDLE worker
            # would misattribute every filtered profile sample forever
            context.current_task_name = None

    def _create_actor(self, actor_spec: P.ActorSpec, spec: P.TaskSpec,
                      deps) -> Any:
        cls = ser.loads_function(actor_spec.class_blob)
        args, kwargs = self._load_args(spec, deps)
        self._actor_spec = actor_spec
        context.current_actor_id = actor_spec.actor_id
        if actor_spec.is_async:
            self._aio_loop = asyncio.new_event_loop()
            t = threading.Thread(target=self._aio_loop.run_forever,
                                 daemon=True)
            t.start()
        elif actor_spec.max_concurrency > 1:
            self._pool = ThreadPoolExecutor(
                max_workers=actor_spec.max_concurrency)
        self._actor_instance = cls(*args, **kwargs)
        label = getattr(self._actor_instance, "__rtpu_log_label__", None)
        if label:
            # this process's log lines get a human name in the driver's
            # "(worker ...)" prefix (serve replicas set their
            # deployment#tag, so `rtpu logs` greps by deployment)
            self.conn.send((P.SET_LOG_LABEL, str(label)[:64]))
        self._restore_checkpoint(actor_spec)
        context.actor_checkpoint_hook = self.checkpoint_now
        return None

    # ------------------------------------------ checkpointable actors
    # Opt-in protocol: a class defining ``save_checkpoint(self) ->
    # state`` (and, to resume, ``restore_checkpoint(self, state)``) is
    # checkpointable. Capture is periodic (every
    # ``actor_checkpoint_interval_calls`` completed calls) or on demand
    # (``ray_tpu.actor_checkpoint()`` inside a method); the blob lives
    # in the control plane keyed by actor id, so the SAME id restored
    # after a worker- or node-level restart finds it. Restore runs
    # inside the (re-)creation task — strictly before any queued call
    # drains, so a restarted rank resumes at its last checkpointed
    # step, not from __init__.

    def _restore_checkpoint(self, actor_spec: P.ActorSpec) -> None:
        inst = self._actor_instance
        if not (hasattr(inst, "restore_checkpoint")
                or hasattr(inst, "save_checkpoint")):
            return
        ckpt = self.client.get_actor_checkpoint(actor_spec.actor_id)
        if ckpt is None:
            return                      # first creation: nothing saved
        seq, blob = ckpt
        # resume the sequence even for save-only classes: a restarted
        # incarnation restarting at seq 1 would have every later save
        # rejected by the plane's monotonic guard
        self._ckpt_counter = itertools.count(int(seq) + 1)
        if hasattr(inst, "restore_checkpoint"):
            inst.restore_checkpoint(ser.from_bytes(bytes(blob)))
            telemetry.counter_inc(M_ACTOR_RESTORES)

    def _maybe_checkpoint(self) -> None:
        inst = self._actor_instance
        if inst is None or not hasattr(inst, "save_checkpoint"):
            return
        if self._pool is not None or self._aio_loop is not None:
            # concurrent actors (max_concurrency>1 / async) have no
            # quiescent point between calls: an automatic snapshot here
            # could serialize state another call is mid-mutating (and
            # the async path never reaches this method at all) — such
            # actors checkpoint on demand at points THEY know are safe
            return
        every = CONFIG.actor_checkpoint_interval_calls
        every_s = CONFIG.actor_checkpoint_interval_s
        self._ckpt_calls += 1
        # TIME trigger beside the call-count one, checked at the same
        # quiescent point (a call just completed — for sync actors the
        # only moment a snapshot is guaranteed consistent; an IDLE actor
        # mutates no state, so there is nothing new to capture between
        # calls): a slow-call actor whose calls each outlast the
        # interval checkpoints once per call even when the call-count
        # trigger would never fire
        if (every > 0 and self._ckpt_calls >= every) or \
                (every_s > 0
                 and time.monotonic() - self._ckpt_last_t >= every_s):
            self.checkpoint_now()

    def checkpoint_now(self) -> int:
        """Capture + persist the actor's state; returns the durable
        snapshot's sequence number (the ray_tpu.actor_checkpoint()
        hook). A threaded actor may call this concurrently without
        breaking anything mechanical (seqs are allocated atomically,
        BEFORE the capture, and a rejected save never overwrites a
        newer one) — but the ORDER of two overlapping captures is
        inherently ambiguous: each call guarantees only that a
        snapshot at least as new as its own is durable. An actor that
        needs strict capture ordering must serialize its own
        checkpoint points (which 'checkpoint at points YOU know are
        safe' already implies)."""
        inst = self._actor_instance
        if inst is None or self._actor_spec is None:
            raise RuntimeError("no actor instance in this worker")
        if not hasattr(inst, "save_checkpoint"):
            raise RuntimeError(
                f"actor {type(inst).__name__} defines no "
                "save_checkpoint() — the checkpoint protocol is opt-in")
        aid = self._actor_spec.actor_id
        # seq BEFORE capture: allocation order then matches capture
        # START order, so a capture that began later (and may contain
        # later mutations) can never persist under a LOWER seq
        seq = next(self._ckpt_counter)
        blob = ser.to_bytes(inst.save_checkpoint())
        if not self.client.save_actor_checkpoint(aid, seq, blob):
            cur = self.client.get_actor_checkpoint(aid)
            seq = int(cur[0]) if cur is not None else 0
            # re-seed so the NEXT capture strictly supersedes whatever
            # is there (benign if a concurrent caller re-seeds too)
            self._ckpt_counter = itertools.count(seq + 1)
        self._ckpt_calls = 0
        self._ckpt_last_t = time.monotonic()
        telemetry.counter_inc(M_ACTOR_CKPTS)
        return seq

    def _get_function(self, function_id: bytes):
        fn = self._functions.get(function_id)
        if fn is None:
            blob = self.client.fetch_function(function_id)
            if blob is None:
                raise RuntimeError(
                    f"function {function_id.hex()[:12]} not found in KV")
            fn = ser.loads_function(blob)
            self._functions[function_id] = fn
        return fn

    def _load_args(self, spec: P.TaskSpec, deps: Dict[ObjectID, ObjectMeta]):
        args = [self._load_one(slot, deps) for slot in spec.args]
        kwargs = {k: self._load_one(slot, deps)
                  for k, slot in spec.kwargs.items()}
        # refs nested in the arguments became this worker's borrows as they
        # were unpickled: send them before the body runs, so the node knows
        # what the running task holds (the OOM autopsy names it) without
        # waiting for the background flush
        self.client.flush_refs()
        return args, kwargs

    def _load_one(self, slot, deps):
        tag, val = slot
        if tag == "v":
            return ser.from_bytes(val)
        meta = deps.get(val)
        if meta is None:
            # dependency not pre-resolved (nested ref): fetch via client
            from .object_ref import ObjectRef
            return self.client.get([ObjectRef(val)])[0]
        return self.client.reader.load(meta)

    # -------------------------------------------------------------- returns
    def _send_done(self, spec: P.TaskSpec, kind: str, result: Any,
                   exc: Optional[BaseException]) -> None:
        if spec.num_returns == -1 and exc is None:
            self._stream_returns(spec, kind, result)
            return
        metas: List[ObjectMeta] = []
        err_bytes: Optional[bytes] = None
        if exc is not None:
            if isinstance(exc, (exceptions.TaskCancelledError,
                                exceptions.RayTpuError)):
                wrapped: BaseException = exc
            else:
                wrapped = exceptions.TaskError(
                    type(exc).__name__, str(exc),
                    "".join(traceback.format_exception(
                        type(exc), exc, exc.__traceback__)),
                    task_name=spec.name)
            err_bytes = ser.to_bytes(wrapped)
            for oid in spec.return_ids:
                metas.append(ObjectMeta(object_id=oid, size=len(err_bytes),
                                        error=err_bytes))
        else:
            values: List[Any]
            if spec.num_returns == 1:
                values = [result]
            elif spec.num_returns == 0:
                values = []
            else:
                values = list(result)
                if len(values) != spec.num_returns:
                    self._send_done(spec, kind, None, ValueError(
                        f"task {spec.name} declared num_returns="
                        f"{spec.num_returns} but returned {len(values)}"))
                    return
            for oid, value in zip(spec.return_ids, values):
                metas.append(self._store_return(oid, value))
        # borrows registered during execution must land BEFORE the
        # node unpins this task's args (same conn => ordered frames);
        # buffered nested submissions likewise precede our DONE
        self.client.flush_submissions()
        self.client.flush_refs()
        # a STREAMING task that failed before iteration started (arg
        # load, actor method raising before returning a generator) must
        # still end its stream — gen_count=0 + the error — or consumers
        # parked on item 0 hang forever
        gen_count = 0 if spec.num_returns == -1 else None
        done = (P.TASK_DONE,
                (spec.task_id, metas, err_bytes, kind, gen_count))
        if kind != "actor_create" and not self._exec_queue.empty():
            # more work is already queued: coalesce this DONE with the
            # next completions (kicker bounds the hold to ~1-2ms)
            self.conn.send_lazy(done)
            self._ensure_kicker()
        else:
            self.conn.send(done)
        # unconditional: force-traced spans exist even when THIS node's
        # config has tracing off (flush is a no-op on an empty buffer)
        from ..util import tracing
        tracing.flush()
        # telemetry deltas recorded during the task (collective ops,
        # serve replicas, data blocks, user metrics) ship at task
        # boundaries — rate-limited so a storm of tiny recording tasks
        # pays at most ~5 control-plane frames/s, not one per task; the
        # background flusher covers the tail
        from . import telemetry
        telemetry.maybe_flush()

    def _stream_returns(self, spec: P.TaskSpec, kind: str,
                        result: Any) -> None:
        """Drive a streaming (num_returns=\"streaming\") task: store and
        report each yielded item as it is produced, pacing against the
        consumer with a bounded in-flight window (reference:
        ReportGeneratorItemReturns, ``core_worker.proto:396``)."""
        window = CONFIG.generator_backpressure_window
        produced = 0
        self.client.gen_credit_init(spec.task_id)
        err: Optional[BaseException] = None
        try:
            it = iter(result)
        except TypeError:
            err = exceptions.TaskError(
                "TypeError",
                f"streaming task {spec.name} must return an iterable/"
                f"generator, got {type(result).__name__}", "",
                task_name=spec.name)
            it = iter(())
        while err is None:
            try:
                item = next(it)
            except StopIteration:
                break
            except BaseException as e:  # noqa: BLE001 — reported to owner
                err = e if isinstance(e, exceptions.RayTpuError) else \
                    exceptions.TaskError(
                        type(e).__name__, str(e),
                        "".join(traceback.format_exception(
                            type(e), e, e.__traceback__)),
                        task_name=spec.name)
                break
            oid = ObjectID.for_gen_item(spec.task_id, produced)
            meta = self._store_return(oid, item)
            self.conn.send((P.GEN_ITEM, (spec.task_id, produced, meta)))
            produced += 1
            self.client.gen_wait_credit(spec.task_id, produced, window)
        self.client.gen_credit_drop(spec.task_id)
        err_bytes = ser.to_bytes(err) if err is not None else None
        self.client.flush_submissions()
        self.client.flush_refs()
        self.conn.send((P.TASK_DONE,
                        (spec.task_id, [], err_bytes, kind, produced)))
        from ..util import tracing
        tracing.flush()
        from . import telemetry
        telemetry.maybe_flush()

    def _store_return(self, oid: ObjectID, value: Any) -> ObjectMeta:
        from .object_ref import begin_ref_capture, end_ref_capture
        begin_ref_capture()
        try:
            smeta, views = ser.serialize(value)
        finally:
            contained = end_ref_capture()
        if contained:
            # refs living only inside this return would lose their last
            # holder when our locals die; the node pins them until the
            # return object itself is freed. Sent BEFORE this return's
            # TASK_DONE/GEN_ITEM (same conn => ordered).
            self.conn.send((P.RETURN_REFS, (oid, contained)))
        total = ser.serialized_size(smeta, views)
        if total <= CONFIG.object_store_shm_threshold_bytes:
            out = bytearray(total)
            ser.write_to(memoryview(out), smeta, views)
            return ObjectMeta(object_id=oid, size=total, inline=bytes(out))
        # arena Create/Seal through the local node store when available
        return self.client.store_large(oid, smeta, views, total)


def main() -> None:
    socket_path, node_hex, worker_hex = sys.argv[1], sys.argv[2], sys.argv[3]
    rt = WorkerRuntime(socket_path, NodeID.from_hex(node_hex),
                       WorkerID.from_hex(worker_hex))
    rt.run()


if __name__ == "__main__":
    main()
