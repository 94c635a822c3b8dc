"""Request/reply plumbing over a framed Connection.

Equivalent role to the reference's gRPC client stubs
(``src/ray/rpc/grpc_client.h``): correlate req_ids with futures, own a
reader thread, and hand non-reply frames to a push handler. Used by the
remote GCS client and node→node peer channels; the CoreClient keeps its
own (older) copy of this pattern.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, Tuple

from . import locksan
from . import protocol as P


class RpcChannel:
    """Thread-safe request/reply over one Connection.

    Replies are any ``(op, (req_id, value))`` frame whose op is in
    ``reply_ops``; everything else goes to ``on_push(op, payload)``.
    """

    def __init__(self, conn: P.Connection,
                 on_push: Optional[Callable[[int, Any], None]] = None,
                 on_close: Optional[Callable[[], None]] = None,
                 reply_ops: Tuple[int, ...] = (P.INFO_REPLY,)):
        self._conn = conn
        self._on_push = on_push
        self._on_close = on_close
        self._reply_ops = set(reply_ops)
        self._futures: Dict[int, Future] = {}
        self._lock = locksan.lock("rpc.futures")
        self._next_req = 1
        self._closed = threading.Event()
        conn.on_send_error = self._on_send_error
        self._thread = threading.Thread(target=self._read_loop,
                                        name="rtpu-rpc-reader", daemon=True)
        self._thread.start()

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def _read_loop(self) -> None:
        while True:
            # burst receive: one socket wakeup dispatches every frame
            # the peer's writer coalesced (replies resolve their futures
            # back-to-back instead of one wakeup each)
            msgs = self._conn.recv_many()
            if msgs is None:
                self._fail_all(ConnectionError("rpc channel closed"))
                if self._on_close is not None:
                    try:
                        self._on_close()
                    except Exception:
                        pass
                return
            for msg in msgs:
                self._dispatch_one(msg)

    def _dispatch_one(self, msg: Tuple[int, Any]) -> None:
        op, payload = msg
        if op in self._reply_ops:
            req_id, value = payload
            with self._lock:
                fut = self._futures.pop(req_id, None)
            if fut is not None:
                fut.set_result(value)
        elif op == P.ERROR_REPLY:
            req_id, err = payload
            with self._lock:
                fut = self._futures.pop(req_id, None)
            if fut is not None:
                from . import serialization as ser
                fut.set_exception(ser.from_bytes(err))
        elif self._on_push is not None:
            try:
                self._on_push(op, payload)
            except Exception:
                pass

    def _on_send_error(self, msg, exc: BaseException) -> None:
        P.fail_dropped_request(msg, exc, self._lock, self._futures)

    def _fail_all(self, exc: Exception) -> None:
        with self._lock:
            self._closed.set()
            futures = list(self._futures.values())
            self._futures.clear()
        for fut in futures:
            if not fut.done():
                fut.set_exception(exc)

    def request(self, op: int, make_payload: Callable[[int], Any],
                timeout: Optional[float] = None) -> Any:
        """Synchronous call: sends ``(op, make_payload(req_id))``, waits
        for the correlated reply."""
        return self.request_async(op, make_payload).result(timeout=timeout)

    def request_async(self, op: int,
                      make_payload: Callable[[int], Any]) -> Future:
        """Send now, await later — several requests can ride the channel
        concurrently (windowed chunk pulls overlap RTTs this way)."""
        fut: Future = Future()
        with self._lock:
            if self._closed.is_set():
                raise ConnectionError("rpc channel is closed")
            req_id = self._next_req
            self._next_req += 1
            self._futures[req_id] = fut
        self._conn.send((op, make_payload(req_id)))
        return fut

    def send(self, op: int, payload: Any) -> None:
        """Fire-and-forget."""
        self._conn.send((op, payload))

    def close(self) -> None:
        self._closed.set()
        self._conn.close()
