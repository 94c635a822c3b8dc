# A copy of tests/test_transport.py on ray_tpu_torch's runtime: the same tests
# under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown. Docstrings leave
# out the JAX package's issue history.
"""Frame-codec and transport tests for the batched, zero-copy wire
layer (``_private/protocol.py`` Connection).

Covers the codec contract: multi-frame burst decode, pickle-5
out-of-band buffer roundtrips (bytes / bytearray / numpy), interleaved
large+small frames, concurrent multi-thread send stress, bounded-queue
backpressure, and clean EOF behaviour mid-stream.
"""

from __future__ import annotations

import pickle
import socket
import threading
import time

import numpy as np
import pytest

from ray_tpu_torch._private import protocol as P
from ray_tpu_torch._private.config import CONFIG
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


def _pair():
    a, b = socket.socketpair()
    return P.Connection(a), P.Connection(b)


@pytest.fixture
def conn_pair():
    a, b = _pair()
    yield a, b
    a.close()
    b.close()


def test_roundtrip_small(conn_pair):
    a, b = conn_pair
    a.send((P.KV_PUT, (b"key", b"value", True)))
    assert b.recv() == (P.KV_PUT, (b"key", b"value", True))


def test_send_many_multi_frame_decode(conn_pair):
    """A burst enqueued before the writer wakes leaves as one coalesced
    BATCH frame; the receiver's multi-frame decoder hands the whole
    burst back in order (and transparently — no BATCH op visible)."""
    a, b = conn_pair
    msgs = [(P.TASK_DONE, (i, [], None, "task", None)) for i in range(50)]
    a.send_many(msgs)
    got = []
    while len(got) < 50:
        burst = b.recv_many()
        assert burst is not None
        got.extend(burst)
    assert got == msgs


def test_recv_many_returns_burst(conn_pair):
    a, b = conn_pair
    a.send_many([(P.REF_BATCH, i) for i in range(10)])
    a.flush()
    time.sleep(0.05)                 # let the frames land in b's buffer
    burst = b.recv_many()
    assert burst[0] == (P.REF_BATCH, 0)
    total = list(burst)
    while len(total) < 10:
        total.extend(b.recv_many())
    assert [m[1] for m in total] == list(range(10))


@pytest.mark.parametrize("payload_factory", [
    lambda: pickle.PickleBuffer(b"\xab" * 300_000),
    lambda: pickle.PickleBuffer(bytearray(b"\xcd" * 300_000)),
    lambda: np.arange(300_000, dtype=np.uint8),
], ids=["bytes", "bytearray", "numpy"])
def test_oob_roundtrip(conn_pair, payload_factory):
    """Buffers over the out-of-band threshold ride as iovecs and
    reconstruct intact (memoryview for raw PickleBuffers, zero-copy
    ndarray for numpy)."""
    a, b = conn_pair
    payload = payload_factory()
    a.send((P.PUT_OBJECT, ("tag", payload)))
    op, (tag, got) = b.recv()
    assert op == P.PUT_OBJECT and tag == "tag"
    if isinstance(payload, pickle.PickleBuffer):
        expected = bytes(payload.raw())
        assert bytes(got) == expected
    else:
        got = np.asarray(got)
        assert got.dtype == payload.dtype
        assert np.array_equal(got, payload)
        # reconstructed over the provided buffer, not a private copy
        assert not got.flags["OWNDATA"]


def test_oob_below_threshold_stays_inband(conn_pair):
    a, b = conn_pair
    small = pickle.PickleBuffer(b"tiny" * 10)     # far below threshold
    a.send((P.PUT_OBJECT, small))
    op, got = b.recv()
    assert bytes(got) == b"tiny" * 10


def test_encode_frame_emits_oob_iovecs():
    """White-box: a large numpy payload produces out-of-band chunks
    (header+lens, pickle stream, raw buffer) rather than one blob."""
    a, b = _pair()
    try:
        chunks: list = []
        arr = np.ones(1 << 20, dtype=np.uint8)
        oob = a._encode_frame((P.PUT_OBJECT, arr), chunks)
        assert oob == arr.nbytes
        assert len(chunks) == 3
        assert chunks[-1].nbytes == arr.nbytes
    finally:
        a.close()
        b.close()


def test_interleaved_large_and_small(conn_pair):
    """16MB of interleaved large+small frames — more than both socket
    buffers combined, so the peer must drain concurrently (a blocking
    send under backpressure is the contract, same as the seed's
    ``sendall``)."""
    a, b = conn_pair
    seq = []
    for i in range(8):
        seq.append((P.PUT_OBJECT, np.full(1 << 20, i, dtype=np.uint8)))
        seq.append((P.KV_PUT, (b"k%d" % i, i)))
    got = []

    def reader():
        while len(got) < len(seq):
            burst = b.recv_many()
            if burst is None:
                return
            got.extend(burst)

    rt = threading.Thread(target=reader, daemon=True)
    rt.start()
    for msg in seq:
        a.send(msg)
    rt.join(timeout=30)
    assert len(got) == len(seq)
    for sent, (op, payload) in zip(seq, got):
        assert op == sent[0]
        if op == P.PUT_OBJECT:
            assert np.array_equal(np.asarray(payload), sent[1])
        else:
            assert payload == sent[1]


def test_large_frame_dedicated_receive(conn_pair):
    """A frame bigger than the shared recv buffer threshold takes the
    recv_into fast path and still decodes whole."""
    a, b = conn_pair
    blob = b"z" * (3 << 20)
    a.send((P.PUT_OBJECT_WIRE, (1, b"oid", pickle.PickleBuffer(blob))))
    op, (rid, oid, got) = b.recv()
    assert op == P.PUT_OBJECT_WIRE and rid == 1
    assert len(got) == len(blob) and bytes(got[:4]) == b"zzzz"


def test_concurrent_8_thread_send_stress(conn_pair):
    """8 producer threads share one connection; every message arrives,
    per-thread order preserved (the writer must never interleave or
    drop under contention)."""
    a, b = conn_pair
    n_threads, per_thread = 8, 400
    received = []
    done = threading.Event()

    def reader():
        while len(received) < n_threads * per_thread:
            burst = b.recv_many()
            if burst is None:
                break
            received.extend(burst)
        done.set()

    rt = threading.Thread(target=reader, daemon=True)
    rt.start()

    def producer(tid):
        for i in range(per_thread):
            a.send((P.REF_BATCH, (tid, i)))

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert done.wait(timeout=30), \
        f"only {len(received)}/{n_threads * per_thread} messages arrived"
    last = {}
    for op, (tid, i) in received:
        assert op == P.REF_BATCH
        assert i == last.get(tid, -1) + 1, f"thread {tid} out of order"
        last[tid] = i
    assert all(last[t] == per_thread - 1 for t in range(n_threads))


def test_bounded_queue_backpressure():
    """A tiny queue depth must throttle producers without deadlocking
    or dropping frames."""
    old = CONFIG._values["transport_queue_depth"]
    CONFIG._values["transport_queue_depth"] = 4
    try:
        a, b = _pair()
    finally:
        CONFIG._values["transport_queue_depth"] = old
    try:
        got = []

        def reader():
            while len(got) < 500:
                burst = b.recv_many()
                if burst is None:
                    return
                got.extend(burst)
                time.sleep(0.001)     # slow consumer

        rt = threading.Thread(target=reader, daemon=True)
        rt.start()
        for i in range(500):
            a.send((P.REF_BATCH, i))
        rt.join(timeout=30)
        assert [m[1] for m in got] == list(range(500))
    finally:
        a.close()
        b.close()


def test_clean_eof_mid_batch():
    """EOF with a partial frame buffered returns None (clean close), it
    does not raise or hand out a truncated message."""
    raw_a, raw_b = socket.socketpair()
    b = P.Connection(raw_b)
    try:
        body = pickle.dumps((P.KV_DEL, b"k"), protocol=5)
        frame = P._HDR.pack(1 + len(body), 0) + body
        raw_a.sendall(frame)            # one whole frame...
        raw_a.sendall(frame[:7])        # ...then a truncated one
        raw_a.close()
        assert b.recv() == (P.KV_DEL, b"k")
        assert b.recv() is None
        assert b.recv_many() is None
    finally:
        b.close()


def test_eof_immediately():
    raw_a, raw_b = socket.socketpair()
    b = P.Connection(raw_b)
    raw_a.close()
    try:
        assert b.recv() is None
    finally:
        b.close()


def test_send_after_close_raises(conn_pair):
    a, b = conn_pair
    a.send((P.KV_DEL, b"x"))
    a.close()
    with pytest.raises(OSError):
        a.send((P.KV_DEL, b"y"))


def test_close_flushes_pending(conn_pair):
    """Messages queued before close() still reach the peer — close
    drains the writer before shutting the socket down."""
    a, b = conn_pair
    msgs = [(P.REF_BATCH, i) for i in range(200)]
    a.send_many(msgs)
    a.close()
    got = []
    while True:
        burst = b.recv_many()
        if burst is None:
            break
        got.extend(burst)
    assert got == msgs


def test_unpicklable_send_raises_and_connection_survives(conn_pair):
    """An uncontended send of an unpicklable payload must raise at the
    call site (a silently dropped frame would hang a request-reply
    future forever) and must NOT poison the connection."""
    a, b = conn_pair
    with pytest.raises(Exception):
        a.send((P.KV_PUT, (b"k", threading.Lock())))
    a.send((P.KV_PUT, (b"k", b"v", False)))
    assert b.recv() == (P.KV_PUT, (b"k", b"v", False))


def test_on_send_error_fires_for_dropped_batch_message(conn_pair):
    """An unpicklable message dropped on the drainer/batch path must
    invoke on_send_error (channels hook this to fail pending futures)
    while its picklable batchmates still go through."""
    a, b = conn_pair
    dropped = []
    a.on_send_error = lambda msg, exc: dropped.append((msg, exc))
    lock = threading.Lock()
    a.send_many([
        (P.KV_PUT, (b"k1", b"v1", False)),
        (P.KV_PUT, (1234, lock)),           # unpicklable
        (P.KV_PUT, (b"k2", b"v2", False)),
    ])
    a.flush()
    got = [b.recv(), b.recv()]
    assert got == [(P.KV_PUT, (b"k1", b"v1", False)),
                   (P.KV_PUT, (b"k2", b"v2", False))]
    assert len(dropped) == 1
    assert dropped[0][0][1][1] is lock


def test_close_bounded_on_wedged_peer(monkeypatch):
    """close() must not hang when the peer stopped reading and the
    socket buffer is full of queued frames."""
    monkeypatch.setattr(P, "_CLOSE_DRAIN_TIMEOUT", 0.5)
    x, y = socket.socketpair()
    a = P.Connection(x)
    blob = b"z" * (1 << 20)
    def _wedge():
        try:
            a.send_many([(P.KV_PUT, (b"k", blob, False))] * 64)
        except OSError:
            pass    # expected: close() errors out the stuck drainer

    t = threading.Thread(target=_wedge, daemon=True)
    t.start()          # wedges in sendmsg once both socket buffers fill
    time.sleep(0.3)
    start = time.monotonic()
    a.close()
    assert time.monotonic() - start < 5.0, "close() hung on wedged peer"
    y.close()
