# A copy of tests/test_tracing_events.py on ray_tpu_torch's runtime: the same
# tests under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown.
"""Tracing + structured cluster-event tests (reference analogues:
``python/ray/tests/test_tracing.py`` and the event framework,
``src/ray/util/event.h``)."""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.state import api as state_api
from ray_tpu_torch.util import tracing
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


@pytest.fixture
def traced_init():
    ray_tpu_torch.init(num_cpus=2, _system_config={"tracing_enabled": True})
    yield
    ray_tpu_torch.shutdown()
    tracing.drain()                    # don't leak spans across tests


@ray_tpu_torch.remote
def child_task(x):
    return x + 1


@ray_tpu_torch.remote
def parent_task(x):
    # nested submission: the worker's span context must propagate into
    # the child task's span
    return ray_tpu_torch.get(child_task.remote(x)) * 10


def _spans_by_name(*required, timeout=15.0):
    """Poll until every span name in ``required`` has arrived (workers
    flush asynchronously after TASK_DONE)."""
    by_name = {}
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        spans = state_api.list_spans()
        by_name = {s["name"]: s for s in spans}
        if all(name in by_name for name in required):
            break
        time.sleep(0.2)
    return by_name, list(by_name.values())


def test_task_spans_recorded_with_driver_parent(traced_init):
    with tracing.start_span("driver-op") as root:
        out = ray_tpu_torch.get(child_task.remote(1), timeout=60)
    assert out == 2
    tracing.flush()
    by_name, spans = _spans_by_name("task::child_task")
    task_span = by_name.get("task::child_task")
    assert task_span is not None, spans
    assert task_span["trace_id"] == root["trace_id"]
    assert task_span["parent_id"] == root["span_id"]
    assert task_span["status"] == "OK"
    assert task_span["end_time"] >= task_span["start_time"]


def test_nested_task_span_chain(traced_init):
    with tracing.start_span("root") as root:
        assert ray_tpu_torch.get(parent_task.remote(4), timeout=60) == 50
    tracing.flush()
    by_name, _ = _spans_by_name("task::child_task", "task::parent_task")
    parent = by_name["task::parent_task"]
    child = by_name["task::child_task"]
    assert parent["trace_id"] == root["trace_id"]
    assert child["trace_id"] == root["trace_id"]
    assert child["parent_id"] == parent["span_id"]


def test_error_span_status(traced_init):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("nope")

    with pytest.raises(Exception):
        ray_tpu_torch.get(boom.remote(), timeout=60)
    # test-local function: its qualname (and so the span name) carries a
    # <locals> prefix — match by suffix
    span = None
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and span is None:
        for s in state_api.list_spans():
            if s["name"].endswith("boom"):
                span = s
        time.sleep(0.2)
    assert span is not None and span["status"].startswith("ERROR")


def test_tracing_disabled_is_noop(rtpu_init):
    with tracing.start_span("ignored") as span:
        assert span is None
    assert ray_tpu_torch.get(child_task.remote(1), timeout=60) == 2
    assert state_api.list_spans() == []


def test_trace_timeline_export(traced_init, tmp_path):
    ray_tpu_torch.get(child_task.remote(1), timeout=60)
    time.sleep(1.0)
    out = str(tmp_path / "trace.json")
    state_api.trace_timeline(out)
    import json
    events = json.load(open(out))
    assert any(e["name"] == "task::child_task" for e in events)


def test_local_requeue_clamps_buffer():
    """Re-queuing drained spans (no client to flush to) must clamp to
    _MAX_BUFFER, dropping the oldest overflow — repeated failed flushes
    must not grow the buffer without bound."""
    tracing.drain()
    try:
        spans = [{"name": str(i)}
                 for i in range(tracing._MAX_BUFFER + 500)]
        tracing._local_requeue(spans)
        assert len(tracing._buffer) == tracing._MAX_BUFFER
        # newest spans survive; the oldest 500 were dropped
        assert tracing._buffer[-1]["name"] == str(
            tracing._MAX_BUFFER + 499)
        assert tracing._buffer[0]["name"] == "500"
    finally:
        tracing.drain()


def test_repeated_failed_flush_stays_bounded(monkeypatch):
    from ray_tpu_torch._private import context as ctx

    monkeypatch.setattr(ctx, "current_client", None)   # no transport
    monkeypatch.setattr(tracing, "_MAX_BUFFER", 100)
    tracing.drain()
    try:
        for i in range(80):
            tracing._record({"name": f"s{i}"})
        for _ in range(20):
            tracing.flush()        # drain -> no client -> requeue
            tracing._record({"name": "extra"})
        assert len(tracing._buffer) == 100
    finally:
        tracing.drain()


def test_cluster_events_node_start_and_actor_death(rtpu_init):
    events = state_api.list_cluster_events()
    assert any(e["label"] == "NODE_START" for e in events)

    @ray_tpu_torch.remote
    class Doomed:
        def die(self):
            os._exit(1)

    d = Doomed.remote()
    with pytest.raises(Exception):
        ray_tpu_torch.get(d.die.remote(), timeout=60)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        events = state_api.list_cluster_events()
        if any(e["label"] == "ACTOR_DEATH" for e in events):
            break
        time.sleep(0.2)
    death = [e for e in events if e["label"] == "ACTOR_DEATH"]
    assert death and death[-1]["severity"] == "ERROR"
    # the JSONL file exists on disk too
    sess = ray_tpu_torch._session_dir
    files = os.listdir(os.path.join(sess, "events"))
    assert any(f.startswith("events_") for f in files)


def test_oom_kill_emits_event(tmp_path):
    ray_tpu_torch.init(num_cpus=2,
                       _system_config={"memory_monitor_refresh_ms": 200,
                                       "task_oom_retries_default": 1})
    try:
        @ray_tpu_torch.remote
        def sleepy():
            time.sleep(60)

        ref = sleepy.remote()   # noqa: F841 — kept in flight
        time.sleep(1.0)
        os.environ["RTPU_TEST_MEMORY_USAGE_FRACTION"] = "0.99"
        deadline = time.monotonic() + 20
        found = False
        while time.monotonic() < deadline and not found:
            found = any(e["label"] == "OOM_KILL"
                        for e in state_api.list_cluster_events())
            time.sleep(0.2)
        assert found
    finally:
        os.environ.pop("RTPU_TEST_MEMORY_USAGE_FRACTION", None)
        ray_tpu_torch.shutdown()


def test_remote_node_traces_without_local_config(tmp_path):
    """A process-isolated node never sees the driver's _system_config;
    the trace context in the spec alone must make its workers trace."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True, process_isolated=True,
                      head_node_args={"num_cpus": 2})
    try:
        ray_tpu_torch.init(address=cluster,
                           _system_config={"tracing_enabled": True})
        with tracing.start_span("driver-root") as root:
            out = ray_tpu_torch.get(child_task.remote(5), timeout=60)
        assert out == 6
        tracing.flush()
        by_name, spans = _spans_by_name("task::child_task")
        span = by_name.get("task::child_task")
        assert span is not None, spans
        assert span["trace_id"] == root["trace_id"]
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        tracing.drain()
