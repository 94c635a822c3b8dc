# A copy of tests/test_debugging.py on ray_tpu_torch's runtime: the same tests
# under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown. Docstrings leave
# out the JAX package's issue history.
"""Distributed debugging & profiling tests: `rtpu stack` fan-out
(including a worker deliberately blocked in get()), the stall detector's
diagnosed causes, the sampling profiler, `rtpu doctor`, and the CLI
surfaces. Reference analogues: ``ray stack``, GCS task-event stall
warnings, ``ray_tpu_torch.state`` profiling hooks."""

import json
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import debugging
from ray_tpu_torch._private.gcs import aggregate_stacks
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch.state import api as sapi
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


@pytest.fixture
def two_node_cluster():
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2})
    cluster.add_node(num_cpus=2)
    ray_tpu_torch.init(address=cluster)
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


def _poll(predicate, timeout=20.0, interval=0.2):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = predicate()
        if out:
            return out
        time.sleep(interval)
    return predicate()


# ------------------------------------------------------------ rtpu stack

def test_cluster_stacks_all_workers_and_blocked_get(two_node_cluster):
    @ray_tpu_torch.remote
    def slow_child():
        time.sleep(5)
        return 1

    @ray_tpu_torch.remote
    def block_in_get(refs):
        # refs wrapped in a list so the ref itself (not its value)
        # reaches the task, which then blocks in get()
        return ray_tpu_torch.get(refs[0])

    child = slow_child.remote()
    blocked = block_in_get.remote([child])
    assert _poll(lambda: any(
        t["name"].endswith("block_in_get") and t["state"] == "RUNNING"
        for t in sapi.list_tasks()))

    # registered workers snapshotted BEFORE collection: each must reply
    workers = [w for w in sapi.list_workers()
               if w["state"] in ("IDLE", "BUSY", "ACTOR")]
    assert workers

    def _stacks_with_blocked_frame():
        # RUNNING is recorded at dispatch; on a cold box the worker may
        # still be importing — poll the collection itself rather than
        # racing it with a fixed sleep
        r = sapi.cluster_stacks(timeout_s=5.0)
        frames = [fr for ds in r["nodes"].values() for d in ds
                  for t in d["threads"] for fr in t["frames"]]
        return r if any("block_in_get" in fr for fr in frames) else None

    result = _poll(_stacks_with_blocked_frame, timeout=15.0)
    assert result is not None

    assert len(result["nodes"]) == 2           # both nodes reported
    dumps = [d for dumps in result["nodes"].values() for d in dumps]
    kinds = {d["kind"] for d in dumps}
    assert {"node", "worker", "driver"} <= kinds
    dumped_workers = {d["worker_id"] for d in dumps
                      if d["kind"] == "worker"}
    assert dumped_workers >= {w["worker_id"] for w in workers}

    # control-plane dedup: identical stacks collapse into groups,
    # most-common first
    groups = result["groups"]
    assert groups and groups[0]["count"] >= groups[-1]["count"]
    assert sum(g["count"] for g in groups) == sum(
        len(d["threads"]) for d in dumps)
    # no final get(): teardown kills the workers; waiting out the
    # sleeping child would only burn suite budget
    del blocked


def test_aggregate_stacks_dedups_identical():
    per_node = {"n1": [
        {"kind": "worker", "pid": 1, "worker_id": "w1", "threads": [
            {"thread_name": "a", "frames": ["f (x.py:1)", "g (x.py:2)"]},
            {"thread_name": "b", "frames": ["f (x.py:1)", "g (x.py:2)"]},
            {"thread_name": "c", "frames": ["other (y.py:9)"]},
        ]}]}
    groups = aggregate_stacks(per_node)
    assert len(groups) == 2
    assert groups[0]["count"] == 2
    assert {t["thread"] for t in groups[0]["threads"]} == {"a", "b"}


# --------------------------------------------------------- stall detector

def test_stall_detector_diagnoses_causes():
    ray_tpu_torch.init(num_cpus=2, _system_config={
        "stall_detector_interval_s": 0.2,
        "stall_pending_threshold_s": 0.4,
        "infeasible_task_grace_s": 60.0,
    })
    try:
        @ray_tpu_torch.remote(num_cpus=64)
        def impossible():
            return 1

        @ray_tpu_torch.remote
        def needs(x):
            return x

        imp = impossible.remote()                      # noqa: F841
        ghost = ObjectRef(ObjectID.from_random())
        ghost_task = needs.remote(ghost)               # noqa: F841

        def stalls():
            evs = [e for e in sapi.list_cluster_events()
                   if e.get("label") == "TASK_STALL"]
            causes = {e.get("cause") for e in evs}
            if {"unsatisfiable_resources", "blocked_object"} <= causes:
                return evs
            return None

        evs = _poll(stalls, timeout=15.0)
        assert evs, [e.get("cause") for e in
                     sapi.list_cluster_events()
                     if e.get("label") == "TASK_STALL"]
        assert all(e["severity"] == "WARNING" for e in evs)
        by_cause = {e["cause"]: e for e in evs}
        unsat = by_cause["unsatisfiable_resources"]
        assert unsat["task_name"].endswith("impossible")
        assert "demands" in unsat["message"]
        blocked = by_cause["blocked_object"]
        assert blocked["task_name"].endswith("needs")
        assert "never created" in blocked["message"]
        assert blocked["task_state"] == "PENDING_ARGS_AVAIL"

        # warn-once: another sweep must not re-emit the same cause
        n = len([e for e in sapi.list_cluster_events()
                 if e.get("label") == "TASK_STALL"
                 and e.get("cause") == "unsatisfiable_resources"])
        time.sleep(1.0)
        n2 = len([e for e in sapi.list_cluster_events()
                  if e.get("label") == "TASK_STALL"
                  and e.get("cause") == "unsatisfiable_resources"])
        assert n2 == n
    finally:
        ray_tpu_torch.shutdown()


def test_stall_detector_collective_stuck_cause():
    """A worker parked in a collective wait past
    ``collective_timeout_s / 2`` gets a TASK_STALL event with the
    ``collective_stuck`` cause, carrying the flight-recorder diagnosis
    (the lagging rank's id) in its message — long before the generic
    300s RUNNING threshold."""
    ray_tpu_torch.init(num_cpus=4, _system_config={
        "stall_detector_interval_s": 0.3,
        # head-process view: probe RUNNING tasks after timeout/2 = 1s
        "collective_timeout_s": 2.0,
    })
    try:
        from ray_tpu_torch.comm import collective as col

        @ray_tpu_torch.remote(num_cpus=0)
        class Rank(col.CollectiveActorMixin):
            def allreduce_now(self, n, timeout):
                import numpy as np
                return float(col.allreduce(np.ones(n, "float32"),
                                           timeout=timeout)[0])

            def allreduce_late(self, n, delay, timeout):
                import numpy as np
                time.sleep(delay)
                return float(col.allreduce(np.ones(n, "float32"),
                                           timeout=timeout)[0])

        members = [Rank.remote() for _ in range(2)]
        col.create_collective_group(members, 2, [0, 1])
        # rank 0 enters immediately and wedges on rank 1, which joins
        # 8s late — long enough for the sweep to flag the hang, short
        # enough that the test ends cleanly with a completed allreduce
        r0 = members[0].allreduce_now.remote(500_000, 30.0)
        r1 = members[1].allreduce_late.remote(500_000, 8.0, 30.0)

        def stuck_events():
            return [e for e in sapi.list_cluster_events()
                    if e.get("label") == "TASK_STALL"
                    and e.get("cause") == "collective_stuck"] or None

        evs = _poll(stuck_events, timeout=12.0)
        assert evs, [
            (e.get("cause"), e.get("message"))
            for e in sapi.list_cluster_events()
            if e.get("label") == "TASK_STALL"]
        ev = evs[-1]
        assert ev["severity"] == "WARNING"
        assert "collective wait" in ev["message"]
        # the diagnoser's verdict rides along: rank 1 is the laggard
        assert "lagging rank 1" in ev["message"], ev["message"]
        assert ev["task_name"].endswith("allreduce_now")
        # the hang resolves once rank 1 arrives
        assert ray_tpu_torch.get([r0, r1], timeout=60) == [2.0, 2.0]
    finally:
        ray_tpu_torch.shutdown()


def test_stall_slow_producer_then_doctor_recovers():
    """A dep whose producer is alive-but-slow is diagnosed as upstream
    slowness (not object loss), and once everything completes the
    doctor goes green again — historical stall events must not keep it
    red."""
    ray_tpu_torch.init(num_cpus=2, _system_config={
        "stall_detector_interval_s": 0.2,
        "stall_pending_threshold_s": 0.4,
    })
    try:
        @ray_tpu_torch.remote
        def slow_src():
            time.sleep(2.5)
            return 5

        @ray_tpu_torch.remote
        def consume(x):
            return x + 1

        out = consume.remote(slow_src.remote())
        evs = _poll(lambda: [e for e in sapi.list_cluster_events()
                             if e.get("label") == "TASK_STALL"
                             and e.get("cause") == "slow_producer"]
                    or None, timeout=10.0)
        assert evs, [e.get("cause") for e in sapi.list_cluster_events()
                     if e.get("label") == "TASK_STALL"]
        assert "still being produced" in evs[-1]["message"]
        assert ray_tpu_torch.get(out, timeout=60) == 6
        rep = _poll(lambda: (lambda r: r if r["healthy"] else None)(
            sapi.health_report()), timeout=10.0)
        assert rep and rep["healthy"] and not rep["stalls"]
    finally:
        ray_tpu_torch.shutdown()


def test_stall_detector_disabled():
    ray_tpu_torch.init(num_cpus=2, _system_config={
        "stall_detector_interval_s": 0.0,
        "stall_pending_threshold_s": 0.1,
        "infeasible_task_grace_s": 30.0,
    })
    try:
        @ray_tpu_torch.remote(num_cpus=64)
        def impossible():
            return 1

        imp = impossible.remote()                      # noqa: F841
        time.sleep(1.0)
        assert not any(e.get("label") == "TASK_STALL"
                       for e in sapi.list_cluster_events())
    finally:
        ray_tpu_torch.shutdown()


# -------------------------------------------------------------- profiler

def test_profiler_hot_function(rtpu_init, tmp_path):
    @ray_tpu_torch.remote
    def hot_spin():
        t0 = time.time()
        x = 0
        while time.time() - t0 < 2.2:
            x += 1
        return x

    ref = hot_spin.remote()
    assert _poll(lambda: any(
        t["name"].endswith("hot_spin") and t["state"] == "RUNNING"
        for t in sapi.list_tasks()))
    collapsed_file = str(tmp_path / "prof.collapsed")
    chrome_file = str(tmp_path / "prof.json")
    report = sapi.profile(duration_s=1.0, interval_ms=5,
                          task_filter="hot_spin",
                          collapsed_file=collapsed_file,
                          chrome_trace_file=chrome_file)
    collapsed = report["collapsed"]
    assert collapsed and report["num_samples"] > 0
    top_stack, top_count = max(collapsed.items(), key=lambda kv: kv[1])
    assert top_count >= 5
    assert "hot_spin" in top_stack.split(";")[-1]   # leaf = hot function

    with open(collapsed_file) as f:
        first = f.readline()
    assert "hot_spin" in first and first.strip().rsplit(" ", 1)[1].isdigit()
    trace = json.load(open(chrome_file))
    assert trace and all(e["ph"] == "X" and e["dur"] > 0 for e in trace)
    assert any("hot_spin" in e["name"] for e in trace)
    assert ray_tpu_torch.get(ref, timeout=60) > 0


def test_run_profile_local_thread():
    """Unit-level: the sampler sees a spinning thread's stack."""
    import threading

    stop = threading.Event()

    def busy_beaver():
        while not stop.is_set():
            sum(range(100))

    t = threading.Thread(target=busy_beaver, name="beaver", daemon=True)
    t.start()
    try:
        report = debugging.run_profile(0.3, interval_ms=5)
    finally:
        stop.set()
        t.join()
    hits = [s for s in report["collapsed"] if "busy_beaver" in s]
    assert hits and report["num_samples"] >= 10
    assert any(seg[0] == "beaver" for seg in report["segments"])


def test_profiler_duration_capped(rtpu_init):
    from ray_tpu_torch._private.config import CONFIG
    old = CONFIG._values["profiler_max_duration_s"]
    CONFIG._values["profiler_max_duration_s"] = 0.5
    try:
        t0 = time.monotonic()
        report = sapi.profile(duration_s=60.0, interval_ms=10)
        assert report["duration_s"] == 0.5
        assert time.monotonic() - t0 < 30.0
    finally:
        CONFIG._values["profiler_max_duration_s"] = old


# ---------------------------------------------------------------- doctor

def test_doctor_reports_stall(rtpu_init):
    from ray_tpu_torch._private.config import CONFIG
    overrides = {"stall_detector_interval_s": 0.2,
                 "stall_pending_threshold_s": 0.4,
                 "infeasible_task_grace_s": 60.0}
    saved = {k: CONFIG._values[k] for k in overrides}
    CONFIG._values.update(overrides)
    try:
        rep = sapi.health_report()
        assert rep["healthy"] and rep["nodes"]["alive"] == 1

        @ray_tpu_torch.remote(num_cpus=64)
        def impossible():
            return 1

        imp = impossible.remote()                      # noqa: F841
        rep = _poll(lambda: (lambda r: r if not r["healthy"] else None)(
            sapi.health_report()), timeout=15.0)
        assert rep and not rep["healthy"]
        assert any("stalled" in p for p in rep["problems"])
        assert any(e["cause"] == "unsatisfiable_resources"
                   for e in rep["stalls"])
        assert rep["resources"]["total"].get("CPU") == 4.0
    finally:
        CONFIG._values.update(saved)


# -------------------------------------------------------------------- CLI

def test_cli_stack_profile_doctor(rtpu_init):
    @ray_tpu_torch.remote
    def warmup(x):
        return x

    ray_tpu_torch.get([warmup.remote(i) for i in range(2)])
    session = ray_tpu_torch._session_dir
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--session",
         session, "stack", "--timeout", "3"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "distinct stack" in out.stdout
    assert "thread(s):" in out.stdout

    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--session",
         session, "profile", "--duration", "0.5", "--interval-ms", "5"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "sampled" in out.stdout

    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--session",
         session, "doctor"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "cluster: HEALTHY" in out.stdout

    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--session",
         session, "doctor", "--format", "json"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["healthy"] is True


# -------------------------------------------------------------- dashboard

def test_dashboard_stacks_endpoint(rtpu_init):
    import urllib.request

    from ray_tpu_torch.dashboard import DashboardServer

    node = ray_tpu_torch._global_node
    server = DashboardServer(node)
    server.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/api/stacks",
                timeout=30) as resp:
            body = json.loads(resp.read())
        stacks = body["stacks"]
        assert stacks["nodes"] and stacks["groups"]
        dumps = [d for dumps in stacks["nodes"].values() for d in dumps]
        assert any(d["kind"] == "node" for d in dumps)
    finally:
        server.stop()
