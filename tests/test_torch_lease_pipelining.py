# A copy of tests/test_lease_pipelining.py on ray_tpu_torch's runtime: the same
# tests under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown. Docstrings leave
# out the JAX package's issue history.
"""Worker-lease pipelining under the sequenced handshake.

Covers the races and fault paths that kept `worker_pipeline_depth`
default-off before round 6 (DESIGN.md "Worker lease pipelining"):
the nested-blocking rescue race under single-core contention, worker
death with a queued pipeline (exactly-once resubmit/failure),
cancellation of a leased-but-not-started task, and blocked-worker
lease return at depth > 1. Every test runs on ONE CPU so leases,
bounces and rescues are forced onto a single contended worker.
"""

import os
import signal
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import exceptions
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


PIPELINED = {"worker_pipeline_depth": 4}


def _read_ids(path):
    try:
        with open(path) as f:
            return [line.strip() for line in f if line.strip()]
    except OSError:
        return []


def test_shipped_default_is_pipelined():
    """Acceptance pin: the SHIPPED default (not an env override) leases
    more than one task per worker."""
    from ray_tpu_torch._private.config import _CONFIG_DEFS

    assert _CONFIG_DEFS["worker_pipeline_depth"][1] > 1


def test_nested_blocking_rescue_race(tmp_path):
    """The regression that kept pipelining default-off: parents pipe
    onto one contended worker, each blocks in get() on children —
    leases bounce/return while completions promote them. Every task
    must run EXACTLY once (the un-sequenced protocol double-dispatched
    or stranded under this load) and every result must be right."""
    marker = str(tmp_path / "runs.txt")
    ray_tpu_torch.init(num_cpus=1, _system_config=PIPELINED)
    try:
        @ray_tpu_torch.remote
        def child(i):
            with open(marker, "a") as f:
                f.write(f"c{i}\n")
            return i

        @ray_tpu_torch.remote
        def parent(i):
            with open(marker, "a") as f:
                f.write(f"p{i}\n")
            return sum(ray_tpu_torch.get(
                [child.remote(10 * i + j) for j in range(3)]))

        results = ray_tpu_torch.get([parent.remote(i) for i in range(12)],
                                    timeout=180)
        assert results == [sum(10 * i + j for j in range(3))
                           for i in range(12)]
        runs = _read_ids(marker)
        # exactly-once: a double-dispatched lease would run twice
        assert sorted(runs) == sorted(set(runs))
        assert len([r for r in runs if r.startswith("p")]) == 12
        assert len([r for r in runs if r.startswith("c")]) == 36
    finally:
        ray_tpu_torch.shutdown()


def test_worker_death_with_pipeline(tmp_path):
    """Kill a worker holding a running task plus a queued pipeline:
    retriable leased tasks are resubmitted and run exactly once; the
    non-retriable blocker fails exactly once (WorkerCrashedError)."""
    marker = str(tmp_path / "runs.txt")
    pidfile = str(tmp_path / "pid.txt")
    ray_tpu_torch.init(num_cpus=1, _system_config=PIPELINED)
    try:
        @ray_tpu_torch.remote(max_retries=0)
        def blocker():
            with open(pidfile, "w") as f:
                f.write(str(os.getpid()))
            time.sleep(60)

        @ray_tpu_torch.remote(max_retries=3)
        def quick(i):
            with open(marker, "a") as f:
                f.write(f"q{i}\n")
            return i

        block_ref = blocker.remote()
        # wait for the blocker to start so the quick tasks pipe behind
        # it rather than racing it for the single worker
        deadline = time.monotonic() + 30
        while not os.path.exists(pidfile):
            assert time.monotonic() < deadline, "blocker never started"
            time.sleep(0.05)
        quick_refs = [quick.remote(i) for i in range(3)]
        time.sleep(1.0)          # leases reach the worker's queue
        with open(pidfile) as f:
            os.kill(int(f.read()), signal.SIGKILL)
        # the blocker dies for good (no retries)...
        with pytest.raises(exceptions.WorkerCrashedError):
            ray_tpu_torch.get(block_ref, timeout=60)
        # ...and every leased task is resubmitted and completes
        assert ray_tpu_torch.get(quick_refs, timeout=60) == [0, 1, 2]
        runs = _read_ids(marker)
        assert sorted(runs) == ["q0", "q1", "q2"]   # exactly once each
    finally:
        ray_tpu_torch.shutdown()


def test_worker_death_fails_pipeline_exactly_once(tmp_path):
    """Same crash with max_retries=0 leases: each LEASED task fails
    exactly once (WorkerCrashedError) instead of hanging or re-running.
    The pipeline drains a bucket only down to ONE
    remaining task (the last task stays pending so spillback can rescue
    it from behind a long occupant), so of the 3 queued quicks exactly
    the first two are leased — they crash with the worker; the unleased
    third was never exposed to the dead worker and completes on the
    replacement."""
    pidfile = str(tmp_path / "pid.txt")
    ray_tpu_torch.init(num_cpus=1, _system_config=PIPELINED)
    try:
        @ray_tpu_torch.remote(max_retries=0)
        def blocker():
            with open(pidfile, "w") as f:
                f.write(str(os.getpid()))
            time.sleep(60)

        @ray_tpu_torch.remote(max_retries=0)
        def quick(i):
            return i

        block_ref = blocker.remote()
        deadline = time.monotonic() + 30
        while not os.path.exists(pidfile):
            assert time.monotonic() < deadline, "blocker never started"
            time.sleep(0.05)
        quick_refs = [quick.remote(i) for i in range(3)]
        time.sleep(1.0)
        with open(pidfile) as f:
            os.kill(int(f.read()), signal.SIGKILL)
        for ref in [block_ref] + quick_refs[:2]:
            with pytest.raises(exceptions.WorkerCrashedError):
                ray_tpu_torch.get(ref, timeout=60)
        # the bucket's LAST task was deliberately kept pending, so the
        # crash never touched it: it runs on the replacement worker
        assert ray_tpu_torch.get(quick_refs[2], timeout=60) == 2
    finally:
        ray_tpu_torch.shutdown()


def test_cancel_pipelined_task(tmp_path):
    """Cancel a leased-but-not-started task: TaskCancelledError on its
    ref, the worker skips it (never executes), and the rest of the
    pipeline is unaffected."""
    marker = str(tmp_path / "runs.txt")
    pidfile = str(tmp_path / "pid.txt")
    ray_tpu_torch.init(num_cpus=1, _system_config=PIPELINED)
    try:
        @ray_tpu_torch.remote
        def blocker():
            with open(pidfile, "w") as f:
                f.write(str(os.getpid()))
            time.sleep(3)
            return "done"

        @ray_tpu_torch.remote
        def quick(i):
            with open(marker, "a") as f:
                f.write(f"q{i}\n")
            return i

        block_ref = blocker.remote()
        deadline = time.monotonic() + 30
        while not os.path.exists(pidfile):
            assert time.monotonic() < deadline, "blocker never started"
            time.sleep(0.05)
        victim = quick.remote(0)
        survivor = quick.remote(1)
        time.sleep(0.5)          # both leased behind the blocker
        ray_tpu_torch.cancel(victim)
        with pytest.raises(exceptions.TaskCancelledError):
            ray_tpu_torch.get(victim, timeout=60)
        assert ray_tpu_torch.get(block_ref, timeout=60) == "done"
        assert ray_tpu_torch.get(survivor, timeout=60) == 1
        assert _read_ids(marker) == ["q1"]   # the victim never ran
    finally:
        ray_tpu_torch.shutdown()


def test_blocked_worker_returns_pipeline(tmp_path):
    """A worker whose task blocks in get() at depth > 1 hands its
    unstarted leases back; they complete on other workers WHILE the
    parent is still blocked (leaving them parked would deadlock — the
    parent waits on a child that needs the queue to drain)."""
    marker = str(tmp_path / "runs.txt")
    ray_tpu_torch.init(num_cpus=1, _system_config=PIPELINED)
    try:
        @ray_tpu_torch.remote
        def child():
            return "child"

        @ray_tpu_torch.remote
        def parent():
            # blocks this worker in get(); the leases queued behind us
            # must be returned or they (and we) never finish
            return ray_tpu_torch.get(child.remote(), timeout=120)

        @ray_tpu_torch.remote
        def quick(i):
            with open(marker, "a") as f:
                f.write(f"q{i}\n")
            return i

        parent_ref = parent.remote()
        quick_refs = [quick.remote(i) for i in range(4)]
        assert ray_tpu_torch.get(parent_ref, timeout=120) == "child"
        assert ray_tpu_torch.get(quick_refs, timeout=120) == [0, 1, 2, 3]
        runs = _read_ids(marker)
        assert sorted(runs) == sorted(set(runs))    # exactly once each
    finally:
        ray_tpu_torch.shutdown()


def test_pipelined_burst_correctness():
    """Plain throughput-shaped burst at depth 4 on one CPU: results
    arrive complete, ordered by ref, and the lease-reuse counter shows
    pipelining actually engaged."""
    ray_tpu_torch.init(num_cpus=1, _system_config=PIPELINED)
    try:
        from ray_tpu_torch import state
        from ray_tpu_torch._private import telemetry

        @ray_tpu_torch.remote
        def f(i):
            return i * i

        assert ray_tpu_torch.get([f.remote(i) for i in range(200)],
                                 timeout=120) == [i * i for i in range(200)]
        telemetry.flush()
        snap = state.list_metrics(
            filters={"name": "rtpu_scheduler_lease_reused_total"})
        total = sum(row.get("value", 0) for row in snap)
        assert total > 0, "pipelining never engaged on a 200-task burst"
    finally:
        ray_tpu_torch.shutdown()
