# A copy of tests/test_memory_monitor.py on ray_tpu_torch's runtime: the same
# tests under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown. Docstrings leave
# out the JAX package's issue history.
"""Memory monitor / OOM worker-killing tests (reference analogues:
``python/ray/tests/test_memory_pressure.py`` and the policy unit tests in
``src/ray/raylet/worker_killing_policy_test.cc``).

Pressure is injected via ``RTPU_TEST_MEMORY_USAGE_FRACTION``, which the
monitor re-reads on every probe — the node service runs in this process,
so flipping the env var here raises and drops "system" memory pressure.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.memory_monitor import (MemoryMonitor, pick_oom_victim)
from ray_tpu_torch.exceptions import OutOfMemoryError
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


@pytest.fixture
def pressure_env():
    yield
    os.environ.pop("RTPU_TEST_MEMORY_USAGE_FRACTION", None)


@ray_tpu_torch.remote
def _attempt_then_sleep(path, sleep_first_s):
    with open(path, "a") as f:
        f.write(f"{os.getpid()}\n")
        f.flush()
    with open(path) as f:
        attempt = len(f.read().splitlines())
    if attempt == 1:
        time.sleep(sleep_first_s)
    return attempt


def _wait_for_attempts(path, n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                if len(f.read().splitlines()) >= n:
                    return True
        except OSError:
            pass
        time.sleep(0.1)
    return False


def test_monitor_reads_real_memory():
    frac = MemoryMonitor().usage_fraction()
    assert 0.0 < frac < 1.0
    snap = MemoryMonitor().snapshot()
    assert snap["total_bytes"] > 0


def test_oom_kill_retries_and_recovers(tmp_path, pressure_env):
    ray_tpu_torch.init(num_cpus=4,
                       _system_config={"memory_monitor_refresh_ms": 200,
                                       "task_oom_retries_default": 5})
    try:
        marker = str(tmp_path / "attempts.txt")
        ref = _attempt_then_sleep.remote(marker, 60.0)
        assert _wait_for_attempts(marker, 1)
        os.environ["RTPU_TEST_MEMORY_USAGE_FRACTION"] = "0.99"
        # the monitor kills the sleeping worker; the task retries on its
        # separate OOM budget
        assert _wait_for_attempts(marker, 2)
        os.environ.pop("RTPU_TEST_MEMORY_USAGE_FRACTION", None)
        assert ray_tpu_torch.get(ref, timeout=30) >= 2
    finally:
        ray_tpu_torch.shutdown()


def test_oom_budget_exhausted_raises(tmp_path, pressure_env):
    ray_tpu_torch.init(num_cpus=2,
                       _system_config={"memory_monitor_refresh_ms": 200,
                                       "task_oom_retries_default": 0})
    try:
        marker = str(tmp_path / "attempts.txt")
        ref = _attempt_then_sleep.options(max_retries=3).remote(marker, 60.0)
        assert _wait_for_attempts(marker, 1)
        os.environ["RTPU_TEST_MEMORY_USAGE_FRACTION"] = "0.99"
        # zero OOM budget: the kill must surface OutOfMemoryError, and the
        # ordinary max_retries budget must NOT absorb it
        with pytest.raises(OutOfMemoryError):
            ray_tpu_torch.get(ref, timeout=30)
    finally:
        ray_tpu_torch.shutdown()


class _FakeRec:
    def __init__(self, retries_left=0, oom_retries_left=0):
        self.retries_left = retries_left
        self.oom_retries_left = oom_retries_left


class _FakeWorker:
    def __init__(self, state="BUSY", task=None, actor_id=None, started_at=0.0):
        self.state = state
        self.task = task
        self.actor_id = actor_id
        self.started_at = started_at


def test_victim_policy_retriable_lifo():
    old_retriable = _FakeWorker(task=_FakeRec(retries_left=2), started_at=1.0)
    new_retriable = _FakeWorker(task=_FakeRec(oom_retries_left=1),
                                started_at=5.0)
    non_retriable = _FakeWorker(task=_FakeRec(), started_at=9.0)
    idle = _FakeWorker(state="IDLE")
    victim = pick_oom_victim(
        [idle, non_retriable, old_retriable, new_retriable])
    assert victim is new_retriable
    # without any retriable task, the newest non-retriable goes
    assert pick_oom_victim([non_retriable, idle]) is non_retriable
    # idle workers are never OOM victims
    assert pick_oom_victim([idle]) is None


def test_victim_policy_largest_rss_among_equals():
    """Among equally-retriable candidates the largest RSS
    dies (the kill that actually relieves pressure); recency is only
    the final tiebreak, and retriability still dominates RSS."""
    newest_small = _FakeWorker(task=_FakeRec(retries_left=1),
                               started_at=9.0)
    oldest_fat = _FakeWorker(task=_FakeRec(retries_left=1),
                             started_at=1.0)
    rss = {id(newest_small): 10 << 20, id(oldest_fat): 900 << 20}
    victim = pick_oom_victim([newest_small, oldest_fat],
                             rss_of=lambda w: rss[id(w)])
    assert victim is oldest_fat
    # retriable-first still outranks a fatter non-retriable worker
    fat_dead_end = _FakeWorker(task=_FakeRec(), started_at=5.0)
    rss2 = {id(newest_small): 1 << 20, id(fat_dead_end): 4 << 30}
    victim = pick_oom_victim([newest_small, fat_dead_end],
                             rss_of=lambda w: rss2[id(w)])
    assert victim is newest_small
    # equal RSS: newest assignment goes (the RetriableLIFO tiebreak)
    victim = pick_oom_victim([newest_small, oldest_fat],
                             rss_of=lambda w: 0)
    assert victim is newest_small


def test_oom_autopsy_names_victims_top_object(tmp_path, pressure_env):
    """An induced OOM kill produces an OOM_KILL
    event carrying the victim's RSS and naming its top held object and
    that object's creation callsite."""
    import numpy as np

    from ray_tpu_torch import state as rstate

    ray_tpu_torch.init(num_cpus=2,
                       _system_config={"memory_monitor_refresh_ms": 100,
                                       "task_oom_retries_default": 0})
    try:
        big = ray_tpu_torch.put(np.zeros(300_000, dtype=np.uint8))  # BIG_LINE

        @ray_tpu_torch.remote
        def hold_and_sleep(boxed, marker):
            with open(marker, "w") as f:
                f.write("running")
            time.sleep(60)

        marker = str(tmp_path / "running.txt")
        # nested so the worker HOLDS a live ref (top-level args resolve
        # to values); the dep pin names it through rec.deps either way
        ref = hold_and_sleep.options(max_retries=0).remote([big], marker)
        assert _wait_for_attempts(marker, 1)
        os.environ["RTPU_TEST_MEMORY_USAGE_FRACTION"] = "0.99"
        with pytest.raises(OutOfMemoryError):
            ray_tpu_torch.get(ref, timeout=30)
        events = rstate.list_cluster_events(filters={"label": "OOM_KILL"})
        assert events, "no OOM_KILL event recorded"
        ev = events[-1]
        assert ev.get("rss_bytes", 0) > 0
        tops = ev.get("top_objects") or []
        assert tops, ev
        assert tops[0]["size"] >= 300_000
        assert tops[0]["object_id"] == big.id.hex()
        assert "test_torch_memory_monitor.py" in (tops[0].get("callsite") or "")
        # the event MESSAGE itself names the object and its callsite
        assert big.id.hex()[:12] in ev["message"]
        assert "test_torch_memory_monitor.py" in ev["message"]
    finally:
        ray_tpu_torch.shutdown()


def test_victim_policy_prefers_tasks_over_actors():
    actor = _FakeWorker(state="ACTOR", actor_id="a1", started_at=9.0)
    task = _FakeWorker(task=_FakeRec(retries_left=1), started_at=1.0)
    victim = pick_oom_victim([actor, task],
                             actor_restartable=lambda aid: True)
    assert victim is task
    # a restartable actor outranks a non-retriable task
    dead_end = _FakeWorker(task=_FakeRec(), started_at=1.0)
    victim = pick_oom_victim([actor, dead_end],
                             actor_restartable=lambda aid: True)
    assert victim is actor
