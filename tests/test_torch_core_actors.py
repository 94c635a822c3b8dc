# A copy of tests/test_core_actors.py on ray_tpu_torch's runtime: the same
# tests under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown. Docstrings leave
# out the JAX package's issue history.
# Not copied again: test_named_actor, test_kill_actor, test_actor_restart
# (already held in another tests/test_torch_*.py under the same name).
"""Actor API tests (reference analogue: ``python/ray/tests/test_actor.py``,
``test_actor_failures.py``)."""

import time

import pytest

import ray_tpu_torch
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


@ray_tpu_torch.remote
class Counter:
    def __init__(self, start=0):
        self.value = start

    def incr(self, by=1):
        self.value += by
        return self.value

    def read(self):
        return self.value


def test_actor_basic(rtpu_init):
    c = Counter.remote()
    assert ray_tpu_torch.get(c.incr.remote()) == 1
    assert ray_tpu_torch.get(c.incr.remote(5)) == 6
    assert ray_tpu_torch.get(c.read.remote()) == 6


def test_actor_init_args(rtpu_init):
    c = Counter.remote(100)
    assert ray_tpu_torch.get(c.read.remote()) == 100


def test_actor_ordering(rtpu_init):
    c = Counter.remote()
    refs = [c.incr.remote() for _ in range(20)]
    assert ray_tpu_torch.get(refs) == list(range(1, 21))


def test_two_actors_isolated(rtpu_init):
    a, b = Counter.remote(), Counter.remote()
    ray_tpu_torch.get([a.incr.remote(), a.incr.remote(), b.incr.remote()])
    assert ray_tpu_torch.get(a.read.remote()) == 2
    assert ray_tpu_torch.get(b.read.remote()) == 1


def test_actor_method_error(rtpu_init):
    @ray_tpu_torch.remote
    class Bad:
        def boom(self):
            raise RuntimeError("actor oops")

        def ok(self):
            return "fine"

    b = Bad.remote()
    with pytest.raises(ray_tpu_torch.exceptions.TaskError, match="actor oops"):
        ray_tpu_torch.get(b.boom.remote())
    # actor survives method exceptions
    assert ray_tpu_torch.get(b.ok.remote()) == "fine"



def test_named_actor_missing(rtpu_init):
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("nope")


def test_actor_handle_passed_to_task(rtpu_init):
    c = Counter.remote()

    @ray_tpu_torch.remote
    def bump(counter, times):
        return ray_tpu_torch.get([counter.incr.remote() for _ in range(times)])[-1]

    assert ray_tpu_torch.get(bump.remote(c, 3)) == 3



def test_async_actor(rtpu_init):
    @ray_tpu_torch.remote
    class AsyncOverlap:
        async def window(self, t, tag):
            import asyncio
            import time as _t
            start = _t.monotonic()
            await asyncio.sleep(t)
            return (tag, start, _t.monotonic())

    w = AsyncOverlap.remote()
    # both coroutines must run concurrently on the actor's event loop:
    # assert their execution windows OVERLAP (wall-clock totals are load
    # noise on a shared box and cry wolf under a loaded full-suite run)
    refs = [w.window.remote(0.5, "a"), w.window.remote(0.5, "b")]
    out = {tag: (s, e) for tag, s, e in ray_tpu_torch.get(refs)}
    assert set(out) == {"a", "b"}
    (s1, e1), (s2, e2) = out["a"], out["b"]
    assert s1 < e2 and s2 < e1, f"no overlap: {out}"


def test_max_concurrency_threaded_actor(rtpu_init):
    @ray_tpu_torch.remote(max_concurrency=4)
    class Sleepy:
        def nap(self, t):
            import threading
            time.sleep(t)
            return threading.get_ident()

    s = Sleepy.remote()
    ray_tpu_torch.get(s.nap.remote(0))  # wait for actor startup before timing
    t0 = time.time()
    ray_tpu_torch.get([s.nap.remote(1.0) for _ in range(4)])
    assert time.time() - t0 < 3.5


def test_duplicate_named_actor_raises(rtpu_init):
    Counter.options(name="dup").remote()
    h2 = Counter.options(name="dup").remote()
    with pytest.raises(ValueError, match="already taken"):
        ray_tpu_torch.get(h2._ready_ref, timeout=15)
    # original still reachable
    assert ray_tpu_torch.get(ray_tpu_torch.get_actor("dup").read.remote()) == 0


def test_method_decorator_num_returns(rtpu_init):
    @ray_tpu_torch.remote
    class Pair:
        @ray_tpu_torch.method(num_returns=2)
        def two(self):
            return "a", "b"

    p = Pair.remote()
    r1, r2 = p.two.remote()
    assert ray_tpu_torch.get([r1, r2]) == ["a", "b"]


def test_actor_crash_in_init_seals_ready_ref(rtpu_init):
    """A worker that dies mid-__init__ with no restarts must fail the
    creation ref instead of hanging waiters (regression)."""
    import os as _os

    @ray_tpu_torch.remote(max_restarts=0)
    class Bomb:
        def __init__(self):
            _os._exit(1)

    h = Bomb.remote()
    with pytest.raises(ray_tpu_torch.exceptions.ActorDiedError):
        ray_tpu_torch.get(h._ready_ref, timeout=20)


def test_actor_crash_in_init_restart_then_ready(rtpu_init):
    """If the first __init__ attempt dies but restarts remain, the ready
    ref must resolve after the successful restart (regression: restart
    path wiped return_ids unconditionally)."""
    import os as _os
    import tempfile

    marker = tempfile.mktemp(prefix="rtpu_bomb_")

    @ray_tpu_torch.remote(max_restarts=2)
    class FlakyInit:
        def __init__(self):
            if not _os.path.exists(marker):
                open(marker, "w").close()
                _os._exit(1)

        def ping(self):
            return "pong"

    h = FlakyInit.remote()
    assert ray_tpu_torch.get(h._ready_ref, timeout=30) is None
    assert ray_tpu_torch.get(h.ping.remote(), timeout=20) == "pong"
    _os.unlink(marker)


def test_actor_call_ordering_with_dep_race(rtpu_init):
    """A dep-waiting actor call must BLOCK later calls from the same
    submitter: a stateful actor can never observe call N+1 before call N
    (reference: actor_scheduling_queue.cc per-submitter sequence order)."""
    @ray_tpu_torch.remote
    def slow_value():
        time.sleep(1.0)
        return 41

    @ray_tpu_torch.remote
    class Log:
        def __init__(self):
            self.calls = []

        def record(self, tag, _dep=None):
            self.calls.append(tag)
            return list(self.calls)

    log = Log.remote()
    assert ray_tpu_torch.get(log.record.remote("warmup")) == ["warmup"]
    dep = slow_value.remote()          # resolves ~1s from now
    log.record.remote("first", dep)    # parks waiting on dep
    r2 = log.record.remote("second")   # must NOT overtake "first"
    assert ray_tpu_torch.get(r2, timeout=30) == ["warmup", "first", "second"]


def test_actor_dep_wait_does_not_block_other_submitters(rtpu_init):
    """Per-submitter order only: another submitter's calls may interleave
    while the first submitter's call waits on its dep."""
    @ray_tpu_torch.remote
    def slow_value():
        time.sleep(2.0)
        return 1

    @ray_tpu_torch.remote
    class Log:
        def __init__(self):
            self.calls = []

        def record(self, tag, _dep=None):
            self.calls.append(tag)
            return list(self.calls)

    @ray_tpu_torch.remote
    def other_submitter(handle):
        return ray_tpu_torch.get(handle.record.remote("other"))

    log = Log.remote()
    assert ray_tpu_torch.get(log.record.remote("warmup")) == ["warmup"]
    dep = slow_value.remote()
    log.record.remote("driver-blocked", dep)
    # a DIFFERENT submitter (the task worker) must get through while the
    # driver's call still waits on its dep
    out = ray_tpu_torch.get(other_submitter.remote(log), timeout=15)
    assert out == ["warmup", "other"]


def test_exit_actor(rtpu_init):
    """Regression: ACTOR_EXIT had a handler but no sender —
    ``exit_actor()`` is the API that emits it. The exiting call's
    caller observes the death, the actor is NOT restarted (even with
    restarts budgeted), and further calls fail with ActorDiedError."""

    @ray_tpu_torch.remote(max_restarts=2)
    class Quitter:
        def ping(self):
            return "pong"

        def leave(self):
            ray_tpu_torch.exit_actor()
            return "unreachable"

    a = Quitter.remote()
    assert ray_tpu_torch.get(a.ping.remote()) == "pong"
    with pytest.raises((ray_tpu_torch.exceptions.ActorDiedError,
                        ray_tpu_torch.exceptions.TaskError)):
        ray_tpu_torch.get(a.leave.remote(), timeout=60)
    # intentional exit suppresses the restart budget: the actor stays
    # dead instead of coming back as a fresh instance
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            ray_tpu_torch.get(a.ping.remote(), timeout=10)
        except ray_tpu_torch.exceptions.ActorDiedError:
            break
        except ray_tpu_torch.exceptions.GetTimeoutError:
            continue
        time.sleep(0.2)
    else:
        raise AssertionError("actor answered after exit_actor() "
                             "(restarted or never died)")


def test_exit_actor_outside_actor_raises(rtpu_init):
    with pytest.raises(RuntimeError):
        ray_tpu_torch.exit_actor()
