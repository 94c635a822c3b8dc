"""Self-healing collective groups + checkpointable actor restart, aimed at
ray_tpu_torch (copies of tests/test_self_healing.py).

The detect -> recover loop, chaos-tested in-process: epoch fencing,
coordinator reform rounds (replace | shrink), fault-tolerant op
wrappers, the deterministic failpoint injector, checkpoint/restore, and
the bounded-teardown + coordinator-restart-budget regressions. The
2-OS-node acceptance lives in test_network_cluster.py.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.comm import collective as col


@pytest.fixture
def rtpu_init():
    """The port's runtime per test, as conftest's is ray_tpu's."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    # conftest reports only ray_tpu's sanitizers: hold the port's here
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []


# --------------------------------------------------------------- failpoints

def test_failpoint_spec_parsing_and_actions():
    from ray_tpu_torch._private import failpoints as fps

    # guards + once + sleep parse
    n = fps.activate("coll.op.begin=raise@op=allreduce&seq=1!once;"
                     "actor.call.begin=sleep:0.01")
    try:
        assert n == 2
        # guard mismatch: nothing fires
        fps.fp("coll.op.begin", op="allreduce", seq=0)
        fps.fp("coll.op.begin", op="barrier", seq=1)
        # exact match fires once, then the entry is spent
        with pytest.raises(fps.FailpointError):
            fps.fp("coll.op.begin", op="allreduce", seq=1)
        fps.fp("coll.op.begin", op="allreduce", seq=1)   # spent: no-op
        t0 = time.monotonic()
        fps.fp("actor.call.begin", method="x")
        assert time.monotonic() - t0 >= 0.009
    finally:
        fps.deactivate()
    assert not fps.active()
    # unregistered sites and malformed entries fail loudly at arm time
    with pytest.raises(ValueError):
        fps.parse("coll.bogus.site=kill")
    with pytest.raises(ValueError):
        fps.parse("coll.op.begin=explode")
    with pytest.raises(ValueError):
        fps.parse("coll.op.begin")
    with pytest.raises(ValueError):
        fps.parse("coll.op.begin=sleep:abc")


def test_failpoint_registry_lint_package_clean():
    """Rule (g): the port's fp() call sites and its failpoints._SITES
    agree both directions, and the lint actually SEES the known sites
    (anti-vacuity). The port has no copy of the lints yet, so ray_tpu's
    lint function reads the port's package."""
    import ast
    import os

    from ray_tpu.scripts.check_concurrency import (
        _repo_root, _walk_files, check_failpoint_registry)

    class an:   # the analyzer's file list, over the port's package
        files = _walk_files(os.path.join(_repo_root(), "ray_tpu_torch"))

    assert any(rel.endswith("comm/collective.py") for rel, _, _ in an.files)
    assert check_failpoint_registry(an.files) == []
    # anti-vacuity: a synthesized caller of a bogus site is flagged,
    # and a registry missing a planted site is flagged
    bad_src = 'from . import failpoints\nfailpoints.fp("coll.not.a.site")\n'
    files = an.files + [("_private/zzz_fake.py", ast.parse(bad_src),
                         bad_src.splitlines())]
    probs = check_failpoint_registry(files)
    assert any("coll.not.a.site" in p for p in probs)


# ------------------------------------------------------------ epoch fencing

def test_fence_drops_and_refuses_stale_epoch_chunks():
    from ray_tpu_torch._private import coll_transport as ct

    group, old, new = "fence_t", "e0aa", "e1bb"
    base = ct.stats()["fenced_chunks"]
    # a chunk parked BEFORE the fence is swept by it
    ct.deposit((group, old, 0, "rs", 1, 0), np.ones(4, np.float32))
    assert any(k[:2] == (group, old) for k in ct.pending_keys())
    dropped = ct.fence(group, old)
    assert dropped == 1
    assert not any(k[:2] == (group, old) for k in ct.pending_keys())
    # a chunk arriving AFTER the fence is refused, counted, never parked
    ct.deposit((group, old, 0, "rs", 2, 0), np.ones(4, np.float32))
    assert not any(k[:2] == (group, old) for k in ct.pending_keys())
    assert ct.stats()["fenced_chunks"] == base + 2
    assert old in ct.fenced_epochs(group)
    # the NEW epoch's traffic is untouched
    ct.deposit((group, new, 0, "rs", 1, 0), np.ones(4, np.float32))
    assert ct.wait((group, new, 0, "rs", 1, 0),
                   time.monotonic() + 1.0) is not None
    ct.drop_group(group, new)


# ------------------------------------------------- coordinator reform rounds

def _run_coord(coro):
    import asyncio
    return asyncio.run(coro)


def test_coordinator_reform_state_machine():
    """The reform round, driven directly: replace waits for all ranks,
    shrink resolves on quiescence with contiguous renumbering, resolved
    rounds are cached for latecomers, a shrunk-out rank gets a clear
    'not a member' error, and resolution fences the fallback mail."""
    import asyncio

    from ray_tpu_torch.comm.collective import _CoordinatorImpl

    async def run():
        c = _CoordinatorImpl(3)
        joins = await asyncio.gather(
            c.join(0, ("n", b"w0"), 5.0), c.join(1, ("n", b"w1"), 5.0),
            c.join(2, ("n", b"w2"), 5.0))
        assert all(s == "ok" for s, _ in joins)
        e0 = c.epoch
        await c.post(1, (0, 0, 0), np.ones(1))      # fallback mail
        assert c.debug_counts()["mail"] == 1

        # --- shrink: ranks 0 and 1 reform, rank 2 is dead
        r0, r1 = await asyncio.gather(
            c.reform(0, ("n", b"w0x"), e0, "shrink", 5.0, 0.3),
            c.reform(1, ("n", b"w1x"), e0, "shrink", 5.0, 0.3))
        for status, res in (r0, r1):
            assert status == "ok", res
            assert res["reformed"] and res["world"] == 2
            assert res["epoch"] != e0
        assert r0[1]["rank"] == 0 and r1[1]["rank"] == 1
        assert r0[1]["endpoints"] == [("n", b"w0x"), ("n", b"w1x")]
        # resolution fenced the fallback mail (keys carry no epoch)
        assert c.debug_counts()["mail"] == 0
        assert c.world_size == 2

        # latecomer with the superseded epoch adopts the cached result;
        # the shrunk-out rank gets a CLEAR not-a-member error
        s, res = await c.reform(0, ("n", b"w0x"), e0, "shrink", 1.0, 0.3)
        assert s == "ok" and res["epoch"] == r0[1]["epoch"]
        s, msg = await c.reform(2, ("n", b"w2x"), e0, "shrink", 1.0, 0.3)
        assert s == "timeout" and "not a member" in msg

        # --- replace on the shrunk group: both (new) ranks re-arrive
        e1 = c.epoch
        r0, r1 = await asyncio.gather(
            c.reform(0, ("n", b"w0y"), e1, "replace", 5.0, 0.3),
            c.reform(1, ("n", b"w1y"), e1, "replace", 5.0, 0.3))
        assert all(s == "ok" for s, _ in (r0, r1))
        assert r0[1]["world"] == 2 and r0[1]["epoch"] != e1

        # --- replace with a rank that never returns: bounded, clear
        e2 = c.epoch
        s, msg = await c.reform(0, ("n", b"w0z"), e2, "replace", 0.4, 0.3)
        assert s == "timeout"
        assert "never re-joined" in msg and "shrink" in msg

        # --- a LONE restarted rank (from_epoch None) must never
        # shrink-resolve a round by itself: without a survivor in the
        # round (nobody has observed a failure) it waits out its
        # timeout instead of contracting the live group to a world of
        # one — and the group's epoch/world stay untouched
        e3, w3 = c.epoch, c.world_size
        s, msg = await c.reform(0, ("n", b"w0q"), None, "shrink",
                                0.5, 0.1)
        assert s == "timeout", (s, msg)
        assert c.epoch == e3 and c.world_size == w3
        # a shrunk-out old rank re-entering with from_epoch None (its
        # rank is outside the current world) is told so immediately
        s, msg = await c.reform(7, ("n", b"w7"), None, "shrink",
                                0.5, 0.1)
        assert s == "timeout" and "not a member" in msg

        # --- NON-tail shrink renumbers ranks: once that happened, ANY
        # stale-rank re-entry is refused (an old rank id may now alias
        # a renumbered survivor — two processes behind one mailbox)
        e4 = c.epoch
        s, res = await c.reform(1, ("n", b"w1z"), e4, "shrink", 5.0, 0.1)
        assert s == "ok" and res["world"] == 1 and res["rank"] == 0
        s, msg = await c.reform(0, ("n", b"w0r"), None, "shrink",
                                0.5, 0.1)
        assert s == "timeout" and "renumbered" in msg

        # --- a RESTARTED coordinator (fresh state, original ctor
        # world) must adopt the surviving group's world view from the
        # reform callers instead of join-waiting for pre-shrink ghosts
        c2 = _CoordinatorImpl(4)            # original world was 4...
        r0, r1 = await asyncio.gather(      # ...but 2 ranks survive
            c2.reform(0, ("n", b"s0"), "deadbeef", "replace", 5.0, 0.3,
                      2),
            c2.reform(1, ("n", b"s1"), "deadbeef", "replace", 5.0, 0.3,
                      2))
        assert all(s == "ok" for s, _ in (r0, r1)), (r0, r1)
        assert r0[1]["world"] == 2 and c2.world_size == 2

    _run_coord(run())


# --------------------------------------------------------- e2e: shrink mode

def _make_ft_worker():
    import ray_tpu_torch
    from ray_tpu_torch._private import coll_transport
    from ray_tpu_torch.comm import collective as col

    @ray_tpu_torch.remote(num_cpus=0)
    class FT(col.CollectiveActorMixin):
        def configure(self, mode, grace=1.0):
            from ray_tpu_torch._private.config import CONFIG
            CONFIG._values["collective_reform_mode"] = mode
            CONFIG._values["collective_reform_grace_s"] = grace
            return True

        def step(self, n, timeout):
            rank = col.get_rank()
            x = np.full(n, float(rank + 1), np.float32)
            out = col.ft_allreduce(x, timeout=timeout, retries=1)
            st = col._groups()["default"]
            return (float(out[0]), st.world_size, st.rank, st.epoch)

        def epoch(self):
            return col._groups()["default"].epoch

        def mailbox(self, old_epoch):
            stale = [k for k in coll_transport.pending_keys()
                     if len(k) >= 2 and k[1] == old_epoch]
            return (stale, old_epoch in
                    coll_transport.fenced_epochs("default"))

    return FT


def test_shrink_reform_survives_rank_kill(rtpu_init):
    """A SIGKILLed rank no longer kills its group forever: the
    survivors' ft_allreduce times out with a dead_rank verdict, fences
    the epoch, shrinks the world to 2, re-issues, and returns the
    survivors' reduction — with the reform observable in the metric
    AND as a COLLECTIVE_REFORM event."""
    from ray_tpu_torch import state as rstate

    FT = _make_ft_worker()
    members = [FT.remote() for _ in range(3)]
    ray_tpu_torch.get([m.configure.remote("shrink", 1.0) for m in members])
    col.create_collective_group(members, 3, [0, 1, 2])
    old_epoch = ray_tpu_torch.get(members[0].epoch.remote())

    ray_tpu_torch.kill(members[2])
    refs = [m.step.remote(50_000, 3.0) for m in members[:2]]
    outs = ray_tpu_torch.get(refs, timeout=120)
    # survivors are ranks 0 and 1: sum = 1 + 2 = 3, world shrank to 2
    for val, world, _rank, epoch in outs:
        assert val == 3.0
        assert world == 2
        assert epoch != old_epoch
    assert sorted(r for _, _, r, _ in outs) == [0, 1]

    # the failing epoch is fenced everywhere and left no stale chunks
    for m in members[:2]:
        stale, fenced = ray_tpu_torch.get(m.mailbox.remote(old_epoch))
        assert stale == []
        assert fenced

    # accounting: reform metric (per surviving rank) + one event
    deadline = time.monotonic() + 15
    total = 0
    while time.monotonic() < deadline:
        summary = rstate.summarize_metrics().get(
            "rtpu_collective_reforms_total") or {}
        total = summary.get("total", 0)
        if total >= 2:
            break
        time.sleep(0.25)
    assert total >= 2, "reform counter never reached the merged table"
    evs = [e for e in rstate.list_cluster_events()
           if e.get("label") == "COLLECTIVE_REFORM"]
    assert evs and evs[-1].get("mode") == "shrink"
    rep = rstate.health_report()
    assert rep["recovery"]["collective_reforms"] >= 2


# ------------------------------------- e2e: replace mode + checkpointing

def _make_ckpt_worker():
    import ray_tpu_torch
    from ray_tpu_torch.comm import collective as col

    @ray_tpu_torch.remote(num_cpus=0, max_restarts=2)
    class CkptRank(col.CollectiveActorMixin):
        def __init__(self, world, rank, group):
            from ray_tpu_torch._private.config import CONFIG
            CONFIG._values["actor_checkpoint_interval_calls"] = 1
            CONFIG._values["collective_reform_timeout_s"] = 20.0
            self.world, self.rank, self.group = world, rank, group
            self.step = 0
            self.acc = None
            self.restored = False
            self.restored_at_step = None

        def save_checkpoint(self):
            return {"step": self.step, "acc": self.acc}

        def restore_checkpoint(self, state):
            self.step = state["step"]
            self.acc = state["acc"]
            self.restored = True
            self.restored_at_step = state["step"]

        def arm(self, spec):
            from ray_tpu_torch._private import failpoints
            failpoints.activate(spec)
            return True

        def train_step(self, i):
            col.ensure_collective_group(self.world, self.rank, self.group)
            if self.step > i:
                return self.step        # already completed pre-death
            x = np.full(4, float((i + 1) * (self.rank + 1)), np.float32)
            out = col.ft_allreduce(x, group_name=self.group, timeout=4.0)
            self.acc = out if self.acc is None else self.acc + out
            self.step = i + 1
            return self.step

        def report(self):
            return (self.step, self.restored, self.restored_at_step,
                    None if self.acc is None else [float(v)
                                                   for v in self.acc])

    return CkptRank


def _drive_step(members, i, make_ref, timeout=90.0):
    """Flake-resistant driver loop: poll refs with wait(), re-issue a
    call whose actor died (it restarts and resumes from its
    checkpoint). No bare sleeps on the success path."""
    pending = {idx: make_ref(m, i) for idx, m in enumerate(members)}
    results = {}
    deadline = time.monotonic() + timeout
    while pending:
        assert time.monotonic() < deadline, (
            f"step {i} never completed; pending ranks {list(pending)}")
        for idx, ref in list(pending.items()):
            ready, _ = ray_tpu_torch.wait([ref], timeout=0.5)
            if not ready:
                continue
            try:
                results[idx] = ray_tpu_torch.get(ready[0])
                del pending[idx]
            except Exception:           # actor died: re-issue the call
                pending[idx] = make_ref(members[idx], i)
    return results


def test_replace_reform_restores_checkpointed_rank(rtpu_init):
    """The core loop, in-process: a checkpointable rank SIGKILLed
    by a failpoint entering its step-2 allreduce restarts, restores its
    step-2 checkpoint, re-enters the reform round with its old rank,
    and the training loop reaches step N with bit-correct results on
    both ranks."""
    from ray_tpu_torch import state as rstate

    CkptRank = _make_ckpt_worker()
    members = [CkptRank.remote(2, r, "train") for r in range(2)]
    # rank 1 dies the moment it enters the seq-2 (= step-2) allreduce
    ray_tpu_torch.get(members[1].arm.remote("coll.op.begin=kill@seq=2"))

    N = 4
    for i in range(N):
        results = _drive_step(
            members, i, lambda m, s: m.train_step.remote(s))
        assert set(results.values()) == {i + 1}

    reports = ray_tpu_torch.get([m.report.remote() for m in members])
    # per element, step i contributes (i+1)*(1+2): total 3*(1+2+3+4)
    want = [30.0] * 4
    for step, _restored, _at, acc in reports:
        assert step == N
        assert acc == want                     # bit-correct
    # the killed rank came back THROUGH its checkpoint: it restored at
    # step 2 (steps 0-1 done), not from __init__
    assert reports[1][1] is True
    assert reports[1][2] == 2
    assert reports[0][1] is False

    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        s = rstate.summarize_metrics()
        restores = (s.get("rtpu_actor_restores_total") or {}).get(
            "total", 0)
        ckpts = (s.get("rtpu_actor_checkpoints_total") or {}).get(
            "total", 0)
        reforms = (s.get("rtpu_collective_reforms_total") or {}).get(
            "total", 0)
        if restores >= 1 and ckpts >= 2 and reforms >= 2:
            break
        time.sleep(0.25)
    assert restores >= 1 and ckpts >= 2 and reforms >= 2
    rep = rstate.health_report()
    assert rep["recovery"]["actor_restores"] >= 1
    evs = [e for e in rstate.list_cluster_events()
           if e.get("label") == "COLLECTIVE_REFORM"]
    assert evs and evs[-1].get("group") == "train"


# ------------------------------------------------ checkpoint on demand

def test_actor_checkpoint_on_demand_and_restore(rtpu_init):
    @ray_tpu_torch.remote(num_cpus=0, max_restarts=1)
    class KV:
        def __init__(self):
            self.d = {}
            self.restored = False

        def save_checkpoint(self):
            return dict(self.d)

        def restore_checkpoint(self, state):
            self.d = dict(state)
            self.restored = True

        def put(self, k, v, ckpt=False):
            self.d[k] = v
            if ckpt:
                return ray_tpu_torch.actor_checkpoint()
            return None

        def snapshot(self):
            return dict(self.d), self.restored

    kv = KV.remote()
    assert ray_tpu_torch.get(kv.put.remote("a", 1, ckpt=True)) == 1
    ray_tpu_torch.get(kv.put.remote("b", 2))           # after the checkpoint
    ray_tpu_torch.kill(kv, no_restart=False)           # worker dies, restarts

    deadline = time.monotonic() + 60
    while True:
        try:
            d, restored = ray_tpu_torch.get(kv.snapshot.remote(), timeout=5)
            break
        except Exception:
            assert time.monotonic() < deadline, "actor never restarted"
            time.sleep(0.25)
    # resumed at the last CHECKPOINT: "a" survived, the unsnapshotted
    # "b" did not (the contract is last-checkpoint, not last-write)
    assert restored is True
    assert d == {"a": 1}

    # outside an actor, the API refuses clearly
    with pytest.raises(RuntimeError):
        ray_tpu_torch.actor_checkpoint()


def test_actor_checkpoint_time_interval_trigger(rtpu_init):
    """TIME-based periodic checkpointing: a
    slow-call actor whose calls each outlast
    ``actor_checkpoint_interval_s`` checkpoints at every call
    completion even though the call-count trigger
    (``actor_checkpoint_interval_calls``) is off — a restart resumes
    from the last completed call, not from __init__."""

    @ray_tpu_torch.remote(num_cpus=0, max_restarts=1)
    class SlowCounter:
        def __init__(self):
            from ray_tpu_torch._private.config import CONFIG
            # worker-side: the driver's _system_config doesn't reach
            # spawned workers (same pattern as the reform e2e tests)
            CONFIG._values["actor_checkpoint_interval_s"] = 0.05
            CONFIG._values["actor_checkpoint_interval_calls"] = 0
            self.step = 0
            self.restored = False

        def save_checkpoint(self):
            return {"step": self.step}

        def restore_checkpoint(self, state):
            self.step = state["step"]
            self.restored = True

        def tick(self):
            time.sleep(0.08)            # each call outlasts the interval
            self.step += 1
            return self.step

        def snapshot(self):
            return self.step, self.restored

    actor = SlowCounter.remote()
    assert ray_tpu_torch.get(actor.tick.remote(), timeout=30) == 1
    assert ray_tpu_torch.get(actor.tick.remote(), timeout=30) == 2
    ray_tpu_torch.kill(actor, no_restart=False)        # worker dies, restarts

    deadline = time.monotonic() + 60
    while True:
        try:
            step, restored = ray_tpu_torch.get(actor.snapshot.remote(),
                                         timeout=5)
            break
        except Exception:
            assert time.monotonic() < deadline, "actor never restarted"
            time.sleep(0.25)
    # the time trigger captured after each completed call — the restart
    # resumed at step 2, proving the capture happened WITHOUT any
    # call-count or on-demand trigger
    assert restored is True
    assert step == 2

    # the metric pipeline saw the periodic captures
    from ray_tpu_torch import state as rstate
    deadline = time.monotonic() + 10
    total = 0
    while time.monotonic() < deadline:
        m = rstate.summarize_metrics().get(
            "rtpu_actor_checkpoints_total") or {}
        total = m.get("total", 0)
        if total >= 2:
            break
        time.sleep(0.25)
    assert total >= 2, "periodic checkpoints never reached the table"


# ------------------------------------------- satellite: bounded teardown

def test_destroy_with_dead_rank0_is_bounded_and_recreate_works(rtpu_init):
    """Regression: rank 0's process dying used to leak the named
    coordinator forever (only rank 0 killed it on destroy), so the
    group name could never be reused. Now every member's destroy fences
    the epoch, sweeps the dead member's stranded mailbox chunks, and
    attempts the coordinator kill — teardown + recreate completes
    within a bounded window."""
    import ray_tpu_torch
    from ray_tpu_torch.comm import collective as c

    @ray_tpu_torch.remote(num_cpus=0)
    class Member(c.CollectiveActorMixin):
        def ar(self, x, group):
            return c.allreduce(np.asarray(x, np.float32),
                               group_name=group)

        def teardown_with_stranded_chunk(self, group):
            from ray_tpu_torch._private import coll_transport
            st = c._groups()[group]
            # a dead member's chunk nobody will consume
            coll_transport.deposit((group, st.epoch, 0, "rs", 99, 0),
                                   np.ones(4, np.float32))
            c.destroy_collective_group(group)
            return (coll_transport.stats()["pending"],
                    st.epoch in coll_transport.fenced_epochs(group))

    members = [Member.remote() for _ in range(3)]
    col.create_collective_group(members, 3, [0, 1, 2], group_name="phx")
    ray_tpu_torch.kill(members[0])                    # rank 0 (NOT the coordinator)

    t0 = time.monotonic()
    outs = ray_tpu_torch.get([m.teardown_with_stranded_chunk.remote("phx")
                        for m in members[1:]], timeout=30)
    for pending, fenced in outs:
        assert pending == 0                     # stranded chunk swept
        assert fenced
    # the survivors' destroy killed the coordinator: the name frees
    deadline = time.monotonic() + 30
    while True:
        try:
            ray_tpu_torch.get_actor("rtpu:collective:phx")
        except ValueError:
            break
        assert time.monotonic() < deadline, "coordinator actor leaked"
        time.sleep(0.2)
    fresh = [Member.remote() for _ in range(3)]
    col.create_collective_group(fresh, 3, [0, 1, 2], group_name="phx")
    outs = ray_tpu_torch.get([m.ar.remote([1.0], "phx") for m in fresh],
                       timeout=60)
    for arr in outs:
        np.testing.assert_allclose(arr, [3.0])
    assert time.monotonic() - t0 < 60.0


# --------------------------------- satellite: coordinator restart budget

def test_coordinator_death_mid_join_recovers(rtpu_init):
    """The coordinator actor dying mid-join no longer strands joiners
    until the collective timeout: it restarts (budget 3), every blocked
    joiner's call fails with ActorDiedError and idempotently re-joins
    the fresh (empty) coordinator, and the group forms."""
    import ray_tpu_torch
    from ray_tpu_torch.comm import collective as c

    @ray_tpu_torch.remote(num_cpus=0)
    class Joiner(c.CollectiveActorMixin):
        def join_delayed(self, world, rank, group, delay):
            time.sleep(delay)
            c.init_collective_group(world, rank, group)
            return True

        def ar(self, x, group):
            return c.allreduce(np.asarray(x, np.float32),
                               group_name=group)

    a, b = Joiner.remote(), Joiner.remote()
    r0 = a.join_delayed.remote(2, 0, "mj", 0.0)
    r1 = b.join_delayed.remote(2, 1, "mj", 2.0)
    # rank 0 is blocked inside join (rank 1 arrives at t=2s); kill the
    # coordinator out from under it WITH restarts allowed
    coord = None
    deadline = time.monotonic() + 10
    while coord is None and time.monotonic() < deadline:
        try:
            coord = ray_tpu_torch.get_actor("rtpu:collective:mj")
        except ValueError:
            time.sleep(0.05)
    assert coord is not None
    time.sleep(0.5)                      # rank 0 is now inside join()
    ray_tpu_torch.kill(coord, no_restart=False)
    assert ray_tpu_torch.get([r0, r1], timeout=90) == [True, True]
    outs = ray_tpu_torch.get([m.ar.remote([2.0], "mj") for m in (a, b)],
                       timeout=60)
    for arr in outs:
        np.testing.assert_allclose(arr, [4.0])


def test_coordinator_budget_exhausted_surfaces_clear_error(rtpu_init):
    """When the coordinator is terminally dead (budget gone / killed
    with no_restart), membership ops fail with a message that NAMES the
    coordinator — not a bare timeout."""
    import ray_tpu_torch
    from ray_tpu_torch.comm import collective as c

    @ray_tpu_torch.remote(num_cpus=0)
    class Member(c.CollectiveActorMixin):
        def try_reform(self, group):
            try:
                c.reform_collective_group(group, timeout=2.0)
                return ("ok", "")
            except Exception as exc:     # noqa: BLE001
                return ("err", str(exc))

    members = [Member.remote() for _ in range(2)]
    col.create_collective_group(members, 2, [0, 1], group_name="dead")
    coord = ray_tpu_torch.get_actor("rtpu:collective:dead")
    ray_tpu_torch.kill(coord)                  # no_restart=True: terminal
    # wait until the control plane reflects the death
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            ray_tpu_torch.get_actor("rtpu:collective:dead")
            time.sleep(0.2)
        except ValueError:
            break
    status, msg = ray_tpu_torch.get(members[0].try_reform.remote("dead"),
                              timeout=60)
    assert status == "err"
    assert "coordinator" in msg.lower(), msg
    assert "died" in msg.lower(), msg
