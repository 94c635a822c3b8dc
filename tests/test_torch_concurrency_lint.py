"""Tier-1 wiring of the port's concurrency lint
(ray_tpu_torch/scripts/check_concurrency.py) and its runtime lock-order
sanitizer (ray_tpu_torch/_private/locksan.py): copies of
tests/test_concurrency_lint.py. The port's design tables live in
ray_tpu_torch/DESIGN.md, so the fixture repos put theirs there too.

The first test is the gate: the analyzer must exit clean on the real
package (zero unwaived findings). The fixture tests pin each rule's
behavior on synthetic packages so a regression in the analyzer itself
can't silently turn the gate vacuous. The locksan tests construct a
real A->B / B->A deadlock across two threads and assert the sanitizer
reports (and, in raise mode, prevents) it before the threads wedge.
"""

import ast
import os
import threading
import time

import pytest

from ray_tpu_torch._private import fieldsan, locksan
from ray_tpu_torch.scripts import check_concurrency as cc

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- the gate

def test_package_is_clean():
    problems = cc.check(_REPO)
    assert problems == [], "\n".join(problems)


def test_every_waiver_carries_a_reason():
    waivers = cc.waiver_report(_REPO)
    assert waivers, "expected the known deliberate waivers to exist"
    for kind, rel, lineno, reason in waivers:
        assert reason.strip(), f"empty waiver reason at {rel}:{lineno}"


def test_scanner_sees_known_locks_and_ops():
    """A broken scanner must not vacuously pass the gate."""
    files = cc._walk_files(os.path.join(_REPO, "ray_tpu_torch"))
    reg = cc.parse_locksan_registry(files)
    for name in ("gcs.plane", "node.res", "conn.queue", "client.ref",
                 "store.entries", "coll.mailbox", "telemetry.shard"):
        assert name in reg, name
    _raw, sites, bindings = cc.collect_lock_sites(files)
    assert len(sites) >= 30
    assert bindings[("_private/gcs.py", "GlobalControlPlane",
                     "_lock")] == "gcs.plane"
    ops = cc._collect_protocol_ops(files)
    for op in ("SUBMIT_TASK", "TASK_DONE", "EXECUTE_TASK", "COLL_ROUTE",
               "RETURN_LEASED", "SHUTDOWN", "ACTOR_EXIT"):
        assert op in ops, op


def test_field_scanner_sees_known_fields():
    """Anti-vacuity for rule (h): the FIELDS registry is populated and
    the scanner parses it — a parse regression must not silently turn
    the guarded-by gate into a no-op."""
    files = cc._walk_files(os.path.join(_REPO, "ray_tpu_torch"))
    fields = cc.parse_fields_registry(files)
    assert len(fields) >= 50, len(fields)
    for key, want in (
            ("gcs.GlobalControlPlane.nodes", "gcs.plane"),
            ("gcs.GlobalControlPlane.obj_provenance", "gcs.plane"),
            ("client.CoreClient._futures", "client.req"),
            ("client.CoreClient._ref_counts", "client.ref|static"),
            ("node.NodeService._pending", "thread:rtpu-dispatch"),
            ("node.NodeService.resources_available", "node.res"),
            ("coll_transport._slots", "coll.mailbox"),
            ("telemetry._Shard.counters", "telemetry.shard|static"),
            ("object_store.ObjectStore._entries",
             "store.entries|static"),
            ("history.MetricsHistory.levels", "gcs.plane"),
            ("protocol.Connection._outq", "conn.queue|static"),
    ):
        assert fields.get(key) == want, (key, fields.get(key))
    # every guard class is represented
    specs = set(fields.values())
    assert any(s.startswith("thread:") for s in specs)
    assert any(s.startswith("atomic:") for s in specs)


# ------------------------------------------------ fixture-repo harness

_DESIGN_OK = """# x
## Threading model & lock hierarchy

| Lock | Module | Level | Kind | Protects |
|---|---|---|---|---|
| `t.a` | `mod.py` | 10 | lock | a |
| `t.b` | `mod.py` | 20 | lock | b |

## next
"""

_README_OK = """# x
## Configuration

| Knob | Env override | Default | What it does |
|---|---|---|---|
| `some_knob` | `RTPU_SOME_KNOB` | `1` | x |

## next
"""

_CONFIG_SRC = '_CONFIG_DEFS = {"some_knob": (int, 1, "x")}\n'


def _mk_repo(tmp_path, files, design=_DESIGN_OK, readme=_README_OK):
    pkg = tmp_path / "ray_tpu_torch"
    pkg.mkdir()
    base = {
        "locksan.py": ('REGISTRY = {"t.a": ("mod.py", "lock", 10, "a"),'
                       ' "t.b": ("mod.py", "lock", 20, "b")}\n'),
        "config.py": _CONFIG_SRC,
    }
    base.update(files)
    for rel, src in base.items():
        path = pkg / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    (pkg / "DESIGN.md").write_text(design)
    (tmp_path / "README.md").write_text(readme)
    return str(tmp_path)


_MOD_HEADER = (
    "class C:\n"
    "    def __init__(self):\n"
    "        self._a = locksan.lock(\"t.a\")\n"
    "        self._b = locksan.lock(\"t.b\")\n")


def test_fixture_baseline_is_clean(tmp_path):
    root = _mk_repo(tmp_path, {"mod.py": _MOD_HEADER})
    problems = [p for p in cc.check(root)
                if "scanner is broken" not in p
                and "reader root" not in p
                and "no op constants" not in p
                and "no handler" not in p]
    assert problems == [], "\n".join(problems)


def test_undeclared_raw_lock_flagged(tmp_path):
    root = _mk_repo(tmp_path, {
        "mod.py": _MOD_HEADER + (
            "    def extra(self):\n"
            "        self._c = threading.Lock()\n")})
    problems = cc.check(root)
    assert any("raw threading.Lock()" in p for p in problems), problems


def test_unregistered_factory_name_flagged(tmp_path):
    root = _mk_repo(tmp_path, {
        "mod.py": _MOD_HEADER.replace('"t.b"', '"t.mystery"')})
    problems = cc.check(root)
    assert any("'t.mystery' is not declared" in p for p in problems)
    # and the now-unconstructed registry row is stale
    assert any("'t.b'" in p and "stale registry row" in p
               for p in problems)


def test_inversion_cycle_flagged(tmp_path):
    src = _MOD_HEADER + (
        "    def f(self):\n"
        "        with self._a:\n"
        "            with self._b:\n"
        "                pass\n"
        "    def g(self):\n"
        "        with self._b:\n"
        "            self.h()\n"
        "    def h(self):\n"
        "        with self._a:\n"
        "            pass\n")
    root = _mk_repo(tmp_path, {"mod.py": src})
    problems = cc.check(root)
    # g->h propagates the a-under-b edge through the call graph:
    # both the downhill edge and the a->b->a cycle are reported
    assert any("violates the declared strictly-increasing hierarchy"
               in p for p in problems), problems
    assert any("lock-order cycle" in p and "t.a" in p and "t.b" in p
               for p in problems), problems


def test_self_deadlock_on_plain_lock_flagged(tmp_path):
    src = _MOD_HEADER + (
        "    def f(self):\n"
        "        with self._a:\n"
        "            self.g()\n"
        "    def g(self):\n"
        "        with self._a:\n"
        "            pass\n")
    root = _mk_repo(tmp_path, {"mod.py": src})
    problems = cc.check(root)
    assert any("self-deadlock" in p for p in problems), problems


def test_send_under_lock_flagged_and_waivable(tmp_path):
    src = _MOD_HEADER + (
        "    def f(self):\n"
        "        with self._a:\n"
        "            self.conn.send((1, 2))\n"
        "    def ok(self):\n"
        "        with self._a:\n"
        "            self.conn.send((1, 2))  "
        "# lint: allow-under-lock(frame order is the invariant)\n")
    root = _mk_repo(tmp_path, {"mod.py": src})
    problems = cc.check(root)
    hits = [p for p in problems if "blocking .send()" in p]
    assert len(hits) == 1, problems     # f flagged, ok's waiver honored
    waivers = cc.waiver_report(root)
    assert any(r == "frame order is the invariant"
               for _k, _rel, _ln, r in waivers)


def test_empty_waiver_reason_flagged(tmp_path):
    src = _MOD_HEADER + (
        "    def f(self):\n"
        "        with self._a:\n"
        "            self.conn.send((1, 2))  "
        "# lint: allow-under-lock()\n")
    root = _mk_repo(tmp_path, {"mod.py": src})
    problems = cc.check(root)
    assert any("empty reason" in p for p in problems), problems


def test_gcs_rpc_under_lock_flagged(tmp_path):
    src = _MOD_HEADER + (
        "    def f(self):\n"
        "        with self._a:\n"
        "            self.gcs.kv_get(b'k')\n")
    root = _mk_repo(tmp_path, {"mod.py": src})
    problems = cc.check(root)
    assert any("synchronous GCS RPC .kv_get()" in p
               for p in problems), problems


def test_reader_calling_dispatcher_only_flagged(tmp_path):
    node_src = (
        "class NodeService:\n"
        "    def _handle_direct(self, key, op, payload):\n"
        "        self._dispatch()\n"
        "    # concurrency: dispatcher-only\n"
        "    def _dispatch(self):\n"
        "        pass\n")
    root = _mk_repo(tmp_path, {"_private/node.py": node_src,
                               "mod.py": _MOD_HEADER})
    problems = cc.check(root)
    assert any("calls dispatcher-only function '_dispatch'" in p
               for p in problems), problems


def test_reader_blocking_wait_flagged(tmp_path):
    node_src = (
        "class NodeService:\n"
        "    def _handle_direct(self, key, op, payload):\n"
        "        self._collect()\n"
        "    def _collect(self):\n"
        "        fut.result(timeout=1)\n")
    root = _mk_repo(tmp_path, {"_private/node.py": node_src,
                               "mod.py": _MOD_HEADER})
    problems = cc.check(root)
    assert any("blocks in .result()" in p
               and "_handle_direct -> _collect" in p
               for p in problems), problems


_PROTO_FIXTURE = (
    "OP_A = 1\n"
    "OP_B = 2\n"
    "OP_C = 3            # lint: allow-op(one-sided by design)\n"
)


def test_protocol_arity_mismatch_flagged(tmp_path):
    sender = ("from . import protocol as P\n"
              "def s1(conn, x):\n"
              "    conn.send((P.OP_A, (x, x)))\n"
              "def s2(conn, x):\n"
              "    conn.send((P.OP_A, (x, x, x)))\n"
              "def s3(conn, x):\n"
              "    conn.send((P.OP_B, (x, x)))\n")
    handler = ("from . import protocol as P\n"
               "def handle(op, payload):\n"
               "    if op == P.OP_A:\n"
               "        a, b = payload\n"
               "    elif op == P.OP_B:\n"
               "        a, b, c = payload\n")
    root = _mk_repo(tmp_path, {"_private/protocol.py": _PROTO_FIXTURE,
                               "_private/snd.py": sender,
                               "_private/hnd.py": handler,
                               "mod.py": _MOD_HEADER})
    problems = cc.check(root)
    assert any("OP_A: send sites disagree" in p for p in problems)
    assert any("OP_B" in p and "2-tuple payload" in p
               and "unpacks 3" in p for p in problems), problems
    # the allow-op'd one-sided op stays silent
    assert not any("OP_C" in p for p in problems)


def test_dead_and_unsent_ops_flagged(tmp_path):
    handler = ("from . import protocol as P\n"
               "def handle(op, payload):\n"
               "    if op == P.OP_B:\n"
               "        pass\n")
    root = _mk_repo(tmp_path, {"_private/protocol.py": _PROTO_FIXTURE,
                               "_private/hnd.py": handler,
                               "mod.py": _MOD_HEADER})
    problems = cc.check(root)
    assert any("OP_A: dead" in p for p in problems), problems
    assert any("OP_B: handled but never sent" in p for p in problems)


def test_config_knob_drift_flagged(tmp_path):
    readme = _README_OK.replace("`RTPU_SOME_KNOB`", "`RTPU_WRONG`")
    root = _mk_repo(tmp_path, {"mod.py": _MOD_HEADER}, readme=readme)
    problems = cc.check(root)
    assert any("env column says RTPU_WRONG" in p for p in problems)


def test_undocumented_knob_and_typo_read_flagged(tmp_path):
    src = _MOD_HEADER + (
        "    def f(self):\n"
        "        return CONFIG.sme_knob\n")   # typo'd read
    readme = _README_OK.replace(
        "| `some_knob` | `RTPU_SOME_KNOB` | `1` | x |\n", "")
    root = _mk_repo(tmp_path, {"mod.py": src}, readme=readme)
    problems = cc.check(root)
    assert any("'some_knob'" in p and "not documented" in p
               for p in problems), problems
    assert any("CONFIG.sme_knob is not a defined knob" in p
               for p in problems), problems


def test_design_table_drift_flagged(tmp_path):
    design = _DESIGN_OK.replace("| `t.b` | `mod.py` | 20 | lock | b |",
                                "| `t.b` | `mod.py` | 5 | lock | b |")
    root = _mk_repo(tmp_path, {"mod.py": _MOD_HEADER}, design=design)
    problems = cc.check(root)
    assert any("'t.b'" in p and "DESIGN.md row" in p
               and "disagrees" in p for p in problems), problems


# ------------------------------------------------------ locksan runtime

@pytest.fixture
def san_state():
    """Snapshot/restore sanitizer mode + violation list around a test."""
    prev_mode = locksan.set_mode("log")
    locksan.clear_violations()
    yield
    locksan.set_mode(prev_mode)
    locksan.clear_violations()


def test_locksan_enabled_under_tier1():
    # conftest sets RTPU_LOCKSAN=1 before importing ray_tpu_torch, so the
    # whole suite doubles as a sanitizer run
    assert locksan.enabled()


def test_locksan_detects_ab_ba_deadlock_before_wedge(san_state):
    """Two threads take t1: A then B, t2: B then A. In raise mode the
    second thread's acquire is REFUSED at the inversion, so both
    threads finish instead of wedging — the sanitizer reports the
    deadlock before it happens."""
    a = locksan.lock("test.dead.a")
    b = locksan.lock("test.dead.b")
    locksan.set_mode("raise")
    hit = []
    barrier = threading.Barrier(2, timeout=5)

    def t1():
        with a:
            barrier.wait()          # both hold their first lock
            time.sleep(0.05)
            try:
                with b:
                    pass
            except locksan.LockOrderViolation as e:
                hit.append(("t1", e))

    def t2():
        with b:
            barrier.wait()
            time.sleep(0.05)
            try:
                with a:
                    pass
            except locksan.LockOrderViolation as e:
                hit.append(("t2", e))

    th1 = threading.Thread(target=t1, daemon=True)
    th2 = threading.Thread(target=t2, daemon=True)
    th1.start()
    th2.start()
    th1.join(timeout=10)
    th2.join(timeout=10)
    assert not th1.is_alive() and not th2.is_alive(), \
        "threads wedged — the sanitizer failed to break the deadlock"
    assert hit, "no order-cycle violation raised"
    recs = [v for v in locksan.violations()
            if v["kind"] == "order-cycle"]
    assert recs and "test.dead" in recs[0]["message"]


def test_locksan_hierarchy_violation(san_state):
    locksan.REGISTRY["test.low"] = ("t.py", "lock", 1, "x")
    locksan.REGISTRY["test.high"] = ("t.py", "lock", 2, "x")
    try:
        low = locksan.lock("test.low")
        high = locksan.lock("test.high")
        with high:
            with low:               # downhill: declared order is low->high
                pass
        v = [x for x in locksan.violations() if x["kind"] == "hierarchy"]
        assert v and "test.low" in v[0]["message"]
        locksan.clear_violations()
        # fresh instances: the first pair's order graph now (correctly)
        # holds the high->low edge, so reusing them uphill would be the
        # observed-both-orders inversion
        low2 = locksan.lock("test.low")
        high2 = locksan.lock("test.high")
        with low2:
            with high2:             # uphill: clean
                pass
        assert not locksan.violations()
    finally:
        del locksan.REGISTRY["test.low"]
        del locksan.REGISTRY["test.high"]


def test_locksan_plain_lock_self_reacquire_reported(san_state):
    lk = locksan.lock("test.selfdead")
    locksan.set_mode("raise")
    with lk:
        with pytest.raises(locksan.LockOrderViolation):
            lk.acquire()


def test_locksan_rlock_reentry_clean(san_state):
    rl = locksan.rlock("test.re")
    with rl:
        with rl:
            pass
    assert not locksan.violations()


def test_locksan_condition_releases_held_state_across_wait(san_state):
    """Condition.wait releases through the wrapper, so a waiter parked
    on the mailbox condvar is NOT 'holding' the lock — the depositing
    thread's acquire stays clean (the coll_transport pattern)."""
    lk = locksan.lock("test.cv")
    cv = locksan.condition("test.cv", lk)
    got = []

    def waiter():
        with cv:
            while not got:
                cv.wait(timeout=5)
            got.append("woke")

    th = threading.Thread(target=waiter, daemon=True)
    th.start()
    time.sleep(0.05)
    with cv:
        got.append("x")
        cv.notify_all()
    th.join(timeout=5)
    assert not th.is_alive() and "woke" in got
    assert not locksan.violations()


def test_locksan_disabled_returns_plain_primitives(monkeypatch):
    monkeypatch.setattr(locksan, "_ENABLED", False)
    lk = locksan.lock("whatever")
    assert type(lk) is type(threading.Lock())
    rl = locksan.rlock("whatever")
    assert "RLock" in type(rl).__name__


def test_try_lock_and_timeout_acquire_pass_through(san_state):
    """The transport's opportunistic drainer pattern: try-locks and
    timed acquires never trip checks and keep held-state exact."""
    a = locksan.lock("test.try.a")
    assert a.acquire(blocking=False)
    assert not a.acquire(blocking=False)
    a.release()
    assert a.acquire(timeout=0.5)
    assert a.locked()
    a.release()
    assert not locksan.violations()


# ------------------------------------------- rule (h): guarded-by fields

_LOCKSAN_FIELDS = (
    'REGISTRY = {"t.a": ("mod.py", "lock", 10, "a"),'
    ' "t.b": ("mod.py", "lock", 20, "b")}\n'
    'FIELDS = {"mod.C._table": "t.a"}\n')

_DESIGN_FIELDS = """# x
## Threading model & lock hierarchy

| Lock | Module | Level | Kind | Protects |
|---|---|---|---|---|
| `t.a` | `mod.py` | 10 | lock | a |
| `t.b` | `mod.py` | 20 | lock | b |

## Shared-state ownership map

| Field | Guard | Writer threads |
|---|---|---|
| `mod.C._table` | `t.a` | any |

## next
"""

_GUARDED_MOD = (
    "class C:\n"
    "    def __init__(self):\n"
    "        self._a = locksan.lock(\"t.a\")\n"
    "        self._b = locksan.lock(\"t.b\")\n"
    "        self._table = {}\n")


def _mk_field_repo(tmp_path, mod_src, locksan_src=_LOCKSAN_FIELDS,
                   design=_DESIGN_FIELDS, extra=None):
    tmp_path.mkdir(parents=True, exist_ok=True)
    files = {"locksan.py": locksan_src, "mod.py": mod_src}
    files.update(extra or {})
    return _mk_repo(tmp_path, files, design=design)


def _field_problems(root):
    return [p for p in cc.check(root)
            if "fieldsan.guarded" in p or "field " in p
            or "race-ok" in p or "requires" in p
            or "ownership" in p or "candidate" in p]


def test_field_fixture_baseline_clean(tmp_path):
    src = _GUARDED_MOD + (
        "    def put(self, k, v):\n"
        "        with self._a:\n"
        "            self._table[k] = v\n")
    root = _mk_field_repo(tmp_path, src)
    probs = _field_problems(root)
    # the fixture class deliberately lacks @fieldsan.guarded coverage
    # only when instrumentation is the thing under test; here it has it?
    # -> it doesn't, so filter that one structural finding out
    probs = [p for p in probs if "fieldsan.guarded" not in p]
    assert probs == [], probs


def test_unguarded_write_flagged(tmp_path):
    src = _GUARDED_MOD + (
        "    def put(self, k, v):\n"
        "        self._table[k] = v\n")
    root = _mk_field_repo(tmp_path, src)
    probs = cc.check(root)
    assert any("write to mod.C._table" in p
               and "with no lock held" in p for p in probs), probs


def test_wrong_lock_write_flagged(tmp_path):
    src = _GUARDED_MOD + (
        "    def put(self, k, v):\n"
        "        with self._b:\n"
        "            self._table[k] = v\n")
    root = _mk_field_repo(tmp_path, src)
    probs = cc.check(root)
    assert any("write to mod.C._table" in p and "guarded by 't.a'" in p
               and "under t.b" in p for p in probs), probs


def test_mutator_call_is_a_write(tmp_path):
    src = _GUARDED_MOD + (
        "    def drop(self, k):\n"
        "        self._table.pop(k, None)\n")
    root = _mk_field_repo(tmp_path, src)
    probs = cc.check(root)
    assert any("write to mod.C._table" in p for p in probs), probs


def test_global_rebind_is_a_write(tmp_path):
    # `global X; X = ...` would replace a fieldsan proxy with a plain
    # container at runtime — rule (h) must see the rebind as a write
    locksan_src = _LOCKSAN_FIELDS.replace(
        '"mod.C._table": "t.a"', '"mod._gtable": "t.a"')
    design = _DESIGN_FIELDS.replace(
        "| `mod.C._table` | `t.a` | any |",
        "| `mod._gtable` | `t.a` | any |")
    src = (_GUARDED_MOD
           + "_gtable = {}\n"
             "fieldsan.instrument_module(globals(), \"mod\")\n"
             "def reset():\n"
             "    global _gtable\n"
             "    _gtable = {}\n")
    root = _mk_field_repo(tmp_path, src, locksan_src=locksan_src,
                          design=design)
    probs = cc.check(root)
    assert any("write to mod._gtable" in p for p in probs), probs


def test_race_ok_waiver_honored_and_counted(tmp_path):
    src = _GUARDED_MOD + (
        "    def put(self, k, v):\n"
        "        self._table[k] = v  # lint: race-ok(single-threaded "
        "bootstrap window)\n")
    root = _mk_field_repo(tmp_path, src)
    probs = cc.check(root)
    assert not any("write to mod.C._table" in p for p in probs), probs
    waivers = cc.waiver_report(root)
    assert any(k == "race-ok" and "bootstrap window" in r
               for k, _rel, _ln, r in waivers), waivers


def test_race_ok_empty_reason_flagged(tmp_path):
    src = _GUARDED_MOD + (
        "    def put(self, k, v):\n"
        "        self._table[k] = v  # lint: race-ok()\n")
    root = _mk_field_repo(tmp_path, src)
    probs = cc.check(root)
    assert any("race-ok waiver with an empty reason" in p
               for p in probs), probs


def test_requires_annotation_and_call_site_check(tmp_path):
    src = _GUARDED_MOD + (
        "    # concurrency: requires(t.a)\n"
        "    def _put_locked(self, k, v):\n"
        "        self._table[k] = v\n"
        "    def ok(self, k, v):\n"
        "        with self._a:\n"
        "            self._put_locked(k, v)\n"
        "    def bad(self, k, v):\n"
        "        self._put_locked(k, v)\n")
    root = _mk_field_repo(tmp_path, src)
    probs = cc.check(root)
    # the annotated function's write itself is clean...
    assert not any("write to mod.C._table" in p for p in probs), probs
    # ...and exactly the lock-less call site (in bad(), line 13) is
    # flagged — ok()'s locked call stays silent
    hits = [p for p in probs if "requires(t.a)" in p
            and "'_put_locked'" in p]
    assert hits == ["mod.py:13: calls '_put_locked' (declared "
                    "`requires(t.a)`) without holding 't.a'"], probs


def test_stale_field_row_flagged(tmp_path):
    locksan_src = _LOCKSAN_FIELDS.replace(
        '"mod.C._table": "t.a"',
        '"mod.C._table": "t.a", "mod.C._ghost": "t.a"')
    design = _DESIGN_FIELDS.replace(
        "| `mod.C._table` | `t.a` | any |",
        "| `mod.C._table` | `t.a` | any |\n"
        "| `mod.C._ghost` | `t.a` | any |")
    root = _mk_field_repo(tmp_path, _GUARDED_MOD,
                          locksan_src=locksan_src, design=design)
    probs = cc.check(root)
    assert any("mod.C._ghost" in p and "stale registry row" in p
               for p in probs), probs


def test_unknown_guard_flagged(tmp_path):
    locksan_src = _LOCKSAN_FIELDS.replace('"t.a"}', '"t.mystery"}')
    design = _DESIGN_FIELDS.replace("| `mod.C._table` | `t.a` |",
                                    "| `mod.C._table` | `t.mystery` |")
    root = _mk_field_repo(tmp_path, _GUARDED_MOD,
                          locksan_src=locksan_src, design=design)
    probs = cc.check(root)
    assert any("guard 't.mystery' is not a declared lock" in p
               for p in probs), probs


def test_missing_and_stale_ownership_rows_flagged(tmp_path):
    # the declared field's row replaced by a row for a ghost field:
    # the registry row is now undocumented AND the doc row is stale
    design = _DESIGN_FIELDS.replace(
        "| `mod.C._table` | `t.a` | any |",
        "| `mod.C._gone` | `t.a` | any |")
    root = _mk_field_repo(tmp_path, _GUARDED_MOD, design=design)
    probs = cc.check(root)
    assert any("mod.C._table" in p
               and "missing from the DESIGN.md ownership map" in p
               for p in probs), probs
    assert any("'mod.C._gone'" in p and "stale doc row" in p
               for p in probs), probs
    # an emptied table is its own finding
    design = _DESIGN_FIELDS.replace(
        "| `mod.C._table` | `t.a` | any |\n", "")
    root2 = _mk_field_repo(tmp_path / "empty", _GUARDED_MOD,
                           design=design)
    probs2 = cc.check(root2)
    assert any("no 'Shared-state ownership map' table" in p
               for p in probs2), probs2


def test_ownership_guard_drift_flagged(tmp_path):
    design = _DESIGN_FIELDS.replace("| `mod.C._table` | `t.a` |",
                                    "| `mod.C._table` | `t.b` |")
    root = _mk_field_repo(tmp_path, _GUARDED_MOD, design=design)
    probs = cc.check(root)
    assert any("DESIGN.md guard column" in p and "disagrees" in p
               for p in probs), probs


def test_missing_guarded_decorator_flagged(tmp_path):
    # the real package decorates every declared class; a fixture class
    # with declared fields and no decorator must be a finding, or the
    # runtime sanitizer silently never sees the field
    root = _mk_field_repo(tmp_path, _GUARDED_MOD + (
        "    def put(self, k, v):\n"
        "        with self._a:\n"
        "            self._table[k] = v\n"))
    probs = cc.check(root)
    assert any("lacks @fieldsan.guarded" in p for p in probs), probs
    # and adding the decorator clears it
    root2 = _mk_field_repo(tmp_path.joinpath("x"),
                           "@fieldsan.guarded\n" + _GUARDED_MOD + (
                               "    def put(self, k, v):\n"
                               "        with self._a:\n"
                               "            self._table[k] = v\n"))
    probs2 = cc.check(root2)
    assert not any("lacks @fieldsan.guarded" in p for p in probs2), probs2


def test_inference_flags_undeclared_shared_field(tmp_path):
    # client.py is a target module and CoreClient.handle_message a
    # reader root; _hits is also mutated from a Thread-target loop ->
    # two thread entry points reach writers of an UNDECLARED attr
    client_src = (
        "import threading\n"
        "class CoreClient:\n"
        "    def __init__(self):\n"
        "        self._hits = {}\n"
        "        t = threading.Thread(target=self._loop)\n"
        "    def handle_message(self, op, payload):\n"
        "        self._hits[op] = 1\n"
        "    def _loop(self):\n"
        "        self._hits.clear()\n")
    root = _mk_field_repo(tmp_path, _GUARDED_MOD,
                          extra={"_private/client.py": client_src})
    probs = cc.check(root)
    assert any("undeclared shared-field candidate client.CoreClient."
               "_hits" in p for p in probs), probs
    # declaring it (any guard class) silences the inference
    locksan_src = _LOCKSAN_FIELDS.replace(
        '"mod.C._table": "t.a"',
        '"mod.C._table": "t.a", '
        '"client.CoreClient._hits": "atomic:fixture"')
    design = _DESIGN_FIELDS.replace(
        "| `mod.C._table` | `t.a` | any |",
        "| `mod.C._table` | `t.a` | any |\n"
        "| `client.CoreClient._hits` | `atomic` | lock-free fixture |")
    root2 = _mk_field_repo(tmp_path.joinpath("y"), _GUARDED_MOD,
                           locksan_src=locksan_src, design=design,
                           extra={"_private/client.py": client_src})
    probs2 = cc.check(root2)
    assert not any("candidate client.CoreClient._hits" in p
                   for p in probs2), probs2


# ----------------------------------------------------- fieldsan runtime

@pytest.fixture
def fieldsan_state():
    prev = fieldsan.set_mode("log")
    fieldsan.clear_violations()
    yield
    fieldsan.set_mode(prev)
    fieldsan.clear_violations()


def test_fieldsan_enabled_under_tier1():
    # conftest sets RTPU_FIELDSAN=1 before importing ray_tpu_torch: the whole
    # suite doubles as a guarded-by sanitizer run
    assert fieldsan.enabled()


def _guarded_test_class(guard_spec):
    """Build + instrument a class with one declared field 'counter'."""
    class _Shared:
        def __init__(self):
            self.counter = 0
            self.table = {}

    key = f"{_Shared.__module__.rsplit('.', 1)[-1]}._Shared"
    locksan.FIELDS[f"{key}.counter"] = guard_spec
    locksan.FIELDS[f"{key}.table"] = guard_spec
    try:
        cls = fieldsan.guarded(_Shared)
    finally:
        del locksan.FIELDS[f"{key}.counter"]
        del locksan.FIELDS[f"{key}.table"]
    return cls


@pytest.mark.skipif(not fieldsan.enabled(), reason="RTPU_FIELDSAN off")
def test_fieldsan_seeded_two_thread_race_caught_and_prevented(
        fieldsan_state):
    """The acceptance race: an unguarded read-modify-write
    interleaved with a guarded writer. WITHOUT instrumentation the
    seeded interleaving demonstrably loses the guarded update (a real
    race, deterministic via events); WITH fieldsan in raise mode the
    stale write is REFUSED before it applies — the guarded value
    survives and both threads survive."""
    lk = locksan.lock("test.fieldsan.race")

    def run(obj, hit):
        ev1, ev2 = threading.Event(), threading.Event()

        def t1():                    # unguarded RMW, seeded preemption
            v = obj.counter          # stale read
            ev1.set()
            assert ev2.wait(5)
            try:
                obj.counter = v + 1  # lost-update write
            except fieldsan.FieldRaceViolation as e:
                hit.append(e)

        def t2():                    # disciplined writer
            assert ev1.wait(5)
            with lk:
                obj.counter = 100
            ev2.set()

        th1 = threading.Thread(target=t1, daemon=True)
        th2 = threading.Thread(target=t2, daemon=True)
        th1.start()
        th2.start()
        th1.join(timeout=10)
        th2.join(timeout=10)
        assert not th1.is_alive() and not th2.is_alive()

    # 1) instrumentation removed: the SAME interleaving loses the
    #    guarded update — this is a real race, not a lint artifact
    class _Plain:
        def __init__(self):
            self.counter = 0

    plain, hit = _Plain(), []
    run(plain, hit)
    assert not hit
    assert plain.counter == 1, "expected the lost-update outcome"

    # 2) fieldsan raise mode: the stale write is refused BEFORE it
    #    applies; the guarded value survives
    cls = _guarded_test_class("test.fieldsan.race")
    fieldsan.set_mode("raise")
    obj, hit = cls(), []
    run(obj, hit)
    assert len(hit) == 1, "the racing write was not refused"
    assert obj.counter == 100, "the refused write still applied"
    recs = [v for v in fieldsan.violations() if v["kind"] == "race"]
    assert recs, "no race violation recorded"
    assert recs[0]["stack"], "missing racing-side stack"
    assert recs[0]["other_thread"], "missing other side"


@pytest.mark.skipif(not fieldsan.enabled(), reason="RTPU_FIELDSAN off")
def test_fieldsan_guarded_discipline_is_silent(fieldsan_state):
    lk = locksan.lock("test.fieldsan.clean")
    cls = _guarded_test_class("test.fieldsan.clean")
    obj = cls()
    done = []

    def worker(n):
        for i in range(200):
            with lk:
                obj.counter += 1
                obj.table[(n, i)] = i
        done.append(n)

    ths = [threading.Thread(target=worker, args=(n,), daemon=True)
           for n in range(4)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=10)
    assert len(done) == 4 and obj.counter == 800
    assert not fieldsan.violations()


@pytest.mark.skipif(not fieldsan.enabled(), reason="RTPU_FIELDSAN off")
def test_fieldsan_thread_confined_write_flagged(fieldsan_state):
    cls = _guarded_test_class("thread:my-owner")
    obj = cls()                      # __init__ writes are exempt
    ok = []

    def owner():
        obj.counter = 1              # matching thread name: clean
        ok.append(True)

    th = threading.Thread(target=owner, name="my-owner-0", daemon=True)
    th.start()
    th.join(timeout=5)
    assert ok and not fieldsan.violations()
    obj.counter = 2                  # MainThread: confinement violation
    recs = [v for v in fieldsan.violations()
            if v["kind"] == "confined-write"]
    assert recs and "my-owner" in recs[0]["message"]


@pytest.mark.skipif(not fieldsan.enabled(), reason="RTPU_FIELDSAN off")
def test_fieldsan_container_proxies_stay_transparent(fieldsan_state):
    import pickle

    cls = _guarded_test_class("test.fieldsan.proxy")
    obj = cls()
    obj.table["k"] = [1, 2]
    assert isinstance(obj.table, dict)
    assert pickle.loads(pickle.dumps(obj.table)) == {"k": [1, 2]}
    assert type(pickle.loads(pickle.dumps(obj.table))) is dict
    import json
    assert json.loads(json.dumps({"t": obj.table})) == {"t": {"k": [1, 2]}}


def test_fieldsan_free_when_off():
    """Structural half of the fieldsan_ab gate: with the sanitizer off,
    @fieldsan.guarded is a pure pass-through (same class object, no
    descriptors), so declaring ownership costs nothing in production."""
    class _Off:
        def __init__(self):
            self.x = 0

    if fieldsan.enabled():
        # simulate the off path
        orig = fieldsan._ENABLED
        fieldsan._ENABLED = False
        try:
            out = fieldsan.guarded(_Off)
        finally:
            fieldsan._ENABLED = orig
    else:
        out = fieldsan.guarded(_Off)
    assert out is _Off
    assert "x" not in vars(_Off)
    assert _Off.__init__ is out.__init__


# -------------------------- regressions for fieldsan-found races

def test_reply_future_resolution_is_exactly_once_vs_fail_all():
    """Regression (fieldsan finding): CoreClient.handle_message popped
    `_futures` on the reader thread WITHOUT client.req while _fail_all
    (send-error path, another thread) snapshotted-and-cleared under it
    — both sides could grab the same future, and set_result after
    set_exception raised InvalidStateError on the process's only
    reply-routing thread. Now every pop goes through _take_future under
    the lock: each future resolves exactly once, no thread dies."""
    from ray_tpu_torch._private import protocol as P
    from ray_tpu_torch._private.client import CoreClient
    from ray_tpu_torch._private.ids import JobID, WorkerID

    class _Conn:
        on_send_error = None

        def send(self, msg):
            pass

        def close(self):
            pass

    client = CoreClient(_Conn(), JobID.nil(), WorkerID.from_random(),
                        P.KIND_DRIVER)
    errors = []
    for _round in range(40):
        client._closed.clear()
        futs = [client._request(P.KV_GET, lambda rid: (rid, b"k"))
                for _ in range(16)]
        with client._req_lock:
            ids = list(client._futures)

        def resolver():
            try:
                for rid in ids:
                    client.handle_message(P.KV_REPLY, (rid, b"v"))
            except BaseException as e:   # noqa: BLE001
                errors.append(e)

        def failer():
            try:
                client._fail_all(ConnectionError("conn lost"))
            except BaseException as e:   # noqa: BLE001
                errors.append(e)

        t1 = threading.Thread(target=resolver, daemon=True)
        t2 = threading.Thread(target=failer, daemon=True)
        t1.start()
        t2.start()
        t1.join(timeout=10)
        t2.join(timeout=10)
        assert not t1.is_alive() and not t2.is_alive()
        for f in futs:
            assert f.done(), "future neither resolved nor failed"
    assert not errors, errors


def test_prestart_spawn_runs_on_dispatcher(monkeypatch):
    """Regression (fieldsan finding): init()'s warm-pool spawn ran
    _spawn_worker on the MAIN thread while the already-live dispatcher
    handled early REGISTERs — `_num_starting += 1` vs the dispatcher's
    decrement was a lost-update race that permanently skewed the
    startup-concurrency budget. The warm pool is now posted to the
    dispatcher; every spawn must run there."""
    import ray_tpu_torch
    from ray_tpu_torch._private.node import NodeService

    names = []
    orig = NodeService._spawn_worker

    def spy(self, *a, **k):
        names.append(threading.current_thread().name)
        return orig(self, *a, **k)

    monkeypatch.setattr(NodeService, "_spawn_worker", spy)
    ray_tpu_torch.init(num_cpus=2)
    try:
        @ray_tpu_torch.remote
        def one():
            return 1

        assert ray_tpu_torch.get(one.remote(), timeout=60) == 1
    finally:
        ray_tpu_torch.shutdown()
    assert names, "no worker was ever spawned"
    assert all("rtpu-dispatch" in n for n in names), names


def test_conn_key_mint_is_atomic_across_accept_threads(tmp_path):
    """Regression (guarded-by audit): conn keys are minted on BOTH
    accept threads (unix + tcp); the former `key = n; n += 1` could
    mint duplicates and alias two connections in _conns. The
    itertools.count mint must stay unique under thread pressure."""
    from ray_tpu_torch._private.gcs import GlobalControlPlane
    from ray_tpu_torch._private.node import NodeService

    node = NodeService(GlobalControlPlane(), str(tmp_path),
                       {"CPU": 1.0})
    try:
        keys: list = []

        def mint():
            got = [next(node._conn_keys) for _ in range(500)]
            keys.extend(got)

        ths = [threading.Thread(target=mint, daemon=True)
               for _ in range(8)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=10)
        assert len(keys) == 4000
        assert len(set(keys)) == 4000, "duplicate conn keys minted"
    finally:
        node.store.shutdown()
