# A copy of tests/test_memory_introspection.py on ray_tpu_torch's runtime: the
# same tests under the same names, with the port's names (ray_tpu_torch,
# rtpt_*, GPU slots) and the fixtures of torch_runtime_fixtures.py, which also
# hold the port's locksan and fieldsan to no violation at teardown.
# Docstrings leave out the JAX package's issue history.
"""Object ownership & memory introspection plane.

Reference surface: ``ray memory`` — per-ref creation callsites
(``RAY_record_ref_creation_sites``) + the ReferenceCounter's ref-type
classification — plus the leak sweep and OOM autopsy built on top.
The acceptance scenario: a 2-node cluster where the driver's put is
captured by a pending task AND a nested return groups under the put's
callsite with both ref types; killing the holder's node flips it to a
leak finding (gauge > 0, doctor problem line names the callsite).
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import state as rstate
from ray_tpu_torch.state.api import shape_leaks, shape_objects, summarize_memory_rows
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)

THIS_FILE = "test_torch_memory_introspection.py"


# ------------------------------------------------------------ unit: shaping

def test_shape_objects_tolerates_missing_keys():
    """Records missing optional keys (node/size of a held-but-unsealed
    object; older minimal rows) must shape, not crash
    (``rec["size"]`` was bare indexing)."""
    rows = shape_objects([
        {"object_id": b"\x01" * 14},                      # bare minimum
        {"object_id": b"\x02" * 14, "node_id": None, "size": None},
        {"object_id": b"\x03" * 14, "node_id": b"\x09" * 14, "size": 7,
         "callsite": "a.py:1", "ref_types": {"LOCAL_REFERENCE": 2}},
    ])
    assert len(rows) == 3
    assert rows[0]["size"] is None and rows[0]["node_id"] is None
    assert rows[0]["ref_types"] == {}
    assert rows[2]["size"] == 7
    assert rows[2]["ref_types"] == {"LOCAL_REFERENCE": 2}


def test_summarize_memory_rows_groups_and_sorts():
    rows = shape_objects([
        {"object_id": b"\x01" * 14, "size": 100, "callsite": "a.py:1",
         "ref_types": {"LOCAL_REFERENCE": 1}},
        {"object_id": b"\x02" * 14, "size": 300, "callsite": "a.py:1",
         "ref_types": {"USED_BY_PENDING_TASK": 2}},
        {"object_id": b"\x03" * 14, "size": 50, "callsite": "b.py:9"},
        {"object_id": b"\x04" * 14},                      # unknown callsite
    ])
    out = summarize_memory_rows(rows, group_by="callsite", top_k=2)
    assert out["total_objects"] == 4
    assert out["total_bytes"] == 450
    assert out["groups"][0]["key"] == "a.py:1"
    assert out["groups"][0]["bytes"] == 400
    assert out["groups"][0]["ref_types"] == {"LOCAL_REFERENCE": 1,
                                             "USED_BY_PENDING_TASK": 2}
    assert out["dropped_groups"] == 1                     # top_k clipped
    with pytest.raises(ValueError):
        summarize_memory_rows(rows, group_by="nope")
    with pytest.raises(ValueError):
        summarize_memory_rows(rows, sort_by="nope")


def test_summarize_memory_rows_count_sort_beats_truncation():
    """sort_by=count must apply BEFORE the top-K cut: the
    most-objects group survives even when it ranks last by bytes."""
    rows = ([{"object_id": bytes([i]) * 14, "size": 1,
              "callsite": "many.py:1"} for i in range(5)]
            + [{"object_id": bytes([100 + i]) * 14, "size": 1000,
                "callsite": f"big{i}.py:1"} for i in range(3)])
    out = summarize_memory_rows(shape_objects(rows),
                                group_by="callsite", top_k=2,
                                sort_by="count")
    assert out["groups"][0]["key"] == "many.py:1"
    assert out["groups"][0]["objects"] == 5
    # bytes sort drops it entirely at the same top_k
    by_bytes = summarize_memory_rows(shape_objects(rows),
                                     group_by="callsite", top_k=2)
    assert all(g["key"] != "many.py:1" for g in by_bytes["groups"])


def test_shape_leaks_hexes_ids():
    recs = shape_leaks([{"object_id": b"\x07" * 14, "node_id": None,
                         "cause": "dead_holders"}])
    assert recs[0]["object_id"] == ("07" * 14)
    assert recs[0]["cause"] == "dead_holders"


# -------------------------------------------------- single-node provenance

def test_list_objects_callsite_and_filters(rtpu_init):
    ref = ray_tpu_torch.put(np.zeros(200_000, dtype=np.uint8))  # noqa: F841
    time.sleep(0.2)                       # prov + edge flush cadence
    rows = rstate.list_objects()
    mine = [r for r in rows if THIS_FILE in (r.get("callsite") or "")]
    assert mine, rows
    row = mine[0]
    assert row["creator"] == "driver"
    assert row["size"] == 200_162 or row["size"] > 200_000
    assert row["ref_types"].get("LOCAL_REFERENCE", 0) >= 1
    # filters ride the enriched rows (satellite: filters test)
    assert rstate.list_objects(filters={"object_id": row["object_id"]})
    assert rstate.list_objects(
        filters={"object_id": "no_such_object"}) == []
    assert rstate.list_objects(filters={"creator": "driver"})


def test_callsite_disabled_records_nothing():
    ray_tpu_torch.init(num_cpus=2,
                       _system_config={"object_callsite_enabled": False})
    try:
        ref = ray_tpu_torch.put(b"x" * 200_000)                 # noqa: F841
        time.sleep(0.2)
        rows = rstate.list_objects()
        assert rows
        assert all(r.get("callsite") is None for r in rows)
    finally:
        ray_tpu_torch.shutdown()


def test_actor_handle_ref_type(rtpu_init):
    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return "pong"

    a = A.remote()
    ray_tpu_torch.get(a.ping.remote())
    time.sleep(0.2)
    rows = rstate.list_objects()
    handles = [r for r in rows if r["ref_types"].get("ACTOR_HANDLE")]
    assert handles, rows
    assert any(THIS_FILE in (r.get("callsite") or "") for r in handles)


def test_worker_creator_label(rtpu_init):
    @ray_tpu_torch.remote
    def producer():
        return ray_tpu_torch.put(b"y" * 200_000)

    inner = ray_tpu_torch.get(producer.remote())                # noqa: F841
    time.sleep(0.3)
    rows = rstate.list_objects()
    made_in_task = [r for r in rows
                    if (r.get("creator") or "").endswith("producer")]
    assert made_in_task, rows


# --------------------------------------- acceptance: 2-node e2e + leak flip

def test_memory_summary_ref_types_and_leak_flip():
    """Driver's put is captured by a pending task
    and a nested return — ``memory_summary()`` groups it under the put
    callsite with USED_BY_PENDING_TASK + CAPTURED_IN_OBJECT; killing
    the holder's node flips it to a leak finding (gauge > 0, doctor
    problem line names the callsite)."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2})
    node_b = cluster.add_node(num_cpus=2, resources={"b": 2.0})
    ray_tpu_torch.init(address=cluster,
                       _system_config={"memory_leak_sweep_interval_s": 0.3,
                                       "memory_leak_pinned_ttl_s": 300.0})
    try:
        payload = np.ones(100_000, dtype=np.uint8)
        ref = ray_tpu_torch.put(payload)            # <-- the tracked callsite
        put_line = "test_torch_memory_introspection.py"

        @ray_tpu_torch.remote(resources={"b": 1.0}, num_cpus=0)
        class Holder:
            def hold(self, boxed):
                # a NESTED ref is not auto-resolved: this process now
                # holds a live ObjectRef (registered via node B's conn)
                self.boxed = boxed
                return True

        holder = Holder.remote()
        assert ray_tpu_torch.get(holder.hold.remote([ref]))

        @ray_tpu_torch.remote
        def box(boxed):
            return [boxed[0]]     # return VALUE contains the ref

        outer = box.remote([ref])
        ray_tpu_torch.wait([outer], num_returns=1, timeout=30)

        @ray_tpu_torch.remote(resources={"b": 2.0})
        def never_runs(r):
            return r

        # node B has b=2 total but the holder occupies 1: feasible yet
        # unplaceable — a genuinely PENDING task whose arg pins ref
        pending = never_runs.remote(ref)      # noqa: F841
        time.sleep(0.5)                       # flush cadences

        rows = rstate.list_objects()
        mine = [r for r in rows
                if put_line in (r.get("callsite") or "")
                and (r.get("size") or 0) >= 100_000]
        assert mine, rows
        rt = mine[0]["ref_types"]
        assert rt.get("LOCAL_REFERENCE", 0) >= 1          # driver + actor
        assert rt.get("USED_BY_PENDING_TASK", 0) >= 1
        assert rt.get("CAPTURED_IN_OBJECT", 0) >= 1

        summary = rstate.memory_summary(group_by="callsite")
        group = next(g for g in summary["groups"]
                     if put_line in g["key"]
                     and g["bytes"] >= 100_000)
        assert group["ref_types"].get("USED_BY_PENDING_TASK", 0) >= 1
        assert group["ref_types"].get("CAPTURED_IN_OBJECT", 0) >= 1
        assert summary["leaks"] == []

        # ---- leak flip: drop every live-process holder except the
        # actor on node B, then SIGKILL-equivalent node B
        del ref
        time.sleep(0.3)                       # REF_DROP flush + grace
        cluster.remove_node(node_b)

        deadline = time.monotonic() + 15
        leaks = []
        while time.monotonic() < deadline:
            leaks = rstate.memory_summary()["leaks"]
            if leaks:
                break
            time.sleep(0.3)
        assert leaks, "leak sweep never flagged the dead-node holder"
        leak = next((lk for lk in leaks
                     if put_line in (lk.get("callsite") or "")), None)
        assert leak is not None, leaks
        assert leak["cause"] == "dead_holders"

        report = rstate.health_report()
        assert any("leaked object" in p and put_line in p
                   for p in report["problems"]), report["problems"]
        assert report["memory"]["leaked"] >= 1

        # gauge on the merged metrics table
        gauge = rstate.list_metrics(
            filters={"name": "rtpu_object_leaked_objects"})
        assert gauge and any(r["value"] >= 1 for r in gauge), gauge

        # OBJECT_LEAK WARNING event names the callsite
        events = rstate.list_cluster_events(
            filters={"label": "OBJECT_LEAK"})
        assert events
        assert any(put_line in (e.get("callsite") or "")
                   for e in events), events
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


def test_pinned_zero_holder_ttl_leak(rtpu_init):
    """The second leak class: an object that keeps a pin but no holder
    past the TTL (simulated directly against the plane — the organic
    path needs a wedged unpin)."""
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch._private.ids import JobID, ObjectID, TaskID, WorkerID

    gcs = ray_tpu_torch._global_node.gcs
    oid = ObjectID.for_put(WorkerID.from_random())
    tid = TaskID.for_job(JobID.from_random())
    holder = (b"\x00" * 14, 999)
    gcs.ref_register(oid, holder)
    gcs.record_provenance([(oid, "synthetic.py:1", "driver")])
    gcs.pin_task_args(tid, [oid])
    gcs.ref_drop(oid, holder)                 # zero holders, still pinned
    old_int = CONFIG._values["memory_leak_sweep_interval_s"]
    old_ttl = CONFIG._values["memory_leak_pinned_ttl_s"]
    CONFIG._values["memory_leak_sweep_interval_s"] = 0.01
    CONFIG._values["memory_leak_pinned_ttl_s"] = 0.05
    try:
        gcs.sweep_object_leaks()              # stamps first-seen
        time.sleep(0.1)
        _, total = gcs.sweep_object_leaks()
        # the node tick may have swept in between (emit-once), so judge
        # by the CURRENT finding set, not the new-records return
        leaks = {r["object_id"]: r
                 for r in gcs.memory_state()["leaks"]}
        rec = leaks.get(oid)
        assert rec is not None, leaks
        assert rec["cause"] == "pinned_no_holder"
        assert rec["callsite"] == "synthetic.py:1"
        # releasing the pin clears the finding on the next sweep
        gcs.unpin_task_args(tid)
        time.sleep(0.05)
        gcs.sweep_object_leaks()
        assert all(r["object_id"] != oid
                   for r in gcs.memory_state()["leaks"])
    finally:
        CONFIG._values["memory_leak_sweep_interval_s"] = old_int
        CONFIG._values["memory_leak_pinned_ttl_s"] = old_ttl


def test_memory_state_survives_unsealed_rows(rtpu_init):
    """A held-but-never-sealed object appears in the ledger with
    size=None and shapes cleanly end to end (list + summary)."""
    gcs = ray_tpu_torch._global_node.gcs
    from ray_tpu_torch._private.ids import ObjectID, WorkerID

    oid = ObjectID.for_put(WorkerID.from_random())
    gcs.ref_register(oid, (b"\x01" * 14, 1))
    try:
        rows = rstate.list_objects()
        row = next(r for r in rows if r["object_id"] == oid.hex())
        assert row["size"] is None
        summary = rstate.memory_summary()
        assert summary["total_objects"] >= 1
    finally:
        gcs.ref_drop(oid, (b"\x01" * 14, 1))
