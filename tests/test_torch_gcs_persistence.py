# A copy of tests/test_gcs_persistence.py on ray_tpu_torch's runtime: the same
# tests under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown.
"""GCS persistence tests (reference analogue: GCS fault tolerance via
Redis, ``src/ray/gcs/store_client/`` + ``test_gcs_fault_tolerance.py``):
durable KV/job/PG metadata survives a head restart."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.gcs import GlobalControlPlane, JobRecord
from ray_tpu_torch._private.gcs_storage import FileStorage, open_storage
from ray_tpu_torch._private.ids import JobID
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


def test_journal_roundtrip(tmp_path):
    path = str(tmp_path / "gcs.journal")
    st = FileStorage(path)
    st.append(("kv", "put", (b"a", b"1")))
    st.append(("kv", "put", (b"b", b"2")))
    st.append(("kv", "del", b"a"))
    st.close()
    assert len(FileStorage(path).load()) == 3


def test_torn_tail_record_dropped(tmp_path):
    path = str(tmp_path / "gcs.journal")
    st = FileStorage(path)
    st.append(("kv", "put", (b"good", b"1")))
    st.close()
    with open(path, "ab") as f:
        f.write(b"\xff\xff\xff\x7f partial")       # torn length + garbage
    entries = FileStorage(path).load()
    assert entries == [("kv", "put", (b"good", b"1"))]


def test_plane_restore_and_volatile_filter(tmp_path):
    path = str(tmp_path / "gcs.journal")
    plane = GlobalControlPlane(storage=FileStorage(path))
    plane.kv_put(b"user-key", b"durable")
    plane.kv_put(b"fn:abc", b"function blob")         # volatile
    plane.kv_put(b"__rtpu_head_node", b"stale addr")  # volatile
    plane.kv_put(b"dropped", b"x")
    plane.kv_del(b"dropped")
    job = JobRecord(job_id=JobID.from_random(), driver_pid=1,
                    start_time=time.time())
    plane.register_job(job)
    plane.close_storage()

    plane2 = GlobalControlPlane(storage=FileStorage(path))
    assert plane2.kv_get(b"user-key") == b"durable"
    assert plane2.kv_get(b"fn:abc") is None
    assert plane2.kv_get(b"__rtpu_head_node") is None
    assert plane2.kv_get(b"dropped") is None
    assert job.job_id in plane2.jobs
    plane2.close_storage()


def test_compaction_shrinks_journal(tmp_path):
    path = str(tmp_path / "gcs.journal")
    plane = GlobalControlPlane(storage=FileStorage(path))
    for i in range(200):
        plane.kv_put(b"hot-key", str(i).encode())     # 200 overwrites
    size_before = os.path.getsize(path)
    plane.compact_storage()
    assert os.path.getsize(path) < size_before
    plane.close_storage()
    plane2 = GlobalControlPlane(storage=FileStorage(path))
    assert plane2.kv_get(b"hot-key") == b"199"
    plane2.close_storage()


def test_open_storage_spec(tmp_path):
    from ray_tpu_torch._private.gcs_storage import InMemoryStorage
    assert isinstance(open_storage(None), InMemoryStorage)
    st = open_storage(str(tmp_path))                  # dir -> file inside
    st.append(("kv", "put", (b"k", b"v")))
    st.close()
    assert os.path.exists(str(tmp_path / "gcs.journal"))


def _spawn_head(tmp_path, storage, idx):
    ready_file = str(tmp_path / f"ready{idx}.json")
    env = dict(os.environ)
    fw_root = os.path.dirname(os.path.dirname(os.path.abspath(
        ray_tpu_torch.__file__)))
    env["PYTHONPATH"] = (env.get("PYTHONPATH", "") + os.pathsep + fw_root)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.main", "--head",
         "--num-cpus", "2", "--storage", storage,
         "--session-dir", str(tmp_path / f"sess{idx}"),
         "--ready-file", ready_file], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 30
    while not os.path.exists(ready_file):
        assert proc.poll() is None, "head died during startup"
        assert time.monotonic() < deadline, "head never became ready"
        time.sleep(0.05)
    with open(ready_file) as f:
        return proc, json.load(f)


def test_head_restart_recovers_kv(tmp_path):
    """Kill -9 the head; a new head on the same storage serves the old
    durable KV to a fresh driver."""
    storage = str(tmp_path / "gcs_store")
    proc1, ready1 = _spawn_head(tmp_path, storage, 1)
    try:
        ray_tpu_torch.init(address=f"127.0.0.1:{ready1['gcs_port']}")
        ray_tpu_torch._ctx.current_client.kv_put(b"survivor", b"yes")
        # kv_put is fire-and-forget: the read-back round-trip orders it
        # before the upcoming SIGKILL
        assert ray_tpu_torch._ctx.current_client.kv_get(b"survivor") == b"yes"
        ray_tpu_torch.shutdown()
    finally:
        os.kill(proc1.pid, signal.SIGKILL)
        proc1.wait(timeout=10)

    proc2, ready2 = _spawn_head(tmp_path, storage, 2)
    try:
        ray_tpu_torch.init(address=f"127.0.0.1:{ready2['gcs_port']}")
        assert ray_tpu_torch._ctx.current_client.kv_get(b"survivor") == b"yes"
        # the new head is fully operational, not just serving old state
        @ray_tpu_torch.remote
        def ping():
            return "alive"
        assert ray_tpu_torch.get(ping.remote(), timeout=60) == "alive"
    finally:
        ray_tpu_torch.shutdown()
        proc2.terminate()
        proc2.wait(timeout=10)
