"""Unit tests for ray_tpu_torch's collective flight recorder, which the
port's comm feeds (copies of tests/test_flight_recorder.py; no cluster
needed): key parsing, ring bounds, watermark bookkeeping, and the three
verdict classes of the cluster-wide diagnosis."""

import numpy as np
import pytest

from ray_tpu_torch._private import flight_recorder as fr
from ray_tpu_torch._private.config import CONFIG


@pytest.fixture(autouse=True)
def _clean_recorder():
    fr.reset()
    saved = CONFIG._values.get("flight_recorder_capacity")
    yield
    CONFIG._values["flight_recorder_capacity"] = saved
    fr.reset()


def test_parse_key_schedule_and_p2p():
    okey, phase = fr.parse_key(("g", "ep", 7, "rs", 2, 1))
    assert okey == ("g", 7) and phase == "rs"
    # hierarchical sub-schedule keys join their phase strings
    okey, phase = fr.parse_key(("g", "ep", 7, "hx", 0, "rs", 1, 0))
    assert okey == ("g", 7) and phase == "hx.rs"
    okey, phase = fr.parse_key(("g", "ep", "p2p", 0, 1, 5, 3))
    assert okey == ("g", ("p2p", 0, 1, 5, 3)) and phase == "p2p"


def test_ring_is_bounded_and_capacity_zero_disables():
    CONFIG._values["flight_recorder_capacity"] = 8
    for i in range(100):
        fr.note_send(("g", "ep", i, "rs", 0, 0), 4)
    assert len(fr._ring) == 8
    assert all(ev is not None for ev in fr._ring)
    CONFIG._values["flight_recorder_capacity"] = 0
    assert not fr.enabled()
    fr.op_begin("g", "ep", 0, "allreduce", "ring", 64, 2, 0)
    assert not fr._inflight          # disabled: no watermark table


def test_watermarks_track_send_recv_wait():
    CONFIG._values["flight_recorder_capacity"] = 64
    fr.register_group("g", "ep", 0, 2, None)
    fr.op_begin("g", "ep", 3, "allreduce", "ring", 1024, 2, 0)
    fr.note_send(("g", "ep", 3, "rs", 1, 0), 512)
    fr.note_wait(("g", "ep", 3, "rs", 0, 0))
    rec = fr._inflight[("g", 3)]
    assert rec["sent"] == 1 and rec["recv"] == 0
    assert rec["last_phase"] == "rs"
    assert rec["waiting"] == ("g", "ep", 3, "rs", 0, 0)
    fr.note_recv(("g", "ep", 3, "rs", 0, 0), 512)
    assert rec["recv"] == 1 and rec["waiting"] is None
    assert "phase rs" in fr.watermark(rec)
    fr.op_end("g", 3)
    assert ("g", 3) not in fr._inflight
    done = list(fr._done)
    assert done and done[-1]["op"] == "allreduce"
    assert done[-1]["dur"] > 0


def _snap(**ids):
    return fr.progress_snapshot(**ids)


def test_diagnose_dead_rank_names_endpoint():
    CONFIG._values["flight_recorder_capacity"] = 64
    fr.register_group("g", "ep", 0, 3,
                      [(b"n" * 16, b"w" * 16)] * 3)
    fr.op_begin("g", "ep", 5, "allreduce", "ring", 1024, 3, 0)
    fr.note_send(("g", "ep", 5, "rs", 2, 0), 512)
    fr.note_wait(("g", "ep", 5, "rs", 1, 0))
    snap0 = _snap(worker_id="w0")
    # ranks 1 and 2 never replied at all -> the lowest missing rank is
    # named dead, with its endpoint
    rep = fr.diagnose({"n1": [snap0]})
    assert len(rep["ops"]) == 1
    v = rep["verdicts"][0]
    assert v["verdict"] == "dead_rank" and v["rank"] == 1
    assert v["op"] == "allreduce" and v["phase"] == "rs"
    assert "dead rank 1" in v["message"]
    assert "endpoint" in v["message"]


def test_diagnose_lagging_rank_not_started():
    CONFIG._values["flight_recorder_capacity"] = 64
    fr.register_group("g", "ep", 0, 2, None)
    fr.op_begin("g", "ep", 0, "allreduce", "ring", 1024, 2, 0)
    fr.note_wait(("g", "ep", 0, "rs", 0, 0))
    snap0 = _snap(worker_id="w0")
    snap1 = {"now": snap0["now"],
             "groups": [{"group": "g", "epoch": "ep", "rank": 1,
                         "world": 2, "endpoints": None}],
             "inflight": [], "done": [], "recent": [], "op_keys": [],
             "sent_keys": {}, "delivered_keys": {}}
    rep = fr.diagnose({"n1": [snap0], "n2": [snap1]})
    v = rep["verdicts"][0]
    assert v["verdict"] == "lagging_rank" and v["rank"] == 1
    assert "not entered" in v["message"]


def test_diagnose_lost_chunk_names_edge():
    CONFIG._values["flight_recorder_capacity"] = 64
    # rank 0: blocked >1s on a key rank 1 logged sending
    fr.register_group("g", "ep", 0, 2, None)
    fr.op_begin("g", "ep", 7, "allreduce", "ring", 1024, 2, 0)
    fr.note_wait(("g", "ep", 7, "rs", 0, 0))
    fr._inflight[("g", 7)]["waiting_since"] -= 5.0
    snap0 = _snap(worker_id="w0")
    fr.reset()
    fr.register_group("g", "ep", 1, 2, None)
    fr.op_begin("g", "ep", 7, "allreduce", "ring", 1024, 2, 1)
    fr.note_send(("g", "ep", 7, "rs", 0, 0), 512)
    fr.note_wait(("g", "ep", 7, "rs", 1, 0))
    snap1 = _snap(worker_id="w1")
    rep = fr.diagnose({"n1": [snap0, snap1]})
    v = rep["verdicts"][0]
    assert v["verdict"] == "lost_chunk" and v["rank"] == 0
    assert "rank 1 -> rank 0" in v["message"]


def test_diagnose_done_ops_produce_no_verdict():
    CONFIG._values["flight_recorder_capacity"] = 64
    fr.register_group("g", "ep", 0, 1, None)
    fr.op_begin("g", "ep", 0, "allreduce", "local", 64, 1, 0)
    fr.op_end("g", 0)
    rep = fr.diagnose({"n1": [_snap(worker_id="w0")]})
    assert rep["verdicts"] == []
    assert rep["ops"][0]["done_ranks"] == [0]


def test_snapshot_survives_pickle_roundtrip():
    import pickle

    CONFIG._values["flight_recorder_capacity"] = 64
    fr.register_group("g", "ep", 0, 2, [(b"n" * 16, b"w" * 16)] * 2)
    fr.op_begin("g", "ep", 1, "broadcast", "tree", 256, 2, 0)
    fr.note_send(("g", "ep", 1, "tb", 1), 256)
    snap = pickle.loads(pickle.dumps(_snap(worker_id="w0")))
    rep = fr.diagnose({"n1": [snap]})
    assert rep["ops"][0]["op"] == "broadcast"
    v = rep["verdicts"][0]
    assert v["verdict"] == "dead_rank" and v["rank"] == 1


def test_deposit_and_wait_feed_recorder():
    """Transport integration: deposit/wait are the recorder's deliver/
    recv feed points (no cluster: drive coll_transport directly)."""
    import time

    from ray_tpu_torch._private import coll_transport

    CONFIG._values["flight_recorder_capacity"] = 64
    fr.register_group("g", "ep", 0, 2, None)
    fr.op_begin("g", "ep", 9, "allreduce", "ring", 1024, 2, 0)
    coll_transport.deposit(("g", "ep", 9, "rs", 0, 0),
                           np.ones(4, np.float32))
    got = coll_transport.wait(("g", "ep", 9, "rs", 0, 0),
                              time.monotonic() + 1.0)
    assert np.asarray(got).size == 4
    rec = fr._inflight[("g", 9)]
    assert rec["recv"] == 1
    kinds = [ev[1] for ev in fr._ring if ev is not None]
    assert fr.EV_DELIVER in kinds and fr.EV_RECV in kinds
    fr.op_end("g", 9)
