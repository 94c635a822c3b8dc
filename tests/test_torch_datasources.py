"""tests/test_datasources.py aimed at ray_tpu_torch.data on the port's
runtime (one module-scoped runtime): readers, writers, streaming splits,
device batches as torch tensors on the CPU, and TorchTrainer ingest."""

import json
import os
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import data as rd



@pytest.fixture(scope="module", autouse=True)
def runtime():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()
    # conftest reports only ray_tpu's sanitizers: hold the port's here
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []

def test_read_text(tmp_path):
    p = tmp_path / "a.txt"
    p.write_text("hello\nworld\n\nlast\n")
    ds = rd.read_text(str(p))
    texts = [r["text"] for r in ds.iter_rows()]
    assert texts == ["hello", "world", "last"]


def test_read_text_blocks_bounded(tmp_path):
    """A big file streams as multiple bounded-row blocks from ONE task."""
    p = tmp_path / "big.txt"
    p.write_text("\n".join(f"line{i}" for i in range(1000)) + "\n")
    ds = rd.read_text(str(p), rows_per_block=100)
    blocks = list(ds.iter_blocks())
    assert len(blocks) == 10
    assert all(len(b["text"]) == 100 for b in blocks)


def test_read_numpy(tmp_path):
    arr = np.arange(100, dtype=np.float32).reshape(50, 2)
    np.save(tmp_path / "x.npy", arr)
    ds = rd.read_numpy(str(tmp_path / "x.npy"), rows_per_block=20)
    blocks = list(ds.iter_blocks())
    assert len(blocks) == 3                      # 20+20+10
    got = np.concatenate([b["data"] for b in blocks])
    np.testing.assert_array_equal(got, arr)


def test_read_npz(tmp_path):
    np.savez(tmp_path / "x.npz", a=np.arange(4), b=np.ones(4))
    ds = rd.read_numpy(str(tmp_path / "x.npz"))
    (blk,) = list(ds.iter_blocks())
    np.testing.assert_array_equal(blk["a"], np.arange(4))


def test_read_binary_files(tmp_path):
    (tmp_path / "f1.bin").write_bytes(b"\x01\x02")
    (tmp_path / "f2.bin").write_bytes(b"\x03")
    ds = rd.read_binary_files([str(tmp_path / "f1.bin"),
                               str(tmp_path / "f2.bin")])
    rows = sorted(ds.iter_rows(), key=lambda r: r["path"])
    assert rows[0]["bytes"] == b"\x01\x02"
    assert rows[1]["bytes"] == b"\x03"


def test_read_csv_streaming(tmp_path):
    p = tmp_path / "t.csv"
    p.write_text("a,b\n1,x\n2,y\n3,z\n")
    ds = rd.read_csv(str(p))
    rows = list(ds.iter_rows())
    assert rows == [{"a": 1, "b": "x"}, {"a": 2, "b": "y"},
                    {"a": 3, "b": "z"}]


def test_read_json_lines(tmp_path):
    p = tmp_path / "t.jsonl"
    p.write_text("\n".join(json.dumps({"v": i}) for i in range(5)))
    ds = rd.read_json(str(p))
    assert sorted(r["v"] for r in ds.iter_rows()) == list(range(5))


def test_read_tfrecords_roundtrip(tmp_path):
    """tf.train.Example records parsed without tensorflow: write with
    the minimal encoder, read back through the datasource."""
    from ray_tpu_torch.data.datasource import write_tfrecords

    rows = [{"idx": i, "score": float(i) / 2, "name": f"r{i}".encode(),
             "vec": [i, i + 1, i + 2]} for i in range(25)]
    path = str(tmp_path / "t.tfrecord")
    write_tfrecords(path, rows)
    ds = rd.read_tfrecords(path, rows_per_block=10)
    got = list(ds.iter_rows())
    assert len(got) == 25
    assert got[3]["idx"] == 3
    assert list(got[3]["vec"]) == [3, 4, 5]
    assert abs(got[7]["score"] - 3.5) < 1e-6
    assert got[7]["name"] == b"r7"
    # 25 rows at 10/block = 3 blocks from one streaming read task
    assert len(list(ds.iter_blocks())) == 3


def test_dataset_stats_and_schema(tmp_path):
    p = tmp_path / "s.txt"
    p.write_text("\n".join(f"v{i}" for i in range(30)) + "\n")
    ds = rd.read_text(str(p), rows_per_block=10)
    st = ds.stats()
    assert st["num_blocks"] == 3
    assert st["num_rows"] == 30
    assert st["size_bytes"] > 0
    assert "text" in st["schema"]
    assert ds.count() == 30
    assert "text" in ds.schema()


def test_streaming_split_feeds_all_shards():
    ds = rd.range(1000, num_blocks=10)
    shards = ds.streaming_split(3)
    seen = [sum(len(b["id"]) for b in it.iter_blocks()) for it in shards]
    assert sum(seen) == 1000
    assert all(s > 0 for s in seen)


def test_iter_device_batches_rebatches():
    ds = rd.range(512, num_blocks=4)           # blocks of 128
    (it,) = ds.streaming_split(1)
    batches = list(it.iter_device_batches(batch_size=100, device="cpu"))
    assert len(batches) == 5                    # 512 // 100, partial dropped
    assert all(b["id"].shape == (100,) for b in batches)
    import torch
    assert isinstance(batches[0]["id"], torch.Tensor)


def test_trainer_streaming_ingest(tmp_path):
    """End-to-end: a TorchTrainer gang of two CPU workers (gloo) consumes a
    streaming split of a Dataset via session.get_dataset_shard, every row
    exactly once."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    @rt.remote
    class Accumulator:
        def __init__(self):
            self.by_rank = {}

        def add(self, rank, total):
            self.by_rank[rank] = total
            return sum(self.by_rank.values())

        def read(self):
            return dict(self.by_rank)

    Accumulator.options(name="ingest_acc").remote()
    ds = rd.range(400, num_blocks=8)

    def loop(config):
        ctx = train.get_context()
        it = ctx.get_dataset_shard("train")
        total = 0
        for batch in it.iter_batches(batch_size=25):
            total += int(np.sum(batch["id"]))
        acc = rt.get_actor("ingest_acc")
        rt.get(acc.add.remote(ctx.get_world_rank(), total))
        train.report({"total": total})

    trainer = TorchTrainer(
        loop,
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False,
                                     resources_per_worker={"CPU": 1},
                                     placement_strategy="PACK"),
        run_config=RunConfig(name="ingest", storage_path=str(tmp_path)),
        datasets={"train": ds})
    result = trainer.fit()
    assert result.error is None
    by_rank = rt.get(rt.get_actor("ingest_acc").read.remote())
    assert len(by_rank) == 2
    # every row consumed exactly once across the gang
    assert sum(by_rank.values()) == sum(range(400))
    assert all(t > 0 for t in by_rank.values())


def test_read_csv_dtype_consistent_across_blocks(tmp_path):
    """ADVICE r04: dtype inference is per-FILE, not per-block — a late
    "n/a" must make the whole column strings, not just its block."""
    p = tmp_path / "mixed.csv"
    rows = [str(i) for i in range(20)] + ["n/a", "21"]
    p.write_text("x,y\n" + "\n".join(f"{v},{i}" for i, v in
                                     enumerate(rows)) + "\n")
    ds = rd.read_csv(str(p), rows_per_block=8)
    blocks = list(ds.iter_blocks())
    assert len(blocks) == 3
    # x: poisoned by "n/a" → strings everywhere; y: int64 everywhere
    assert all(b["x"].dtype.kind in ("U", "O") for b in blocks)
    assert all(b["y"].dtype == np.int64 for b in blocks)
    f = tmp_path / "floaty.csv"
    f.write_text("a\n1\n2.5\n3\n")
    blk = list(rd.read_csv(str(f)).iter_blocks())[0]
    assert blk["a"].dtype == np.float64


def test_read_numpy_npz_list_and_dir(tmp_path):
    """ADVICE r04: .npz detection must work for list inputs and
    directories (str(paths) endswith was wrong for both)."""
    np.savez(tmp_path / "z.npz", a=np.arange(4), b=np.ones(4))
    rows = list(rd.read_numpy([str(tmp_path / "z.npz")]).iter_rows())
    assert len(rows) == 4 and set(rows[0]) == {"a", "b"}
    d = tmp_path / "npzdir"
    d.mkdir()
    np.savez(d / "one.npz", a=np.arange(3))
    np.save(d / "two.npy", np.arange(5, dtype=np.int64))
    ds = rd.read_numpy(str(d))
    blocks = list(ds.iter_blocks())
    assert len(blocks) == 2  # both the npz and the npy were found


def test_write_csv_json_numpy_roundtrip(tmp_path):
    """Distributed writers: one part file per block, written by tasks;
    round-trips through the matching readers (reference:
    Dataset.write_csv/write_json/write_numpy)."""
    ds = rd.from_numpy({"a": np.arange(40, dtype=np.int64),
                        "b": np.arange(40, dtype=np.float64)},
                       num_blocks=4)
    csv_files = ds.write_csv(str(tmp_path / "csvs"))
    assert len(csv_files) == 4
    back = rd.read_csv(str(tmp_path / "csvs"))
    rows = sorted(int(r["a"]) for r in back.iter_rows())
    assert rows == list(range(40))

    json_files = ds.write_json(str(tmp_path / "jsons"))
    assert len(json_files) == 4
    back = rd.read_json(str(tmp_path / "jsons"))
    assert sorted(int(r["a"]) for r in back.iter_rows()) == list(range(40))

    np_files = ds.write_numpy(str(tmp_path / "npys"), column="a")
    assert len(np_files) == 4
    back = rd.read_numpy(str(tmp_path / "npys"))
    got = np.concatenate([b["data"] for b in back.iter_blocks()])
    assert sorted(got.tolist()) == list(range(40))


def test_streaming_split_releases_its_queue_actors():
    """Each shard's queue actor goes when its stream ends (the port's
    difference): a leftover queue holds a worker process, and enough of
    them starved later tasks of workers under the node's worker cap (the
    trainer test above hung after the earlier split tests)."""
    from ray_tpu_torch import state

    def queues():
        return sum(a.get("class_name") == "_QueueActor"
                   and a.get("state") == "ALIVE"
                   for a in state.list_actors())

    def settles_at(n):
        deadline = time.monotonic() + 15
        while queues() != n and time.monotonic() < deadline:
            time.sleep(0.1)
        return queues() == n

    base = queues()
    shards = rd.range(300, num_blocks=6).streaming_split(3)
    assert settles_at(base + 3)
    assert sum(len(b["id"]) for it in shards for b in it.iter_blocks()) == 300
    assert settles_at(base)
