"""Torch tensors through the paths the copied runtime tests hold with numpy
arrays: a streaming generator (test_torch_generators.py), lineage
reconstruction (test_torch_refcount.py), a ref nested in a returned value
(test_torch_refcount.py) and a lazy primary spilled to disk
(test_torch_object_plane.py). Each case holds dtype, shape and bits."""

import gc
import os
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from torch_runtime_fixtures import port_sanitizers, rtpu_init  # noqa: F401


def _tensors(seed):
    """A bf16, an f32 and an int64 tensor from `seed`, each over the
    store's inline limit (100 KB)."""
    rng = np.random.default_rng(seed)
    f32 = torch.from_numpy(rng.standard_normal((256, 160), dtype=np.float32))
    return [f32.to(torch.bfloat16), f32,
            torch.from_numpy(rng.integers(0, 50304, (12, 1024)))]


def _same(got, want):
    """Same dtype, shape and bytes."""
    assert isinstance(got, torch.Tensor)
    assert (got.dtype, got.shape) == (want.dtype, want.shape)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_stream_yields_tensors(rtpu_init):
    """A streaming task's items are tensors, bit for bit, in order."""
    @rt.remote
    def produce(seed):
        for t in _tensors(seed):
            yield t

    gen = produce.options(num_returns="streaming").remote(3)
    got = [rt.get(ref, timeout=60) for ref in gen]
    want = _tensors(3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def test_lost_tensor_reconstructed_from_lineage(rtpu_init, tmp_path):
    """A task's tensor result, freed from the store and the directory, is
    computed again by get(), bit for bit; the task ran twice."""
    node = rt._global_node

    @rt.remote
    def produce(seed, marks):
        open(os.path.join(marks, f"run.{time.time_ns()}"), "w").close()
        return _tensors(seed)[0] * 3

    ref = produce.remote(5, str(tmp_path))
    first = rt.get(ref, timeout=60)
    node.store.free([ref.id])
    node.gcs.drop_location(ref.id)
    assert not node.store.contains(ref.id)
    again = rt.get(ref, timeout=60)
    _same(again, first)
    _same(again, _tensors(5)[0] * 3)
    assert len(os.listdir(tmp_path)) == 2


def test_tensor_nested_in_returned_dict_survives_producer_drop(rtpu_init):
    """A tensor put by a task, whose ref lives only inside the task's
    returned dict, outlives the producer's drop and the grace window."""
    @rt.remote
    def make(seed):
        return {"t": rt.put(_tensors(seed)[1]), "seed": seed}

    result_ref = make.remote(7)
    time.sleep(1.0)
    out = rt.get(result_ref, timeout=60)
    assert out["seed"] == 7
    _same(rt.get(out["t"], timeout=10), _tensors(7)[1])
    del out, result_ref
    gc.collect()


def test_lazy_put_tensor_spills_and_reads_back(tmp_path):
    """A tensor's lazy primary spilled straight to disk restores bit for
    bit on its first read."""
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_store import (ObjectMeta, ObjectReader,
                                                     ObjectStore)
    from ray_tpu_torch._private.serialization import (serialize,
                                                      serialized_size)

    store = ObjectStore(capacity_bytes=4 << 20, spill_dir=str(tmp_path))
    reader = ObjectReader()
    try:
        src = _tensors(9)
        smeta, views = serialize(src)
        oid = ObjectID.from_random()
        meta = store.put_lazy(oid, smeta, views,
                              serialized_size(smeta, views))
        assert meta is not None and meta.flags & ObjectMeta.LAZY
        with store._lock:
            store._capacity = 1 << 16
            store._ensure_capacity(0)
        e = store._entries[oid]
        assert e.spilled_path is not None and e.lazy is None
        meta = store.get_meta(oid)
        assert meta is not None and not (meta.flags & ObjectMeta.SPILLED)
        got = reader.load(meta)
        for g, w in zip(got, _tensors(9)):
            _same(g, w)
        kinds = [k for (k, _o, _s) in store.drain_spill_events()]
        assert kinds == ["spill", "restore"]
    finally:
        reader.close()
        store.shutdown()


@pytest.mark.cuda
def test_gpu_task_tensor_reconstructed_from_lineage(tmp_path):
    """A num_gpus=1 task's tensor, computed on the card and returned as a
    CPU tensor, is computed there again after it is lost, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the task computes on "
                    "the card its slot names)")
    rt.init(num_cpus=2)
    try:
        node = rt._global_node

        @rt.remote(num_gpus=1)
        def on_card(seed, marks):
            open(os.path.join(marks, f"run.{time.time_ns()}"), "w").close()
            x = _tensors(seed)[1].cuda()
            return ((x @ x.T).softmax(-1).cpu(),
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

        ref = on_card.remote(11, str(tmp_path))
        first, visible = rt.get(ref, timeout=300)
        node.store.free([ref.id])
        node.gcs.drop_location(ref.id)
        again, visible_again = rt.get(ref, timeout=300)
        assert visible == visible_again == "0"
        assert first.device.type == "cpu"
        _same(again, first)
        assert len(os.listdir(tmp_path)) == 2
    finally:
        rt.shutdown()
