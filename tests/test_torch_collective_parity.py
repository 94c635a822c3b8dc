"""ray_tpu_torch.comm on the port's runtime against ray_tpu.comm on JAX's,
on the same seeded inputs, on the CPU: results equal bit for bit.

One program (``torch_coll_tasks.ParityRank.run``) runs on a 2-node x 2-rank
in-process cluster of each runtime in turn, the port's first, once for each
schedule forced through ``collective_algo`` (tree, ring, star and the
hierarchical two-level one) and for the hierarchical schedule with each
quantized inter-node wire format (bf16 and int8-blockscale), with 16 KB
chunks so that every schedule pipelines several. Each rank runs allreduce
and reducescatter of sum, prod, min and max, allgather and a broadcast, on
float32, float64, int32, int64 and bf16 inputs: torch tensors on the port,
numpy arrays (``ml_dtypes.bfloat16`` for bf16) on ``ray_tpu``. bf16 holds
infs, NaNs of both signs with and without payloads, signed zeros, the
largest finite values and subnormals. Tolerance: none, the bytes must be
equal.

``ray_tpu``'s chunked broadcast (the tree and hierarchical schedules) of a
bf16 array fails on the receiving ranks (its header names the dtype by
``dtype.str``, which numpy reads back as a plain void type it cannot cast
to), so the port's bf16 broadcast is held to the source's bits instead.
"""

import functools
import itertools

import ml_dtypes
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch as rt
import torch_coll_tasks as T
from ray_tpu import cluster_utils as jax_cluster
from ray_tpu_torch import cluster_utils as port_cluster

CONFIGS = (("tree", "exact"), ("ring", "exact"), ("star", "exact"),
           ("hierarchical", "exact"), ("hierarchical", "bf16"),
           ("hierarchical", "int8-blockscale"))
CHUNK_BYTES = 16 << 10


def _run(pkg, runtime, cluster_utils):
    cluster = cluster_utils.Cluster(
        initialize_head=True,
        head_node_args={"num_cpus": 2, "resources": {"a": 4.0}})
    cluster.add_node(num_cpus=2, resources={"b": 4.0})
    runtime.init(address=cluster)
    try:
        Rank = runtime.remote(num_cpus=0)(T.ParityRank)
        members = [Rank.options(resources={node: 1.0}).remote(pkg)
                   for node in ("a", "a", "b", "b")]
        col = __import__(f"{pkg}.comm.collective", fromlist=["x"])
        col.create_collective_group(members, T.WORLD,
                                    list(range(T.WORLD)))
        out = {}
        for algo, wire in CONFIGS:
            runtime.get([m.configure.remote(algo, wire, CHUNK_BYTES)
                         for m in members])
            out[algo, wire] = runtime.get(
                [m.run.remote(broadcast_bf16=pkg != "ray_tpu")
                 for m in members], timeout=300)
        return out
    finally:
        runtime.shutdown()
        cluster.shutdown()


@pytest.fixture(scope="module")
def runs():
    port = _run("ray_tpu_torch", rt, port_cluster)
    return port, _run("ray_tpu", ray_tpu, jax_cluster)


def _star_folds(kind, op):
    """The bytes of every left fold of the ranks' inputs under ``op``, one
    per rank order: the star schedule's coordinator reduces the
    contributions in the order they arrive, on either runtime."""
    from ray_tpu.comm.collective import _BINARY

    parts = [T.rank_input(kind, r) for r in range(T.WORLD)]
    if kind == "bf16":
        parts = [p.view(ml_dtypes.bfloat16) for p in parts]
    folds = set()
    with np.errstate(all="ignore"):
        for order in itertools.permutations(parts):
            folds.add(np.ascontiguousarray(functools.reduce(
                _BINARY[op], order)).view(np.uint8).tobytes())
    return folds


@pytest.mark.parametrize("kind", T.DTYPES)
@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: "-".join(c))
def test_results_equal_jax_bit_for_bit(runs, config, kind):
    """Every result of every rank equals ray_tpu's. The star schedule
    reduces in arrival order, which differs from run to run on either
    runtime: there both sides must equal one of the rank orders' folds
    bit for bit (and all ranks one result) in place of each other."""
    port, jax_ = runs
    folds = {}
    for rank in range(T.WORLD):
        got, want = port[config][rank], jax_[config][rank]
        keys = [k for k in want if k[1] == kind]
        assert keys and all(k in got for k in keys)
        for key in keys:
            if config[0] == "star" and key[0] in ("allreduce",
                                                  "reducescatter"):
                op = key[2]
                if op not in folds:
                    folds[op] = _star_folds(kind, op)
                for side in (port, jax_):
                    # one call's result: every rank's (or the ranks'
                    # slices, in rank order) is one of the folds
                    whole = b"".join(side[config][r][key][1]
                                     for r in range(T.WORLD))
                    if key[0] == "allreduce":
                        assert len({side[config][r][key][1]
                                    for r in range(T.WORLD)}) == 1, key
                        whole = side[config][rank][key][1]
                    assert whole in folds[op], (rank, key)
                continue
            assert got[key] == want[key], (rank, key)


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: "-".join(c))
def test_bf16_broadcast_carries_the_source_bits(runs, config):
    port, _ = runs
    src = T.rank_input("bf16", 1)
    for rank in range(T.WORLD):
        shape, data = port[config][rank]["broadcast", "bf16"]
        assert tuple(shape) == src.shape
        assert data == src.view(np.uint8).tobytes()


def test_jax_bf16_chunked_broadcast_header_cannot_be_read_back():
    """Why the JAX side skips bf16 broadcasts: its receivers rebuild the
    dtype from ``dtype.str`` and cannot cast the chunks into it."""
    arr = np.ones(4, np.float32).astype(ml_dtypes.bfloat16)
    buf = np.empty(4, dtype=np.dtype(arr.dtype.str))
    with pytest.raises(ValueError):
        buf[0:4] = arr


def test_bf16_inputs_reach_inf_and_nan(runs):
    """The bf16 sums hold infs (overflow of the largest finite values, and
    the specials) and NaNs: the comparison covers them."""
    port, _ = runs
    shape, data = port["ring", "exact"][0]["allreduce", "bf16", "sum"]
    bits = np.frombuffer(data, np.uint16)
    exp_all_ones = (bits & 0x7F80) == 0x7F80
    assert ((bits & 0x7F) == 0)[exp_all_ones].any()      # an inf
    assert ((bits & 0x7F) != 0)[exp_all_ones].any()      # a NaN


def _bf16_pairs():
    """Every bf16 bit pattern against each special and a few ordinary
    values, both ways round."""
    allv = np.arange(1 << 16, dtype=np.uint16)
    other = np.asarray(T.BF16_SPECIALS + (0x3F80, 0xBF80, 0x4000, 0x3F81,
                                          0x7FA0, 0xFFA0), np.uint16)
    a = np.repeat(allv, other.size)
    b = np.tile(other, allv.size)
    return np.concatenate([a, b]), np.concatenate([b, a])


@pytest.mark.parametrize("op", T.OPS)
def test_bf16_binop_equals_ml_dtypes(op):
    """The port's bf16 reduction of each op against ml_dtypes' ufunc (what
    ray_tpu reduces bf16 with), bit for bit, over every bit pattern: NaN
    results, min and max of NaNs and of signed zeros included; and into
    an ``out=`` buffer as the ring reduces."""
    from ray_tpu.comm.collective import _BINARY
    from ray_tpu_torch.comm import collective as col

    a, b = _bf16_pairs()
    with np.errstate(all="ignore"):
        want = _BINARY[op](a.view(ml_dtypes.bfloat16),
                           b.view(ml_dtypes.bfloat16)).view(np.uint16)
        binop = col._binop(op, col._BF16)
        got = binop(a.view(col._BF16), b.view(col._BF16))
        assert got.dtype == col._BF16
        np.testing.assert_array_equal(got.view(np.uint16), want)
        buf = a.copy().view(col._BF16)
        binop(buf, b.view(col._BF16), out=buf)
    np.testing.assert_array_equal(buf.view(np.uint16), want)


def test_numpy_dtypes_reduce_with_numpy_ufuncs():
    """Every other dtype reduces with ray_tpu's own ufunc table."""
    from ray_tpu_torch.comm import collective as col

    for dt in (np.float32, np.float64, np.int32, np.int64, np.float16):
        for op in T.OPS:
            assert col._binop(op, np.dtype(dt)) is col._BINARY[op]
    parts = [T.rank_input("f32", r) for r in range(T.WORLD)]
    assert np.array_equal(functools.reduce(col._BINARY["sum"], parts),
                          sum(parts[1:], parts[0]))
