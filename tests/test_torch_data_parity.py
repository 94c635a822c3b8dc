"""ray_tpu_torch.data on the port's runtime against ray_tpu.data on JAX's,
on the same seeded numpy inputs, on the CPU.

One program runs on each side, the port's first: ``from_numpy`` /
``range`` → ``map_batches`` → ``repartition`` → ``random_shuffle(seed=0)``
→ ``sort`` → ``groupby(...).aggregate(Sum, Mean, Std)`` and a whole-dataset
``aggregate``, then ``iter_batches`` with and without ``drop_last``. Blocks
are numpy on both sides and every step's tasks merge in a fixed order (the
shuffle seeds each map from ``(seed, map_index)``), so blocks, rows, the
shuffle's order, the sort and the aggregates are held equal exactly. Then
the device batches: equal values, with the dtypes each side gives (the
port keeps numpy's; JAX without x64 gives 32-bit), this rank's rows under
``mesh=`` against the addressable shards of JAX's batch sharding, and a
string column refused on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec

import ray_tpu
import ray_tpu_torch as rt
from ray_tpu import data as jd
from ray_tpu_torch import data as td
from ray_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh, MeshSpec

N_ROWS = 300
DP, FSDP = 2, 2
MESH_BATCH = 8
# the iterator's dtype= on each side: a cast both packages take
ITER_KW = {"ray_tpu.data": {"dtype": jnp.float32},
           "ray_tpu_torch.data": {"dtype": np.float32, "device": "cpu"}}


def _columns():
    rng = np.random.default_rng(0)
    return {"k": rng.integers(0, 7, N_ROWS),
            "v": rng.standard_normal(N_ROWS),
            "x": rng.integers(0, 1000, (N_ROWS, 3)).astype(np.int32)}


def _blocks(ds):
    return [dict(b) for b in ds.iter_blocks()]


def _program(rd):
    """The same pipeline on either package's `data` (its runtime is up);
    every result as numpy."""
    agg = rd.Sum("v"), rd.Mean("v"), rd.Std("v")
    out = {}
    ds = rd.from_numpy(_columns(), num_blocks=5).map_batches(
        lambda b: {**b, "w": b["v"] * 2.0 + b["k"]})
    out["mapped"] = _blocks(ds)
    ds = ds.repartition(4)
    out["repartitioned"] = _blocks(ds)
    ds = ds.random_shuffle(seed=0)
    out["shuffled"] = _blocks(ds)
    out["sorted"] = _blocks(ds.sort("w"))
    out["sorted_desc"] = _blocks(ds.sort("k", descending=True,
                                         num_partitions=3))
    out["grouped"] = _blocks(ds.groupby("k").aggregate(*agg,
                                                       num_partitions=3))
    out["whole"] = ds.aggregate(*agg)
    out["batches"] = list(ds.iter_batches(batch_size=32))
    out["batches_drop_last"] = list(ds.iter_batches(batch_size=32,
                                                    drop_last=True))
    ids = rd.range(97, num_blocks=6).map_batches(
        lambda b: {"id": b["id"], "f": b["id"] * 0.5})
    out["range_shuffled"] = _blocks(ids.random_shuffle(seed=0))
    out["range_rows"] = [dict(r) for r in ids.take_all()]
    return out


def _device_program(rd, device_batches):
    """The device batches of the same data on either side, as numpy plus
    the dtype each tensor had."""
    ds = rd.from_numpy(_columns(), num_blocks=5)
    out = {}
    for key, kw in (("dataset", {}), ("dataset_partial",
                                      {"drop_last": False})):
        out[key] = [{k: (np.asarray(v), str(v.dtype)) for k, v in b.items()}
                    for b in device_batches(ds, batch_size=64, **kw)]
    (it,) = ds.streaming_split(1)
    out["iterator"] = [{k: (np.asarray(v), str(v.dtype)) for k, v in
                        b.items()} for b in it.iter_device_batches(
                            batch_size=64, **ITER_KW[rd.__name__])]
    strings = rd.from_items([{"s": f"r{i}", "n": i} for i in range(8)],
                            num_blocks=2)
    with pytest.raises(TypeError):
        list(device_batches(strings, batch_size=4))
    out["strings_refused"] = True
    return out


def _port_side():
    rt.init(num_cpus=4)
    try:
        out = _program(td)
        out["device"] = _device_program(
            td, lambda ds, **kw: ds.iter_device_batches(device="cpu", **kw))
        ds = td.from_numpy(_columns(), num_blocks=5)
        out["host_for_mesh"] = list(ds.iter_batches(batch_size=MESH_BATCH,
                                                    drop_last=True))
        out["mesh"] = {}
        for dp in range(DP):
            for fsdp in range(FSDP):
                coords = dict.fromkeys(AXIS_ORDER, 0) | {"dp": dp,
                                                         "fsdp": fsdp}
                mesh = Mesh(MeshSpec(dp=DP, fsdp=FSDP).resolve(DP * FSDP),
                            coords)
                out["mesh"][dp, fsdp] = [
                    {k: v.numpy() for k, v in b.items()}
                    for b in ds.iter_device_batches(
                        batch_size=MESH_BATCH, device="cpu", mesh=mesh)]
    finally:
        rt.shutdown()
    return out


def _jax_side():
    ray_tpu.init(num_cpus=4)
    try:
        out = _program(jd)
        out["device"] = _device_program(
            jd, lambda ds, **kw: ds.iter_device_batches(**kw))
        mesh = JaxMesh(np.asarray(jax.devices()[:DP * FSDP]).reshape(
            DP, FSDP), ("dp", "fsdp"))
        sharding = NamedSharding(mesh, PartitionSpec(("dp", "fsdp")))
        ds = jd.from_numpy(_columns(), num_blocks=5)
        out["mesh"] = {}
        for b in ds.iter_device_batches(batch_size=MESH_BATCH,
                                        sharding=sharding):
            by_rank = {}
            for k, arr in b.items():
                for shard in arr.addressable_shards:
                    coord = tuple(map(int, np.argwhere(
                        mesh.devices == shard.device)[0]))
                    by_rank.setdefault(coord, {})[k] = (
                        np.asarray(shard.data), shard.index)
            for coord, cols in by_rank.items():
                out["mesh"].setdefault(coord, []).append(cols)
    finally:
        ray_tpu.shutdown()
    return out


@pytest.fixture(scope="module")
def runs():
    port = _port_side()
    return port, _jax_side()


def _assert_blocks_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("step", ["mapped", "repartitioned", "shuffled",
                                  "sorted", "sorted_desc", "range_shuffled"])
def test_transform_blocks_equal_jax(runs, step):
    port, jax_ = runs
    _assert_blocks_equal(port[step], jax_[step])


def test_compared_steps_move_rows(runs):
    """What the equalities above hold is not the identity: the shuffle
    moved rows across blocks, and the sorts ordered them."""
    port, _ = runs

    def cat(step, k):
        return np.concatenate([b[k] for b in port[step]])

    assert not np.array_equal(cat("shuffled", "w"), cat("repartitioned", "w"))
    np.testing.assert_array_equal(np.sort(cat("shuffled", "w")),
                                  np.sort(cat("repartitioned", "w")))
    assert np.all(np.diff(cat("sorted", "w")) >= 0)
    assert np.all(np.diff(cat("sorted_desc", "k")) <= 0)


def test_groupby_and_aggregate_equal_jax(runs):
    """The group-by's Sum, Mean and Std (int64 counts, f64 moments merged
    in task order, which is fixed on both sides) equal exactly, and the
    whole-dataset aggregate too."""
    port, jax_ = runs
    _assert_blocks_equal(port["grouped"], jax_["grouped"])
    assert sum(len(b.get("k", ())) for b in port["grouped"]) == 7
    assert port["whole"].keys() == jax_["whole"].keys()
    for k, v in jax_["whole"].items():
        assert port["whole"][k] == v, k


@pytest.mark.parametrize("key", ["batches", "batches_drop_last"])
def test_iter_batches_equal_jax(runs, key):
    port, jax_ = runs
    _assert_blocks_equal(port[key], jax_[key])
    sizes = [len(b["k"]) for b in port[key]]
    assert sizes == [32] * (N_ROWS // 32) + (
        [N_ROWS % 32] if key == "batches" else [])


def test_rows_equal_jax(runs):
    port, jax_ = runs
    assert len(port["range_rows"]) == len(jax_["range_rows"]) == 97
    for g, w in zip(port["range_rows"], jax_["range_rows"]):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == w[k] and type(g[k]) is type(w[k]), k


# numpy's dtype on the port's side, JAX's 32-bit type without x64 on JAX's
PORT_DTYPES = {"k": "torch.int64", "v": "torch.float64", "x": "torch.int32"}
JAX_DTYPES = {"k": "int32", "v": "float32", "x": "int32"}


@pytest.mark.parametrize("key", ["dataset", "dataset_partial", "iterator"])
def test_device_batches_equal_jax_values(runs, key):
    """The same values in every batch; the dtypes differ as documented
    (asserted, not hidden), and `dtype=` casts both to float32."""
    port, jax_ = runs
    got, want = port["device"][key], jax_["device"][key]
    assert len(got) == len(want) == (N_ROWS // 64 + (key == "dataset_partial"))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            (gv, gt), (wv, wt) = g[k], w[k]
            if key == "iterator":
                assert (gt, wt) == ("torch.float32", "float32"), k
                np.testing.assert_array_equal(gv, wv, err_msg=k)
            else:
                assert (gt, wt) == (PORT_DTYPES[k], JAX_DTYPES[k]), k
                np.testing.assert_array_equal(gv.astype(wv.dtype), wv,
                                              err_msg=k)
                # the port's values are numpy's own, not rounded to 32 bits
                assert gv.dtype == _columns()[k].dtype


def test_device_batches_refuse_strings_on_both_sides(runs):
    port, jax_ = runs
    assert port["device"]["strings_refused"]
    assert jax_["device"]["strings_refused"]


def test_mesh_rows_equal_jax_addressable_shards(runs):
    """dp 2 x fsdp 2: each rank's rows under `mesh=` are the data and the
    index of the addressable shard of JAX's batch sharding (NamedSharding
    over P(("dp", "fsdp"))) on the device at that rank's coordinates."""
    port, jax_ = runs
    n_batches = N_ROWS // MESH_BATCH
    part = MESH_BATCH // (DP * FSDP)
    for (dp, fsdp), batches in jax_["mesh"].items():
        got = port["mesh"][dp, fsdp]
        assert len(got) == len(batches) == n_batches
        for i, (g, w) in enumerate(zip(got, batches)):
            host = port["host_for_mesh"][i]
            lo = (dp * FSDP + fsdp) * part
            for k, (data, index) in w.items():
                assert index[0] == slice(lo, lo + part), (k, index)
                np.testing.assert_array_equal(g[k], host[k][lo:lo + part])
                np.testing.assert_array_equal(g[k].astype(data.dtype), data)
    assert len(jax_["mesh"]) == DP * FSDP


def test_mesh_rows_on_a_loopback_mesh_are_the_whole_batch():
    from ray_tpu_torch.data._device import device_batches
    from ray_tpu_torch.parallel import loopback_mesh

    batch = {"t": np.arange(24).reshape(8, 3)}
    (out,) = device_batches(iter([batch]), device="cpu",
                            mesh=loopback_mesh(MeshSpec(dp=1, sp=2)))
    np.testing.assert_array_equal(out["t"].numpy(), batch["t"])
