"""tests/test_shuffle.py aimed at ray_tpu_torch.data on the port's runtime
(one module-scoped runtime): sort, groupby/aggregate, full shuffle, and
the bounded residency of the pipelined shuffle."""

import gc

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import data as rd
from ray_tpu_torch.data import Count, Max, Mean, Min, Std, Sum



@pytest.fixture(scope="module", autouse=True)
def runtime():
    rt.init(num_cpus=4)
    yield
    rt.shutdown()
    # conftest reports only ray_tpu's sanitizers: hold the port's here
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []

def _ints(values, n_blocks):
    """Dataset of one int column 'x' split over n_blocks blocks."""
    per = len(values) // n_blocks
    items = [{"x": int(v)} for v in values]
    return rd.from_items(items, num_blocks=n_blocks)


def test_sort_global_order():
    rng = np.random.default_rng(0)
    values = rng.permutation(2000)
    ds = _ints(values, n_blocks=10).sort("x", num_partitions=4)
    out = [int(r["x"]) for r in ds.iter_rows()]
    assert out == sorted(values.tolist())


def test_sort_descending_and_strings():
    rng = np.random.default_rng(1)
    values = rng.permutation(500)
    ds = _ints(values, n_blocks=5).sort("x", descending=True)
    out = [int(r["x"]) for r in ds.iter_rows()]
    assert out == sorted(values.tolist(), reverse=True)

    words = [f"w{i:04d}" for i in rng.permutation(300)]
    ds = rd.from_items([{"w": w} for w in words], num_blocks=6).sort("w")
    got = [str(r["w"]) for r in ds.iter_rows()]
    assert got == sorted(words)


def test_groupby_aggregates_match_numpy():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 13, size=3000)
    vals = rng.standard_normal(3000)
    items = [{"k": int(k), "v": float(v)} for k, v in zip(keys, vals)]
    ds = rd.from_items(items, num_blocks=12)
    out = ds.groupby("k").aggregate(
        Count(), Sum("v"), Mean("v"), Min("v"), Max("v"), Std("v"),
        num_partitions=4).take_all()
    assert len(out) == 13
    by_key = {int(r["k"]): r for r in out}
    for k in range(13):
        sel = vals[keys == k]
        r = by_key[k]
        assert r["count()"] == len(sel)
        np.testing.assert_allclose(r["sum(v)"], sel.sum(), rtol=1e-9)
        np.testing.assert_allclose(r["mean(v)"], sel.mean(), rtol=1e-9)
        np.testing.assert_allclose(r["min(v)"], sel.min())
        np.testing.assert_allclose(r["max(v)"], sel.max())
        np.testing.assert_allclose(r["std(v)"], sel.std(ddof=1),
                                   rtol=1e-8)


def test_groupby_string_keys_and_map_groups():
    items = [{"name": n, "v": i} for i, n in enumerate(
        ["a", "b", "c", "a", "b", "a"] * 10)]
    ds = rd.from_items(items, num_blocks=4)
    counts = {str(r["name"]): int(r["count()"])
              for r in ds.groupby("name").count().take_all()}
    assert counts == {"a": 30, "b": 20, "c": 10}

    # map_groups: one output row per group (group-local normalization)
    def summarize(group):
        return [{"name": group["name"][0],
                 "spread": float(group["v"].max() - group["v"].min())}]

    rows = ds.groupby("name").map_groups(summarize).take_all()
    assert len(rows) == 3
    assert all(r["spread"] > 0 for r in rows)


def test_global_aggregate():
    vals = np.arange(1000, dtype=np.float64)
    ds = rd.from_items([{"v": float(v)} for v in vals], num_blocks=8)
    out = ds.aggregate(Count(), Sum("v"), Mean("v"))
    assert out["count()"] == 1000
    assert out["sum(v)"] == vals.sum()
    assert out["mean(v)"] == pytest.approx(vals.mean())


def test_random_shuffle_is_full_and_seeded():
    n = 4000
    ds = rd.range(n, num_blocks=8)
    a = [int(r["id"]) for r in
         ds.random_shuffle(seed=7).iter_rows()]
    b = [int(r["id"]) for r in
         ds.random_shuffle(seed=7).iter_rows()]
    c = [int(r["id"]) for r in
         ds.random_shuffle(seed=8).iter_rows()]
    assert sorted(a) == list(range(n))     # a permutation
    assert a == b                          # seed-deterministic
    assert a != c and a != list(range(n))
    # full shuffle: an output block mixes rows from many input blocks
    first_blk = next(iter(ds.random_shuffle(seed=7).iter_blocks()))
    src_blocks = {int(v) // (n // 8) for v in first_blk["id"]}
    assert len(src_blocks) >= 4


def test_shuffle_residency_bounded_out_of_core_scale():
    """More shuffle data than the store would hold if every map chunk
    stayed live: the windowed merge rounds keep residency to ~one round,
    so nothing spills (reference: push_based_shuffle's bounded merge
    memory)."""
    node = rt._global_node
    base_spilled = node.store.stats()["num_spilled"]
    n_blocks, rows = 24, 30_000            # ~5.8MB of int64 total
    ds = rd.range(n_blocks * rows, num_blocks=n_blocks)
    out = ds.sort("id", num_partitions=4, merge_window=4)
    seen = 0
    for blk in out.iter_blocks():
        seen += len(blk["id"])
        del blk
    gc.collect()
    assert seen == n_blocks * rows
    stats = node.store.stats()
    assert stats["num_spilled"] == base_spilled
    from ray_tpu_torch.data.shuffle import ShuffleStats, sort_blocks
    st = ShuffleStats()
    refs = list(rd.range(n_blocks * rows,
                         num_blocks=n_blocks).streaming_block_refs())
    outs = sort_blocks(refs, "id", num_partitions=4, merge_window=4,
                       stats=st)
    rt.get(outs)
    assert st.num_rounds == n_blocks // 4
    # driver never holds more than one round of chunk refs
    assert st.peak_live_chunk_refs <= 4 * 4


def test_aggregate_edge_cases():
    """Review pins: int64 sums stay exact past 2^53, +/-inf reduce
    through Min/Max, single-row std is NaN, and -0.0/0.0 float keys
    land in one group."""
    big = 2**60
    ds = rd.from_items([{"k": 0, "v": big}, {"k": 0, "v": 1}],
                       num_blocks=2)
    (row,) = ds.groupby("k").sum("v").take_all()
    assert int(row["sum(v)"]) == big + 1         # exact int64, no float64

    ds = rd.from_items([{"k": 0, "v": np.inf}, {"k": 1, "v": -np.inf}],
                       num_blocks=1)
    rows = {int(r["k"]): r for r in ds.groupby("k").aggregate(
        Min("v"), Max("v")).take_all()}
    assert rows[0]["min(v)"] == np.inf
    assert rows[1]["max(v)"] == -np.inf

    ds = rd.from_items([{"k": 0, "v": 1.0}], num_blocks=1)
    (row,) = ds.groupby("k").std("v").take_all()
    assert np.isnan(row["std(v)"])               # variance undefined

    ds = rd.from_items([{"k": 0.0, "v": 1}, {"k": -0.0, "v": 2},
                        {"k": 1.5, "v": 3}], num_blocks=3)
    rows = ds.groupby("k").sum("v").take_all()
    sums = {float(r["k"]): int(r["sum(v)"]) for r in rows}
    assert sums == {0.0: 3, 1.5: 3}              # -0.0 merged with 0.0
