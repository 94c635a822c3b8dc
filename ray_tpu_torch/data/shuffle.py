"""Push-based shuffle engine: the all-to-all half of the Data layer.

Counterpart of ``ray_tpu/data/shuffle.py``, unchanged: the same tasks on
the port's runtime and store, and the same seeds, so a shuffle, sort or
group-by gives the same blocks as ``ray_tpu``'s.

Reference: ``python/ray/data/_internal/push_based_shuffle.py`` (two-stage
pipelined shuffle: map tasks partition blocks, merge tasks combine
chunks round by round so reducer memory stays bounded) and
``planner/exchange/sort_task_spec.py`` (sample → boundaries → range
partition). The design here keeps the reference's round structure but
rides this runtime's primitives: map tasks ``put()`` each partition
chunk into the shm object store and return only refs, so a reducer
pulls exactly its partition's bytes; merge tasks chain on their own
previous partial, so round r+1's maps overlap round r's merges without
any driver-side barrier.

Memory bound: live chunk objects never exceed one round's output
(``merge_window`` maps × ``num_partitions`` chunks) plus the P partials
— asserted by ``ShuffleStats.peak_live_chunk_refs`` in tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np

from .. import get
from ..api import remote
from . import block as B

Block = B.Block

DEFAULT_MERGE_WINDOW = 8


@dataclass
class ShuffleStats:
    num_maps: int = 0
    num_rounds: int = 0
    num_partitions: int = 0
    peak_live_chunk_refs: int = 0
    extras: Dict[str, Any] = field(default_factory=dict)


@remote
def _shuffle_map(blk: Block, partition_fn: Callable,
                 num_partitions: int, map_index: int) -> List[Any]:
    """Partition one block; each chunk goes to the object store
    separately so reducers fetch only their own partition's bytes."""
    from .. import put
    chunks = partition_fn(blk, num_partitions, map_index)
    assert len(chunks) == num_partitions
    return [put(c) for c in chunks]


@remote
def _shuffle_merge(merge_fn: Callable[[Optional[Block], List[Block]], Block],
                   partial: Optional[Block], *chunks: Block) -> Block:
    return merge_fn(partial, list(chunks))


def shuffle_exec(block_refs: Iterable[Any], *, num_partitions: int,
                 partition_fn: Callable[[Block, int], List[Block]],
                 merge_fn: Callable[[Optional[Block], List[Block]], Block],
                 merge_window: int = DEFAULT_MERGE_WINDOW,
                 stats: Optional[ShuffleStats] = None) -> List[Any]:
    """Run the two-stage shuffle; returns one partial-ref per partition
    (in partition order). The caller chains finalize tasks on them.

    Rounds pipeline themselves: each partition's merge chains on that
    partition's previous partial ref only, so the scheduler runs round
    r merges concurrently with round r+1 maps.
    """
    st = stats if stats is not None else ShuffleStats()
    st.num_partitions = num_partitions
    partials: List[Optional[Any]] = [None] * num_partitions
    live_chunks = 0

    def flush(round_chunk_lists: List[List[Any]]) -> None:
        nonlocal live_chunks
        if not round_chunk_lists:
            return
        st.num_rounds += 1
        for p in range(num_partitions):
            chunks = [lst[p] for lst in round_chunk_lists]
            partials[p] = _shuffle_merge.remote(merge_fn, partials[p],
                                                *chunks)
        # chunk refs drop here; once each merge consumes its inputs the
        # refcount frees the chunk objects — residency stays one round
        live_chunks -= sum(len(lst) for lst in round_chunk_lists)

    pending_maps: List[Any] = []
    round_lists: List[List[Any]] = []
    for ref in block_refs:
        pending_maps.append(_shuffle_map.remote(ref, partition_fn,
                                                num_partitions,
                                                st.num_maps))
        st.num_maps += 1
        if len(pending_maps) >= merge_window:
            round_lists = get(pending_maps)
            pending_maps = []
            live_chunks += sum(len(lst) for lst in round_lists)
            st.peak_live_chunk_refs = max(st.peak_live_chunk_refs,
                                          live_chunks)
            flush(round_lists)
    if pending_maps:
        round_lists = get(pending_maps)
        live_chunks += sum(len(lst) for lst in round_lists)
        st.peak_live_chunk_refs = max(st.peak_live_chunk_refs,
                                      live_chunks)
        flush(round_lists)
    return partials


# --------------------------------------------------------------- sort

def _scatter(blk: Block, part: np.ndarray, num_partitions: int
             ) -> List[Block]:
    """Split a block into per-partition sub-blocks by index array."""
    return [B.block_take(blk, np.nonzero(part == p)[0])
            for p in range(num_partitions)]


def _empty_parts(num_partitions: int) -> List[Block]:
    return [{} for _ in range(num_partitions)]



def _range_partition(boundaries: np.ndarray, key: str, descending: bool
                     ) -> Callable:
    def fn(blk: Block, num_partitions: int, map_index: int) -> List[Block]:
        if not B.block_num_rows(blk):
            return _empty_parts(num_partitions)
        keys = np.asarray(blk[key])
        part = np.searchsorted(boundaries, keys, side="right")
        if descending:
            part = (num_partitions - 1) - part
        return _scatter(blk, part, num_partitions)
    return fn


def _concat_merge(partial: Optional[Block], chunks: List[Block]) -> Block:
    parts = ([partial] if partial else []) + chunks
    return B.block_concat(parts)


@remote
def _sort_finalize(blk: Block, key: str, descending: bool) -> Block:
    if not B.block_num_rows(blk):
        return blk
    order = np.argsort(np.asarray(blk[key]), kind="stable")
    if descending:
        order = order[::-1]
    return B.block_take(blk, order)


@remote
def _sample_keys(blk: Block, key: str, k: int, seed: int) -> np.ndarray:
    n = B.block_num_rows(blk)
    if not n:
        return np.asarray([])
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=min(k, n), replace=False)
    return np.asarray(blk[key])[idx]


def sort_blocks(block_refs: List[Any], key: str, *,
                descending: bool = False,
                num_partitions: Optional[int] = None,
                merge_window: int = DEFAULT_MERGE_WINDOW,
                sample_size: int = 64,
                stats: Optional[ShuffleStats] = None) -> List[Any]:
    """Distributed sort: sample → range boundaries → shuffle → per-
    partition sort. Output block p holds the p-th key range; global
    order is the block order (reference: ``sort_task_spec.py``)."""
    if not block_refs:
        return []
    P = num_partitions or min(len(block_refs), 16)
    sampled = [s for s in get([_sample_keys.remote(r, key, sample_size, i)
                               for i, r in enumerate(block_refs)])
               if len(s)]
    if sampled:
        ordered = np.sort(np.concatenate(sampled))
        # index-based quantiles work for any orderable dtype (strings
        # included), unlike np.quantile
        idx = [int(round(q * (len(ordered) - 1)))
               for q in np.linspace(0, 1, P + 1)[1:-1]]
        boundaries = ordered[idx]
    else:
        boundaries = np.asarray([])
    partials = shuffle_exec(
        block_refs, num_partitions=P,
        partition_fn=_range_partition(boundaries, key, descending),
        merge_fn=_concat_merge, merge_window=merge_window, stats=stats)
    return [_sort_finalize.remote(p, key, descending) for p in partials]


# ---------------------------------------------------- random shuffle

def _random_partition(seed: int) -> Callable:
    def fn(blk: Block, num_partitions: int, map_index: int) -> List[Block]:
        n = B.block_num_rows(blk)
        if not n:
            return _empty_parts(num_partitions)
        rng = np.random.default_rng((seed, map_index))
        part = rng.integers(0, num_partitions, size=n)
        return _scatter(blk, part, num_partitions)
    return fn


@remote
def _permute_finalize(blk: Block, seed: int) -> Block:
    n = B.block_num_rows(blk)
    if not n:
        return blk
    return B.block_take(blk, np.random.default_rng(seed).permutation(n))


def random_shuffle_blocks(block_refs: List[Any], *,
                          seed: Optional[int] = None,
                          num_partitions: Optional[int] = None,
                          merge_window: int = DEFAULT_MERGE_WINDOW,
                          stats: Optional[ShuffleStats] = None
                          ) -> List[Any]:
    """True all-to-all row shuffle (reference:
    ``push_based_shuffle.py``): every output block draws rows from
    every input block, then permutes locally."""
    if not block_refs:
        return []
    P = num_partitions or len(block_refs)
    base = int(seed if seed is not None else
               np.random.default_rng().integers(2**31))
    # distinct per-map streams: partition seed mixes in the map index
    refs = list(block_refs)
    partials = []
    idx_partials = shuffle_exec(
        refs, num_partitions=P,
        partition_fn=_random_partition(base),
        merge_fn=_concat_merge, merge_window=merge_window, stats=stats)
    for p, ref in enumerate(idx_partials):
        partials.append(_permute_finalize.remote(ref, base + 7919 * (p + 1)))
    return partials


# --------------------------------------------------------- group-by

def _hash_partition(key: str) -> Callable:
    def fn(blk: Block, num_partitions: int, map_index: int) -> List[Block]:
        if not B.block_num_rows(blk):
            return _empty_parts(num_partitions)
        keys = np.asarray(blk[key])
        if keys.dtype.kind in "iub":
            h = keys.astype(np.uint64)
        elif keys.dtype.kind == "f":
            k = keys.astype(np.float64)
            # canonicalize bit patterns of equal keys: -0.0 == 0.0 and
            # all NaN payloads must land in one partition
            k = np.where(k == 0.0, 0.0, k)
            k = np.where(np.isnan(k), np.nan, k)
            h = k.view(np.uint64)
        else:
            # str/bytes/object: Python's hash() is per-process salted —
            # maps in different workers would split one group across
            # partitions; crc32 is process-stable
            import zlib
            h = np.asarray([zlib.crc32(str(x).encode()) for x in keys],
                           dtype=np.uint64)
        h = (h ^ (h >> np.uint64(33))) * np.uint64(0xff51afd7ed558ccd)
        part = (h % np.uint64(num_partitions)).astype(np.int64)
        return _scatter(blk, part, num_partitions)
    return fn


def _agg_state_merge(key: str, aggs) -> Callable:
    """Merge fn for groupby: partial state blocks re-group on the key
    and each aggregate combines its namespaced state columns."""
    def fn(partial: Optional[Block], chunks: List[Block]) -> Block:
        # chunks are RAW row blocks on the first touch; partials are
        # state blocks (marked by the __key__ column)
        states = [partial] if partial else []
        for c in chunks:
            if not B.block_num_rows(c):
                continue
            keys = np.asarray(c[key])
            uniq, gid = np.unique(keys, return_inverse=True)
            st: Block = {"__key__": uniq}
            for i, agg in enumerate(aggs):
                for name, col in agg.init_state(c, gid, len(uniq)).items():
                    st[f"a{i}__{name}"] = col
            states.append(st)
        states = [s for s in states if B.block_num_rows(s)]
        if not states:
            return {}
        if len(states) == 1:
            return states[0]
        allk = np.concatenate([s["__key__"] for s in states])
        uniq, gid = np.unique(allk, return_inverse=True)
        out: Block = {"__key__": uniq}
        for i, agg in enumerate(aggs):
            prefix = f"a{i}__"
            cat = {nm[len(prefix):]: np.concatenate(
                       [s[nm] for s in states])
                   for nm in states[0] if nm.startswith(prefix)}
            for name, col in agg.combine(cat, gid, len(uniq)).items():
                out[prefix + name] = col
        return out
    return fn


@remote
def _agg_finalize(state: Block, key: str, aggs) -> Block:
    if not B.block_num_rows(state):
        return {}
    out: Block = {key: state["__key__"]}
    for i, agg in enumerate(aggs):
        prefix = f"a{i}__"
        cols = {nm[len(prefix):]: state[nm]
                for nm in state if nm.startswith(prefix)}
        out[agg.name] = agg.finalize(cols)
    return out


def groupby_aggregate_blocks(block_refs: List[Any], key: str, aggs, *,
                             num_partitions: Optional[int] = None,
                             merge_window: int = DEFAULT_MERGE_WINDOW,
                             stats: Optional[ShuffleStats] = None
                             ) -> List[Any]:
    """Hash-shuffle + combine: map chunks carry raw rows, merges fold
    them into per-group state immediately (map-side pre-aggregation
    happens at the first merge a chunk meets), so partial size is
    O(groups), not O(rows)."""
    if not block_refs:
        return []
    P = num_partitions or min(len(block_refs), 16)
    partials = shuffle_exec(
        block_refs, num_partitions=P, partition_fn=_hash_partition(key),
        merge_fn=_agg_state_merge(key, aggs),
        merge_window=merge_window, stats=stats)
    return [_agg_finalize.remote(p, key, aggs) for p in partials]


@remote
def _map_groups_finalize(blk: Block, key: str, fn: Callable) -> Block:
    if not B.block_num_rows(blk):
        return {}
    keys = np.asarray(blk[key])
    order = np.argsort(keys, kind="stable")
    sorted_blk = B.block_take(blk, order)
    sorted_keys = keys[order]
    bounds = np.nonzero(np.concatenate(
        ([True], sorted_keys[1:] != sorted_keys[:-1])))[0]
    bounds = np.append(bounds, len(sorted_keys))
    outs = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        group = B.block_slice(sorted_blk, int(lo), int(hi))
        outs.append(B.normalize_block(fn(group)))
    return B.block_concat(outs)


def map_groups_blocks(block_refs: List[Any], key: str, fn: Callable, *,
                      num_partitions: Optional[int] = None,
                      merge_window: int = DEFAULT_MERGE_WINDOW,
                      stats: Optional[ShuffleStats] = None) -> List[Any]:
    """Hash-shuffle rows so each group lands whole in one partition,
    then apply ``fn`` per group (reference: ``GroupedData.map_groups``)."""
    if not block_refs:
        return []
    P = num_partitions or min(len(block_refs), 16)
    partials = shuffle_exec(
        block_refs, num_partitions=P, partition_fn=_hash_partition(key),
        merge_fn=_concat_merge, merge_window=merge_window, stats=stats)
    return [_map_groups_finalize.remote(p, key, fn) for p in partials]
