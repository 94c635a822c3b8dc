"""Dataset: lazy logical plan + streaming execution over block operators.

Counterpart of ``ray_tpu/data/dataset.py`` on the port's runtime: the same
plan, operators and tasks. ``iter_device_batches`` yields torch tensors on
a device (``_device.py``) where JAX's yields jax Arrays. Reference:
``python/ray/data/dataset.py:178`` (API surface),
``_internal/plan.py`` (logical plan), ``_internal/execution/
streaming_executor.py:49`` (backpressure-aware streaming execution),
``_internal/execution/operators/map_operator.py:39`` (fused map tasks)
and ``operators/actor_pool_map_operator.py`` (stateful UDFs on a
reusable actor pool).

Execution model: consecutive task transforms fuse into one remote task
per block (one object-store pass per chain); a stage with
``compute=ActorPoolStrategy(...)`` becomes its own operator running on
a pool of long-lived actors (the UDF class is constructed once per
actor, then reused for every block). Operators chain as generators,
each holding a bounded in-flight window — the store's high-water mark
stays at ~sum(windows) blocks regardless of dataset size, and consumed
refs are freed by the distributed refcount as the consumer drops them.
All-to-all ops (repartition / random_shuffle) are barriers that
redistribute materialized block refs with slice/concat tasks.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np

from .. import get, put, wait
from .._private import telemetry
from ..api import remote
from . import block as B

Block = B.Block

_DEFAULT_WINDOW = 8

M_DATA_BLOCKS = telemetry.define(
    "counter", "rtpu_data_blocks_total",
    "Blocks produced by data-plane operators, tagged by op")
M_DATA_ROWS = telemetry.define(
    "counter", "rtpu_data_block_rows_total",
    "Rows in blocks produced by data-plane operators")
M_DATA_BYTES = telemetry.define(
    "counter", "rtpu_data_block_bytes_total",
    "Bytes (numeric columns) in blocks produced by data-plane operators")


def _record_block(blk: Block, op: str) -> Block:
    tags = (("op", op),)
    telemetry.counter_inc(M_DATA_BLOCKS, 1.0, tags)
    telemetry.counter_inc(M_DATA_ROWS, float(B.block_num_rows(blk)), tags)
    nbytes = sum(v.nbytes for v in blk.values()
                 if getattr(v, "dtype", None) is not None
                 and v.dtype != object)
    if nbytes:
        telemetry.counter_inc(M_DATA_BYTES, float(nbytes), tags)
    return blk


# A stage is ("map_batches"|"map"|"filter"|"flat_map", fn, kwargs)
Stage = Tuple[str, Callable, dict]


class ActorPoolStrategy:
    """Run a stage's UDF on ``size`` long-lived actors (reference:
    ``ActorPoolStrategy`` / ``actor_pool_map_operator.py``). Use with a
    CLASS UDF whose construction is expensive (model weights, clients);
    each actor constructs it once and maps every block it receives.
    ``max_in_flight`` bounds queued blocks per actor (backpressure)."""

    def __init__(self, size: int = 2, max_in_flight: int = 2,
                 num_cpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None):
        if size < 1 or max_in_flight < 1:
            raise ValueError(
                f"ActorPoolStrategy needs size >= 1 and max_in_flight >= 1 "
                f"(got size={size}, max_in_flight={max_in_flight})")
        self.size = size
        self.max_in_flight = max_in_flight
        self.num_cpus = num_cpus
        self.resources = resources


def _apply_stages(blk: Block, stages: Sequence[Stage]) -> Block:
    for kind, fn, kw in stages:
        if kind == "map_batches":
            fmt = kw.get("batch_format", "numpy")
            out = fn(dict(blk) if fmt == "numpy" else list(B.block_rows(blk)))
            blk = B.normalize_block(out)
        elif kind == "map":
            blk = B.block_from_rows([fn(r) for r in B.block_rows(blk)])
        elif kind == "filter":
            keep = [i for i, r in enumerate(B.block_rows(blk)) if fn(r)]
            blk = B.block_take(blk, np.asarray(keep, np.int64)) if keep \
                else {k: v[:0] for k, v in blk.items()}
        elif kind == "flat_map":
            rows = list(itertools.chain.from_iterable(
                fn(r) for r in B.block_rows(blk)))
            blk = B.block_from_rows(rows)
        else:
            raise ValueError(f"unknown stage kind {kind}")
    return blk


@remote
def _run_block_task(source_fn: Optional[Callable], source_block,
                    stages: List[Stage]) -> Block:
    blk = source_fn() if source_fn is not None else source_block
    blk = B.normalize_block(blk)
    return _record_block(_apply_stages(blk, stages), "map_task")


@remote
def _meta_block(blk: Block):
    return B.block_metadata(blk)


@remote
def _run_gen_source(source_fn: Callable):
    """Streaming source: the producer yields blocks one by one and each
    leaves the task as soon as it is produced (num_returns=\"streaming\"
    — a 1000-block read never materializes 1000 blocks in the worker).
    Reference analogue: a read task streaming its output blocks through
    ObjectRefGenerator."""
    for blk in source_fn():
        yield _record_block(B.normalize_block(blk), "gen_source")


@remote
class _UDFActor:
    """One pool member: constructs the user's class once, maps blocks."""

    def __init__(self, ctor, args, kwargs, kind: str, stage_kw: dict):
        self.fn = ctor(*(args or ()), **(kwargs or {}))
        self.kind = kind
        self.stage_kw = stage_kw

    def call_block(self, blk: Block) -> Block:
        return _record_block(
            _apply_stages(blk, [(self.kind, self.fn, self.stage_kw)]),
            "actor_pool")


@remote
def _concat_blocks(*blocks: Block) -> Block:
    return B.block_concat(list(blocks))


@remote
def _slice_block(blk: Block, start: int, stop: int) -> Block:
    return B.block_slice(blk, start, stop)


@remote
def _add_const_key(blk: Block) -> Block:
    """Tag every row with one shared key so Dataset.aggregate can ride
    the groupby engine as a single-group reduction."""
    out = dict(blk)
    out["__all__"] = np.zeros(B.block_num_rows(blk), np.int8)
    return out


class Dataset:
    """Lazy; chainable; executed streaming on iteration/consumption."""

    def __init__(self,
                 sources: Optional[List[Callable[[], Block]]] = None,
                 block_refs: Optional[List[Any]] = None,
                 stages: Optional[List[Stage]] = None,
                 source_streaming: bool = False):
        # exactly one of sources (unread) / block_refs (materialized input)
        self._sources = sources
        self._block_refs = block_refs
        self._stages = stages or []
        # True: each source is a GENERATOR of blocks executed as a
        # streaming task (see _run_gen_source) rather than one block
        self._source_streaming = source_streaming

    # ------------------------------------------------------------ transforms
    def _with_stage(self, stage: Stage) -> "Dataset":
        return Dataset(self._sources, self._block_refs,
                       self._stages + [stage],
                       source_streaming=self._source_streaming)

    def map_batches(self, fn: Callable, *, batch_format: str = "numpy",
                    compute: Optional[ActorPoolStrategy] = None,
                    fn_constructor_args: Optional[tuple] = None,
                    fn_constructor_kwargs: Optional[dict] = None,
                    **kw) -> "Dataset":
        """``fn`` is a callable (task stage) or, with
        ``compute=ActorPoolStrategy(...)``, a class whose instances are
        constructed once per pool actor and called per block."""
        return self._with_stage(("map_batches", fn, {
            "batch_format": batch_format, "compute": compute,
            "fn_constructor_args": fn_constructor_args,
            "fn_constructor_kwargs": fn_constructor_kwargs,
        }))

    def map(self, fn: Callable) -> "Dataset":
        return self._with_stage(("map", fn, {}))

    def filter(self, fn: Callable) -> "Dataset":
        return self._with_stage(("filter", fn, {}))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._with_stage(("flat_map", fn, {}))

    # ------------------------------------------------------------- execution
    def _num_input_blocks(self) -> int:
        return len(self._sources if self._sources is not None
                   else self._block_refs or [])

    def _segments(self) -> List[Tuple[str, Any]]:
        """Fuse consecutive task stages; actor stages stand alone
        (reference: operator fusion + ActorPoolMapOperator)."""
        segs: List[Tuple[str, Any]] = []
        for st in self._stages:
            if st[2].get("compute") is not None:
                segs.append(("actors", st))
            elif segs and segs[-1][0] == "tasks":
                segs[-1][1].append(st)
            else:
                segs.append(("tasks", [st]))
        return segs

    @staticmethod
    def _task_operator(upstream: Iterator[Tuple[Optional[Callable], Any]],
                       stages: List[Stage],
                       window: int) -> Iterator[Any]:
        """Fused map tasks with a bounded in-flight window: at most
        ``window`` submitted-but-unconsumed blocks exist at this
        operator (backpressure; reference: MapOperator + the streaming
        executor's resource limits)."""
        in_flight: "deque" = deque()
        for src_fn, src_ref in upstream:
            if len(in_flight) >= window:
                yield in_flight.popleft()
            in_flight.append(_run_block_task.remote(src_fn, src_ref,
                                                    stages))
        while in_flight:
            yield in_flight.popleft()

    @staticmethod
    def _actor_operator(upstream: Iterator[Any],
                        stage: Stage) -> Iterator[Any]:
        """Map blocks over a pool of long-lived UDF actors; each actor
        holds at most ``max_in_flight`` queued blocks (reference:
        ``actor_pool_map_operator.py``)."""
        from .. import kill
        kind, ctor, kw = stage
        compute: ActorPoolStrategy = kw["compute"]
        stage_kw = {k: v for k, v in kw.items()
                    if k not in ("compute", "fn_constructor_args",
                                 "fn_constructor_kwargs")}
        opts: Dict[str, Any] = {}
        if compute.num_cpus is not None:
            opts["num_cpus"] = compute.num_cpus
        if compute.resources:
            opts["resources"] = compute.resources
        pool = [_UDFActor.options(**opts).remote(
            ctor, kw.get("fn_constructor_args"),
            kw.get("fn_constructor_kwargs"), kind, stage_kw)
            for _ in range(compute.size)]
        try:
            rr = itertools.cycle(pool)
            cap = compute.size * compute.max_in_flight
            in_flight: "deque" = deque()
            for ref in upstream:
                if len(in_flight) >= cap:
                    yield in_flight.popleft()
                in_flight.append(next(rr).call_block.remote(ref))
            while in_flight:
                # drain waits for completion: the finally kills the pool
                # the moment the consumer exhausts us, and a killed actor
                # fails its queued calls. Actors process FIFO, so the
                # last call per actor completing implies all earlier
                # yielded refs completed too.
                head = in_flight.popleft()
                wait([head], num_returns=1, timeout=None)
                yield head
        finally:
            for actor in pool:
                try:
                    kill(actor)
                except Exception:
                    pass

    def streaming_block_refs(self,
                             window: int = _DEFAULT_WINDOW
                             ) -> Iterator[Any]:
        """The streaming executor: chained operators, each with a
        bounded in-flight window, pulled by the consumer. Total live
        blocks stay ~sum of operator windows no matter how large the
        dataset is; refs the consumer drops are freed by refcounting."""
        if self._sources is not None and self._source_streaming:
            # streaming sources: block refs arrive one by one while the
            # producer task still runs; the generator's backpressure
            # window paces the producer against this consumer
            def gen_stream() -> Iterator[Any]:
                # all producers submitted up front so they run in
                # parallel (each paced by its own backpressure window);
                # drained in source order
                gens = [_run_gen_source.options(
                    num_returns="streaming").remote(fn)
                    for fn in self._sources]
                for gen in gens:
                    yield from gen
            stream = gen_stream()
            for seg_kind, payload in self._segments():
                if seg_kind == "tasks":
                    stream = self._task_operator(
                        ((None, ref) for ref in stream), payload, window)
                else:
                    stream = self._actor_operator(stream, payload)
            yield from stream
            return
        inputs: List[Tuple[Optional[Callable], Any]]
        if self._sources is not None:
            inputs = [(fn, None) for fn in self._sources]
        else:
            inputs = [(None, ref) for ref in (self._block_refs or [])]
        segs = self._segments()
        if not segs and self._sources is None:
            yield from (ref for _, ref in inputs)
            return
        if ((not segs or segs[0][0] != "tasks")
                and self._sources is not None):
            # reads executing under an actor-first pipeline still need a
            # source op; materialized refs feed the actor pool directly
            segs.insert(0, ("tasks", []))
        if segs and segs[0][0] == "tasks":
            stream: Iterator[Any] = self._task_operator(
                iter(inputs), segs[0][1], window)
            rest = segs[1:]
        else:
            stream = (ref for _, ref in inputs)
            rest = segs
        for seg_kind, payload in rest:
            if seg_kind == "tasks":
                stream = self._task_operator(
                    ((None, ref) for ref in stream), payload, window)
            else:
                stream = self._actor_operator(stream, payload)
        yield from stream

    def materialize(self) -> "Dataset":
        refs = list(self.streaming_block_refs())
        return Dataset(block_refs=refs)

    # ------------------------------------------------------------ all-to-all
    def repartition(self, num_blocks: int) -> "Dataset":
        """Barrier: equalize rows over num_blocks output blocks."""
        mat = self.materialize()
        refs = mat._block_refs or []
        counts = [B.block_num_rows(b) for b in get(refs)] if refs else []
        total = sum(counts)
        per = total // num_blocks
        sizes = [per + (1 if i < total % num_blocks else 0)
                 for i in range(num_blocks)]
        # assemble each output from input slices without driver transfer
        out_refs = []
        in_idx, in_off = 0, 0
        for size in sizes:
            parts = []
            need = size
            while need > 0 and in_idx < len(refs):
                avail = counts[in_idx] - in_off
                take = min(avail, need)
                if take > 0:
                    parts.append(_slice_block.remote(
                        refs[in_idx], in_off, in_off + take))
                    in_off += take
                    need -= take
                if in_off >= counts[in_idx]:
                    in_idx += 1
                    in_off = 0
            out_refs.append(_concat_blocks.remote(*parts) if len(parts) != 1
                            else parts[0])
        return Dataset(block_refs=out_refs)

    def random_shuffle(self, seed: Optional[int] = None, *,
                       merge_window: int = 8) -> "Dataset":
        """True all-to-all row shuffle through the push-based shuffle
        engine: every output block draws rows from every input block
        (reference: ``_internal/push_based_shuffle.py``)."""
        from .shuffle import random_shuffle_blocks
        refs = list(self.streaming_block_refs())
        return Dataset(block_refs=random_shuffle_blocks(
            refs, seed=seed, merge_window=merge_window))

    def sort(self, key: str, descending: bool = False, *,
             num_partitions: Optional[int] = None,
             merge_window: int = 8) -> "Dataset":
        """Distributed sort by a column (reference: ``Dataset.sort`` via
        ``planner/exchange/sort_task_spec.py``): sample → range
        partition through the shuffle engine → per-partition sort.
        Output blocks are globally ordered."""
        from .shuffle import sort_blocks
        refs = list(self.streaming_block_refs())
        return Dataset(block_refs=sort_blocks(
            refs, key, descending=descending,
            num_partitions=num_partitions, merge_window=merge_window))

    def groupby(self, key: str) -> "GroupedData":
        """Hash-based group-by (reference: ``Dataset.groupby`` →
        ``grouped_data.py``)."""
        return GroupedData(self, key)

    def aggregate(self, *aggs) -> Dict[str, Any]:
        """Whole-dataset aggregation without a key (reference:
        ``Dataset.aggregate``): each block folds to constant-key agg
        state, merged in remote tasks, finalized here."""
        from .shuffle import groupby_aggregate_blocks

        refs = [_add_const_key.remote(r)
                for r in self.streaming_block_refs()]
        out_refs = groupby_aggregate_blocks(refs, "__all__", list(aggs),
                                            num_partitions=1)
        blk = B.block_concat([b for b in get(out_refs)
                              if B.block_num_rows(b)])
        return {agg.name: blk[agg.name][0] if B.block_num_rows(blk)
                else None for agg in aggs}

    def split(self, n: int) -> List["Dataset"]:
        """Split into n datasets by round-robin over blocks (reference:
        ``Dataset.split`` for per-worker ingest)."""
        mat = self.materialize()
        refs = mat._block_refs or []
        return [Dataset(block_refs=refs[i::n]) for i in range(n)]

    def limit(self, n: int) -> "Dataset":
        out_refs = []
        remaining = n
        for ref in self.streaming_block_refs():
            blk_rows = B.block_num_rows(get(ref))
            if blk_rows <= remaining:
                out_refs.append(ref)
                remaining -= blk_rows
            else:
                out_refs.append(_slice_block.remote(ref, 0, remaining))
                remaining = 0
            if remaining <= 0:
                break
        return Dataset(block_refs=out_refs)

    def union(self, other: "Dataset") -> "Dataset":
        return Dataset(block_refs=(self.materialize()._block_refs
                                   + other.materialize()._block_refs))

    # ----------------------------------------------------------- consumption
    def iter_blocks(self) -> Iterator[Block]:
        for ref in self.streaming_block_refs():
            yield get(ref)

    def streaming_split(self, n: int, *, queue_size: int = 4):
        """n concurrently-consumable DataIterator shards (reference:
        ``Dataset.streaming_split`` / Train ingest ``data_config.py``);
        see ``data/iterator.py``."""
        from .iterator import streaming_split
        return streaming_split(self, n, queue_size=queue_size)

    def _windowed_apply(self, task_fn, window: int = 16) -> Iterator[Any]:
        """Map every block ref through ``task_fn`` with a bounded
        in-flight window, dropping each block ref as its result is
        consumed — aggregate queries must not defeat the streaming
        executor's residency bound by holding every ref at once."""
        in_flight: "deque" = deque()
        for ref in self.streaming_block_refs():
            in_flight.append(task_fn.remote(ref))
            del ref
            if len(in_flight) >= window:
                yield get(in_flight.popleft())
        while in_flight:
            yield get(in_flight.popleft())

    def stats(self) -> Dict[str, Any]:
        """num_blocks / num_rows / size_bytes, metadata computed
        block-by-block in remote tasks (reference: BlockMetadata
        aggregation)."""
        n_blocks = n_rows = n_bytes = 0
        schema: Dict[str, str] = {}
        for m in self._windowed_apply(_meta_block):
            if not n_blocks:
                schema = m.schema
            n_blocks += 1
            n_rows += m.num_rows
            n_bytes += m.size_bytes
        return {"num_blocks": n_blocks, "num_rows": n_rows,
                "size_bytes": n_bytes, "schema": schema}

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for blk in self.iter_blocks():
            yield from B.block_rows(blk)

    def iter_batches(self, *, batch_size: int = 256,
                     drop_last: bool = False) -> Iterator[Block]:
        """Re-batch across block boundaries."""
        buf: List[Block] = []
        buffered = 0
        for blk in self.iter_blocks():
            if not B.block_num_rows(blk):
                continue
            buf.append(blk)
            buffered += B.block_num_rows(blk)
            while buffered >= batch_size:
                merged = B.block_concat(buf)
                yield B.block_slice(merged, 0, batch_size)
                rest = B.block_slice(merged, batch_size,
                                     B.block_num_rows(merged))
                buf = [rest] if B.block_num_rows(rest) else []
                buffered = B.block_num_rows(rest)
        if buffered and not drop_last:
            yield B.block_concat(buf)

    def iter_device_batches(self, *, batch_size: int, device: Any = None,
                            mesh: Any = None, drop_last: bool = True
                            ) -> Iterator[Dict[str, Any]]:
        """Batches as torch tensors on `device` (default: the current CUDA
        device; raises without CUDA), double-buffered: host batch i+1 is
        copied while batch i computes (reference analogue:
        ``train/_internal/data_config.py`` streaming splits + torch
        dataloader prefetch). With a port ``Mesh``, each batch is this
        rank's rows of it (``act_batch``, as ``shard_batch`` cuts them).
        See ``_device.device_batches``."""
        from ._device import device_batches
        return device_batches(
            self.iter_batches(batch_size=batch_size, drop_last=drop_last),
            device=device, mesh=mesh)

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(B.block_num_rows(b) for b in self.iter_blocks())

    def schema(self) -> Dict[str, str]:
        for blk in self.iter_blocks():
            if B.block_num_rows(blk):
                return {k: str(v.dtype) for k, v in blk.items()}
        return {}

    def num_blocks(self) -> int:
        return self._num_input_blocks()

    def __repr__(self):
        stages = "+".join(s[0] for s in self._stages) or "read"
        return (f"Dataset(blocks={self._num_input_blocks()}, "
                f"stages={stages})")


class GroupedData:
    """Result of ``Dataset.groupby(key)`` (reference:
    ``python/ray/data/grouped_data.py``): aggregations ride the
    push-based shuffle engine — raw rows hash-partition by key, fold
    into per-group state at first merge, and finalize into one output
    block per partition."""

    def __init__(self, dataset: "Dataset", key: str):
        self._ds = dataset
        self._key = key

    def aggregate(self, *aggs, num_partitions: Optional[int] = None,
                  merge_window: int = 8) -> "Dataset":
        from .shuffle import groupby_aggregate_blocks
        refs = list(self._ds.streaming_block_refs())
        return Dataset(block_refs=groupby_aggregate_blocks(
            refs, self._key, list(aggs), num_partitions=num_partitions,
            merge_window=merge_window))

    def map_groups(self, fn: Callable, *, num_partitions: Optional[int]
                   = None, merge_window: int = 8) -> "Dataset":
        """Apply ``fn(group_block) -> block/rows`` once per group. Each
        group lands whole in one partition via the hash shuffle."""
        from .shuffle import map_groups_blocks
        refs = list(self._ds.streaming_block_refs())
        return Dataset(block_refs=map_groups_blocks(
            refs, self._key, fn, num_partitions=num_partitions,
            merge_window=merge_window))

    # convenience single-agg forms (reference: GroupedData.count/...)
    def count(self) -> "Dataset":
        from .aggregate import Count
        return self.aggregate(Count())

    def sum(self, on: str) -> "Dataset":
        from .aggregate import Sum
        return self.aggregate(Sum(on))

    def mean(self, on: str) -> "Dataset":
        from .aggregate import Mean
        return self.aggregate(Mean(on))

    def min(self, on: str) -> "Dataset":
        from .aggregate import Min
        return self.aggregate(Min(on))

    def max(self, on: str) -> "Dataset":
        from .aggregate import Max
        return self.aggregate(Max(on))

    def std(self, on: str, ddof: int = 1) -> "Dataset":
        from .aggregate import Std
        return self.aggregate(Std(on, ddof))


def _extend_dataset_conveniences():
    """Column/row conveniences riding existing operators (reference:
    ``Dataset.select_columns/drop_columns/add_column/rename_columns``
    and the scalar ``sum/min/max/mean/std/unique`` reducers of
    ``python/ray/data/dataset.py``)."""

    def select_columns(self, cols: List[str]) -> "Dataset":
        cols = list(cols)
        return self.map_batches(
            lambda b: {k: b[k] for k in cols})

    def drop_columns(self, cols: List[str]) -> "Dataset":
        drop = set(cols)
        return self.map_batches(
            lambda b: {k: v for k, v in b.items() if k not in drop})

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def add(b):
            out = dict(b)
            out[name] = np.asarray(fn(b))
            return out
        return self.map_batches(add)

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        return self.map_batches(
            lambda b: {mapping.get(k, k): v for k, v in b.items()})

    def _scalar(self, agg):
        return self.aggregate(agg)[agg.name]

    def sum(self, on: str):
        from .aggregate import Sum
        return _scalar(self, Sum(on))

    def min(self, on: str):
        from .aggregate import Min
        return _scalar(self, Min(on))

    def max(self, on: str):
        from .aggregate import Max
        return _scalar(self, Max(on))

    def mean(self, on: str):
        from .aggregate import Mean
        return _scalar(self, Mean(on))

    def std(self, on: str, ddof: int = 1):
        from .aggregate import Std
        return _scalar(self, Std(on, ddof))

    def unique(self, column: str) -> List[Any]:
        parts = [np.unique(np.asarray(blk[column]))
                 for blk in self.iter_blocks() if B.block_num_rows(blk)]
        if not parts:
            return []
        return np.unique(np.concatenate(parts)).tolist()

    for fn in (select_columns, drop_columns, add_column, rename_columns,
               sum, min, max, mean, std, unique):
        setattr(Dataset, fn.__name__, fn)


_extend_dataset_conveniences()
