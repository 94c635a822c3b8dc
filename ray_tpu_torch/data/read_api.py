"""Datasource readers (counterpart of ``ray_tpu/data/read_api.py``,
unchanged; reference: ``python/ray/data/read_api.py`` +
``data/datasource/`` parquet/csv/json readers). Each file (or range
shard) becomes one read task — reads execute inside the streaming
executor, not eagerly on the driver.
"""

from __future__ import annotations

import builtins
import functools
from typing import Any, List, Optional, Sequence, Union

import numpy as np

from .block import block_from_rows, normalize_block
from .dataset import Dataset


def range(n: int, *, num_blocks: Optional[int] = None) -> Dataset:
    num_blocks = num_blocks or min(max(1, n // 1000), 64)
    bounds = np.linspace(0, n, num_blocks + 1, dtype=np.int64)

    def make(lo: int, hi: int):
        return {"id": np.arange(lo, hi, dtype=np.int64)}

    return Dataset(sources=[functools.partial(make, int(lo), int(hi))
                            for lo, hi in zip(bounds[:-1], bounds[1:])])


def range_tensor(n: int, *, shape=(1,),
                 num_blocks: Optional[int] = None) -> Dataset:
    num_blocks = num_blocks or min(max(1, n // 1000), 64)
    bounds = np.linspace(0, n, num_blocks + 1, dtype=np.int64)

    def make(lo: int, hi: int):
        base = np.arange(lo, hi, dtype=np.int64)
        data = np.broadcast_to(base.reshape((-1,) + (1,) * len(shape)),
                               (hi - lo,) + tuple(shape)).copy()
        return {"data": data}

    return Dataset(sources=[functools.partial(make, int(lo), int(hi))
                            for lo, hi in zip(bounds[:-1], bounds[1:])])


def from_items(items: Sequence[Any], *,
               num_blocks: int = 4) -> Dataset:
    items = list(items)
    rows = [it if isinstance(it, dict) else {"item": it} for it in items]
    num_blocks = max(1, min(num_blocks, len(rows) or 1))
    chunks = np.array_split(np.arange(len(rows)), num_blocks)

    def make(idx: np.ndarray):
        return block_from_rows([rows[i] for i in idx])

    return Dataset(sources=[functools.partial(make, c) for c in chunks
                            if len(c)])


def from_numpy(arrays: Union[np.ndarray, Dict[str, np.ndarray]],
               *, num_blocks: int = 4) -> Dataset:
    blk = normalize_block(arrays)
    n = len(next(iter(blk.values()))) if blk else 0
    num_blocks = max(1, min(num_blocks, n or 1))
    bounds = np.linspace(0, n, num_blocks + 1, dtype=np.int64)

    def make(lo: int, hi: int):
        return {k: v[lo:hi] for k, v in blk.items()}

    return Dataset(sources=[functools.partial(make, int(lo), int(hi))
                            for lo, hi in zip(bounds[:-1], bounds[1:])])


def _from_datasource(ds) -> Dataset:
    """Dataset over a FileBasedDatasource: one STREAMING read task per
    file, yielding bounded-row blocks as the read progresses."""
    return Dataset(sources=ds.sources(), source_streaming=True)


def read_csv(paths: Union[str, Sequence[str]], **kw) -> Dataset:
    from .datasource import CSVDatasource
    return _from_datasource(CSVDatasource(paths, **kw))


def read_json(paths: Union[str, Sequence[str]], *, lines: bool = True,
              **kw) -> Dataset:
    from .datasource import JSONDatasource
    return _from_datasource(JSONDatasource(paths, lines=lines, **kw))


def read_parquet(paths: Union[str, Sequence[str]], *,
                 columns: Optional[List[str]] = None, **kw) -> Dataset:
    """Parquet via pyarrow (gated so the core package has no hard
    dependency); reads stream at row-group granularity."""
    from .datasource import ParquetDatasource
    return _from_datasource(ParquetDatasource(paths, columns=columns, **kw))


def read_text(paths: Union[str, Sequence[str]], **kw) -> Dataset:
    """One row per line: {"text": str} (reference:
    ``data/read_api.py`` read_text -> text_datasource)."""
    from .datasource import TextDatasource
    return _from_datasource(TextDatasource(paths, **kw))


def read_numpy(paths: Union[str, Sequence[str]], **kw) -> Dataset:
    """.npy -> {"data": rows}; .npz -> one column per entry."""
    from .datasource import NumpyDatasource
    return _from_datasource(NumpyDatasource(paths, **kw))


def read_binary_files(paths: Union[str, Sequence[str]], **kw) -> Dataset:
    """One row per file: {"bytes", "path"}."""
    from .datasource import BinaryDatasource
    return _from_datasource(BinaryDatasource(paths, **kw))


def read_images(paths: Union[str, Sequence[str]], **kw) -> Dataset:
    """{"image": HWC array, "path"} rows via PIL (gated)."""
    from .datasource import ImageDatasource
    return _from_datasource(ImageDatasource(paths, **kw))


def read_tfrecords(paths: Union[str, Sequence[str]], **kw) -> Dataset:
    """tf.train.Example tfrecords, parsed without a tensorflow
    dependency (see ``datasource.TFRecordDatasource``)."""
    from .datasource import TFRecordDatasource
    return _from_datasource(TFRecordDatasource(paths, **kw))


def from_generators(generators: Sequence[Any]) -> Dataset:
    """Dataset whose sources are block GENERATORS: each callable yields
    blocks one at a time, and every block leaves the producing task the
    moment it is yielded (``num_returns="streaming"``), so a source that
    produces 1000 blocks never holds more than the backpressure window
    in flight. Reference analogue: streaming read tasks reporting blocks
    through ``ObjectRefGenerator`` (``_raylet.pyx:252``).

    Example::

        def read_shard(path):
            def gen():
                for chunk in open_chunks(path):
                    yield chunk_to_block(chunk)
            return gen

        ds = ray_tpu_torch.data.from_generators(
            [read_shard(p) for p in paths])
    """
    gens = list(generators)
    if not gens:
        raise ValueError("from_generators needs at least one generator")
    return Dataset(sources=gens, source_streaming=True)
