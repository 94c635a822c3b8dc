"""Block model: columnar dicts of numpy arrays.

Counterpart of ``ray_tpu/data/block.py``, unchanged. Reference:
``python/ray/data/block.py`` (Arrow-table blocks + BlockAccessor).
Numpy-columnar blocks become torch tensors without a row pivot, and the
shm object store zero-copies numpy.
"""

from __future__ import annotations

from dataclasses import dataclass as _dataclass
from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

Block = Dict[str, np.ndarray]


def block_from_rows(rows: Sequence[Dict[str, Any]]) -> Block:
    if not rows:
        return {}
    cols: Dict[str, List[Any]] = {k: [] for k in rows[0]}
    for row in rows:
        if row.keys() != cols.keys():
            raise ValueError(
                f"inconsistent row keys: {sorted(row)} vs {sorted(cols)}")
        for k, v in row.items():
            cols[k].append(v)
    return {k: np.asarray(v) for k, v in cols.items()}


def block_num_rows(block: Block) -> int:
    for v in block.values():
        return len(v)
    return 0


def block_rows(block: Block) -> Iterator[Dict[str, Any]]:
    n = block_num_rows(block)
    keys = list(block)
    for i in range(n):
        yield {k: block[k][i] for k in keys}


def block_slice(block: Block, start: int, stop: int) -> Block:
    return {k: v[start:stop] for k, v in block.items()}


def block_concat(blocks: Sequence[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b)]
    if not blocks:
        return {}
    keys = list(blocks[0])
    return {k: np.concatenate([b[k] for b in blocks]) for k in keys}


def block_take(block: Block, indices: np.ndarray) -> Block:
    return {k: v[indices] for k, v in block.items()}


def normalize_block(data: Any) -> Block:
    """Accept dict-of-arrays, list-of-rows, or a bare array ('data' col)."""
    if isinstance(data, dict):
        return {k: np.asarray(v) for k, v in data.items()}
    if isinstance(data, np.ndarray):
        return {"data": data}
    if isinstance(data, (list, tuple)):
        if data and isinstance(data[0], dict):
            return block_from_rows(data)
        return {"data": np.asarray(data)}
    raise TypeError(f"cannot interpret {type(data)} as a block")


@_dataclass
class BlockMetadata:
    """Size/shape/schema of one block (reference: ``BlockMetadata`` in
    ``python/ray/data/block.py`` — num_rows/size_bytes/schema)."""

    num_rows: int
    size_bytes: int
    schema: Dict[str, str]          # column -> "dtype shape-tail"


def block_metadata(block: Block) -> BlockMetadata:
    num_rows = block_num_rows(block)
    size = 0
    schema: Dict[str, str] = {}
    for k, v in block.items():
        arr = np.asarray(v)
        if arr.dtype == object:
            size += sum(len(x) if isinstance(x, (bytes, str)) else 64
                        for x in arr.ravel())
            schema[k] = "object"
        else:
            size += arr.nbytes
            tail = arr.shape[1:]
            schema[k] = f"{arr.dtype}{list(tail) if tail else ''}"
    return BlockMetadata(num_rows=num_rows, size_bytes=size, schema=schema)
