"""Distributed dataset writers: one output file per block, written by
remote tasks.

Counterpart of ``ray_tpu/data/write_api.py``, unchanged.

Reference: ``python/ray/data/dataset.py`` ``write_csv/write_json/
write_parquet/write_numpy`` — the write is a consuming operator: each
block is serialized by the task holding it (payloads never concentrate
on the driver), files land as ``part-NNNNN.<ext>``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np

from ..api import remote
from . import block as B

Block = B.Block


def _part_path(path: str, index: int, ext: str) -> str:
    os.makedirs(path, exist_ok=True)
    return os.path.join(path, f"part-{index:05d}{ext}")


@remote
def _write_csv_block(blk: Block, path: str, index: int) -> str:
    import csv
    out = _part_path(path, index, ".csv")
    keys = list(blk)
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(keys)
        for row in B.block_rows(blk):
            w.writerow([row[k] for k in keys])
    return out


@remote
def _write_json_block(blk: Block, path: str, index: int) -> str:
    import json
    out = _part_path(path, index, ".jsonl")
    with open(out, "w") as f:
        for row in B.block_rows(blk):
            f.write(json.dumps(
                {k: (v.tolist() if isinstance(v, np.generic)
                     or isinstance(v, np.ndarray) else v)
                 for k, v in row.items()}) + "\n")
    return out


@remote
def _write_parquet_block(blk: Block, path: str, index: int) -> str:
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError(
            "write_parquet requires pyarrow, which is not available "
            "in this environment") from e
    out = _part_path(path, index, ".parquet")
    pq.write_table(pa.table({k: pa.array(v) for k, v in blk.items()}),
                   out)
    return out


@remote
def _write_numpy_block(blk: Block, path: str, index: int,
                       column: str) -> str:
    out = _part_path(path, index, ".npy")
    np.save(out, np.asarray(blk[column]))
    return out


def install_writers(dataset_cls) -> None:
    """Attach write_* methods to Dataset (kept out of dataset.py to
    mirror the read_api/write split of the reference)."""
    from .. import get

    def _write(self, task, path: str, **kw) -> List[str]:
        files = []
        # windowed like every consuming operator: writes stream, the
        # driver holds refs for at most one window
        pending: List[Any] = []
        for i, ref in enumerate(self.streaming_block_refs()):
            pending.append(task.remote(ref, path, i, **kw))
            if len(pending) >= 8:
                files.extend(get(pending))
                pending = []
        files.extend(get(pending) if pending else [])
        return files

    def write_csv(self, path: str) -> List[str]:
        return _write(self, _write_csv_block, path)

    def write_json(self, path: str) -> List[str]:
        return _write(self, _write_json_block, path)

    def write_parquet(self, path: str) -> List[str]:
        return _write(self, _write_parquet_block, path)

    def write_numpy(self, path: str, column: str = "data") -> List[str]:
        return _write(self, _write_numpy_block, path, column=column)

    for fn in (write_csv, write_json, write_parquet, write_numpy):
        setattr(dataset_cls, fn.__name__, fn)
