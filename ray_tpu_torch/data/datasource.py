"""File-based datasources: one abstraction, many formats.

Counterpart of ``ray_tpu/data/datasource.py``, unchanged: pyarrow
(parquet) and PIL (images) stay imports inside the readers that need them,
so the package imports without either.

Reference analogue: ``python/ray/data/datasource/file_based_datasource.py``
(+ the per-format datasources under ``python/ray/data/datasource/``).
Design differs: a datasource here is a factory of per-file block
GENERATORS — each file is read by one streaming task
(``num_returns="streaming"``) that yields bounded-row blocks as it goes,
so a single huge file never materializes in the reading worker and the
consumer sees the first block while the read still runs.
"""

from __future__ import annotations

import glob as _glob

import os
import struct
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .block import Block, block_from_rows

DEFAULT_ROWS_PER_BLOCK = 4096


def expand_paths(paths, extension=None) -> List[str]:
    """Files / dirs / globs → sorted file list (reference:
    ``file_based_datasource.py`` path expansion). ``extension`` may be
    one suffix, a tuple of suffixes, or None (match everything)."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    exts = ((extension,) if isinstance(extension, str) else extension)
    out: List[str] = []
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            pats = [f"*{e}" for e in exts] if exts else ["*"]
            hits = set()
            for pat in pats:
                hits.update(_glob.glob(os.path.join(p, pat)))
            out.extend(sorted(hits))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


class FileBasedDatasource:
    """Base: subclasses implement ``read_file(path) -> Iterator[Block]``.

    ``sources()`` returns one generator-callable per file, ready for
    ``Dataset(sources=..., source_streaming=True)``.
    """

    extension: Optional[str] = None

    def __init__(self, paths, *, rows_per_block: int = DEFAULT_ROWS_PER_BLOCK,
                 **options: Any):
        self.paths = expand_paths(paths, self.extension)
        self.rows_per_block = rows_per_block
        self.options = options

    def read_file(self, path: str) -> Iterator[Block]:
        raise NotImplementedError

    def sources(self) -> List[Callable[[], Iterator[Block]]]:
        def make(path: str):
            def gen() -> Iterator[Block]:
                yield from self.read_file(path)
            return gen
        return [make(p) for p in self.paths]

    # ------------------------------------------------------------ helpers
    def _batched_rows(self, rows: Iterator[Dict[str, Any]]
                      ) -> Iterator[Block]:
        buf: List[Dict[str, Any]] = []
        for row in rows:
            buf.append(row)
            if len(buf) >= self.rows_per_block:
                yield block_from_rows(buf)
                buf = []
        if buf:
            yield block_from_rows(buf)


class CSVDatasource(FileBasedDatasource):
    extension = ".csv"

    def read_file(self, path: str) -> Iterator[Block]:
        import csv

        # Dtypes are decided ONCE PER FILE (cheap text pre-pass), then
        # applied to every block: per-block inference would give one
        # column different dtypes in different blocks (int64 in an
        # all-numeric block, object where an "n/a" appears), and
        # block_concat would silently promote the numeric rows to
        # strings.
        dtypes = _infer_csv_dtypes(path)
        with open(path, newline="") as f:
            for blk in self._batched_rows(csv.DictReader(f)):
                yield {k: (v.astype(dtypes[k])
                           if dtypes.get(k) is not None else v)
                       for k, v in blk.items()}


def _infer_csv_dtypes(path: str) -> Dict[str, Any]:
    """Per-column dtype for a whole CSV file: int64 if every cell parses
    as int, else float64 if every cell parses as float, else None
    (keep strings)."""
    import csv

    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        state: Dict[str, Any] = {k: np.int64
                                 for k in (reader.fieldnames or [])}
        for row in reader:
            undecided = False
            for k, dt in state.items():
                if dt is None:
                    continue
                undecided = True
                val = row.get(k)
                try:
                    if not (-2**63 <= int(val) < 2**63):
                        raise OverflowError  # would not fit int64
                except (TypeError, ValueError, OverflowError):
                    try:
                        float(val)
                        state[k] = np.float64
                    except (TypeError, ValueError):
                        state[k] = None
            if not undecided:
                break
    return state


class JSONDatasource(FileBasedDatasource):
    """JSONL by default; ``lines=False`` reads one JSON array per file."""

    extension = ".json"

    def __init__(self, paths, **kw):
        if kw.get("lines", True):
            self.extension = ".jsonl"      # instance attr: dir expansion
        super().__init__(paths, **kw)

    def read_file(self, path: str) -> Iterator[Block]:
        import json

        lines = self.options.get("lines", True)
        with open(path) as f:
            if lines:
                rows = (json.loads(ln) for ln in f if ln.strip())
                yield from self._batched_rows(rows)
            else:
                data = json.load(f)
                rows = data if isinstance(data, list) else [data]
                yield from self._batched_rows(iter(rows))


class ParquetDatasource(FileBasedDatasource):
    extension = ".parquet"

    def read_file(self, path: str) -> Iterator[Block]:
        try:
            import pyarrow.parquet as pq
        except ImportError as e:
            raise ImportError(
                "read_parquet requires pyarrow, which is not available "
                "in this environment") from e
        pf = pq.ParquetFile(path)
        columns = self.options.get("columns")
        # row-group granularity: a 100-row-group file streams 100 blocks
        for i in range(pf.num_row_groups):
            table = pf.read_row_group(i, columns=columns)
            yield {name: np.asarray(col) for name, col in
                   zip(table.column_names, table.to_pydict().values())}


class TextDatasource(FileBasedDatasource):
    """One row per line: {"text": <str>} (reference:
    ``datasource/text_datasource.py``)."""

    extension = ".txt"

    def read_file(self, path: str) -> Iterator[Block]:
        encoding = self.options.get("encoding", "utf-8")
        drop_empty = self.options.get("drop_empty_lines", True)
        with open(path, encoding=encoding, errors="replace") as f:
            rows = ({"text": ln.rstrip("\n")} for ln in f
                    if not drop_empty or ln.strip())
            yield from self._batched_rows(rows)


class BinaryDatasource(FileBasedDatasource):
    """One row per file: {"bytes": ..., "path": ...} (reference:
    ``datasource/binary_datasource.py``)."""

    def read_file(self, path: str) -> Iterator[Block]:
        with open(path, "rb") as f:
            data = f.read()
        yield {"bytes": np.array([data], dtype=object),
               "path": np.array([path], dtype=object)}


class NumpyDatasource(FileBasedDatasource):
    """.npy (one array -> {"data": rows}) and .npz (one column per
    entry) (reference: ``datasource/numpy_datasource.py``)."""

    extension = (".npy", ".npz")

    def read_file(self, path: str) -> Iterator[Block]:
        if path.endswith(".npz"):
            with np.load(path) as z:
                yield {name: z[name] for name in z.files}
            return
        arr = np.load(path)
        if arr.ndim == 0:
            arr = arr[None]
        n = self.rows_per_block
        for lo in range(0, len(arr), n):
            yield {"data": arr[lo:lo + n]}


class ImageDatasource(FileBasedDatasource):
    """Rows {"image": HWC uint8, "path": str} via PIL (gated — PIL is an
    optional dependency here, like the reference's imageio gate)."""

    def read_file(self, path: str) -> Iterator[Block]:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                "read_images requires pillow, which is not available in "
                "this environment") from e
        size = self.options.get("size")
        img = Image.open(path)
        if size is not None:
            img = img.resize(size)
        mode = self.options.get("mode")
        if mode is not None:
            img = img.convert(mode)
        yield {"image": np.asarray(img)[None],
               "path": np.array([path], dtype=object)}


# --------------------------------------------------------------- tfrecord

class TFRecordDatasource(FileBasedDatasource):
    """TFRecord files of ``tf.train.Example`` protos WITHOUT a tensorflow
    dependency: the record framing (u64 length + masked-crc framing) and
    the Example/Features/Feature proto wire format are parsed directly
    (reference capability: ``datasource/tfrecords_datasource.py``)."""

    extension = ".tfrecord"

    def read_file(self, path: str) -> Iterator[Block]:
        def rows():
            with open(path, "rb") as f:
                while True:
                    header = f.read(8)
                    if len(header) < 8:
                        return
                    (length,) = struct.unpack("<Q", header)
                    f.read(4)                      # length crc (unchecked)
                    payload = f.read(length)
                    if len(payload) < length:
                        raise ValueError(f"truncated tfrecord in {path}")
                    f.read(4)                      # data crc (unchecked)
                    yield _parse_example(payload)

        yield from self._batched_rows(rows())


def _read_varint(buf: memoryview, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview):
    """(field_number, wire_type, value) over a proto message. Supports
    varint (0), 64-bit (1), length-delimited (2), 32-bit (5)."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
        elif wt == 1:
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported proto wire type {wt}")
        yield field, wt, val


def _parse_feature(buf: memoryview):
    """tf.train.Feature: oneof bytes_list=1 / float_list=2 / int64_list=3."""
    for field, _, val in _iter_fields(buf):
        if field == 1:       # BytesList { repeated bytes value = 1 }
            return [bytes(v) for f, _, v in _iter_fields(val) if f == 1]
        if field == 2:       # FloatList { repeated float value = 1 [packed] }
            out: List[float] = []
            for f, wt, v in _iter_fields(val):
                if f != 1:
                    continue
                if wt == 2:  # packed
                    out.extend(struct.unpack(f"<{len(v) // 4}f", bytes(v)))
                else:
                    out.append(struct.unpack("<f", v)[0])
            return out
        if field == 3:       # Int64List { repeated int64 value = 1 [packed] }
            out = []
            for f, wt, v in _iter_fields(val):
                if f != 1:
                    continue
                if wt == 2:
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        out.append(_to_signed64(x))
                else:
                    out.append(_to_signed64(v))
            return out
    return []


def _to_signed64(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


def _parse_example(payload: bytes) -> Dict[str, Any]:
    """tf.train.Example { Features features = 1 };
    Features { map<string, Feature> feature = 1 }."""
    row: Dict[str, Any] = {}
    for field, _, val in _iter_fields(memoryview(payload)):
        if field != 1:
            continue
        for f2, _, entry in _iter_fields(val):
            if f2 != 1:
                continue
            key = None
            feature = None
            for f3, _, v3 in _iter_fields(entry):
                if f3 == 1:
                    key = bytes(v3).decode("utf-8")
                elif f3 == 2:
                    feature = _parse_feature(v3)
            if key is not None:
                vals = feature or []
                row[key] = vals[0] if len(vals) == 1 else vals
    return row


def write_tfrecords(path: str, rows: Sequence[Dict[str, Any]]) -> None:
    """Minimal writer (tests + export parity): encodes each row as a
    tf.train.Example record with the standard framing."""
    def varint(x: int) -> bytes:
        out = b""
        while True:
            b7 = x & 0x7F
            x >>= 7
            if x:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    def ld(field: int, payload: bytes) -> bytes:
        return varint((field << 3) | 2) + varint(len(payload)) + payload

    def feature(value) -> bytes:
        if isinstance(value, (bytes, str)):
            vb = value.encode() if isinstance(value, str) else value
            return ld(1, ld(1, vb))
        if isinstance(value, (list, tuple, np.ndarray)):
            vals = list(value)
        else:
            vals = [value]
        if all(isinstance(v, (int, np.integer)) for v in vals):
            packed = b"".join(varint(v & ((1 << 64) - 1)) for v in vals)
            return ld(3, ld(1, packed))
        packed = struct.pack(f"<{len(vals)}f", *[float(v) for v in vals])
        return ld(2, ld(1, packed))

    def example(row: Dict[str, Any]) -> bytes:
        entries = b""
        for k, v in row.items():
            entry = ld(1, k.encode()) + ld(2, feature(v))
            entries += ld(1, entry)
        return ld(1, entries)

    def masked_crc(data: bytes) -> int:
        crc = _crc32c(data)
        return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF

    with open(path, "wb") as f:
        for row in rows:
            payload = example(row)
            f.write(struct.pack("<Q", len(payload)))
            f.write(struct.pack("<I", masked_crc(struct.pack(
                "<Q", len(payload)))))
            f.write(payload)
            f.write(struct.pack("<I", masked_crc(payload)))


_CRC_TABLE: Optional[List[int]] = None


def _crc32c(data: bytes) -> int:
    """Castagnoli CRC32 (table-driven); stdlib zlib.crc32 uses the wrong
    polynomial for tfrecord framing."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF
