"""ray_tpu_torch.data — streaming distributed datasets, ``ray_tpu.data`` on
the port's runtime.

Reference: Ray Data (``python/ray/data/``, SURVEY §2.3): a lazy logical
plan of operators executed by a backpressure-aware streaming executor
over blocks in the object store (``_internal/execution/
streaming_executor.py:49``). Here blocks are columnar dicts of numpy
arrays in the port's shm object store; transforms run as the port's tasks
(in CPU workers, which see no card) with a bounded in-flight window. The
device-shaped addition is double-buffered device prefetch
(``Dataset.iter_device_batches`` and ``DataIterator.iter_device_batches``)
feeding torch tensors through pinned buffers and a side stream onto the
card: the only code of this package that touches CUDA (``_device.py``).
"""

from .aggregate import (  # noqa: F401
    AggregateFn,
    Count,
    Max,
    Mean,
    Min,
    Std,
    Sum,
)
from .block import BlockMetadata, block_metadata  # noqa: F401
from .dataset import ActorPoolStrategy, Dataset, GroupedData  # noqa: F401
from .iterator import DataIterator  # noqa: F401
from .read_api import (  # noqa: F401
    from_generators,
    from_items,
    from_numpy,
    range,
    range_tensor,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
    read_tfrecords,
)
from .write_api import install_writers as _install_writers
_install_writers(Dataset)
del _install_writers
from .datasource import (  # noqa: F401
    BinaryDatasource,
    CSVDatasource,
    FileBasedDatasource,
    ImageDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    TextDatasource,
    TFRecordDatasource,
)
