"""ray_tpu_torch.tune — hyperparameter search over actor-run trials; a copy
of ``ray_tpu.tune``.

Reference: Ray Tune (``python/ray/tune/``, SURVEY §2.3): trials run as
actors, a controller schedules them against cluster resources
(``tune/execution/tune_controller.py:81``), searchers generate configs,
schedulers (ASHA ``schedulers/async_hyperband.py``, PBT ``pbt.py``) make
early-stop / exploit decisions on streamed results, experiment state is
resumable. Here trials are ray_tpu_torch actors; a trial's training loop
reports through the same session machinery as ray_tpu_torch.train, so a
TorchTrainer can be tuned unchanged. A trial's actor holds no resources
(it sees no card): a trainable reaches the card through a TorchTrainer
with ``use_gpu``, or through ``num_gpus`` tasks and actors of its own.
"""

from .result_grid import ResultGrid  # noqa: F401
from .schedulers import (  # noqa: F401
    ASHAScheduler,
    FIFOScheduler,
    PopulationBasedTraining,
)
from .search import (  # noqa: F401
    BasicVariantGenerator,
    choice,
    grid_search,
    loguniform,
    qrandint,
    quniform,
    randint,
    sample_from,
    uniform,
)
from .searcher import (  # noqa: F401
    BasicVariantSearcher,
    ConcurrencyLimiter,
    OptunaSearcher,
    Searcher,
    TPESearcher,
)
from .tuner import TuneConfig, Tuner  # noqa: F401
from ..train.session import get_checkpoint, get_context, report  # noqa: F401
