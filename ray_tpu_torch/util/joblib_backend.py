"""joblib backend running jobs as cluster tasks.

Reference analogue: ``python/ray/util/joblib/`` — ``register_ray()``
plugs a ParallelBackend into joblib so scikit-learn style
``Parallel(n_jobs=...)`` fan-outs run on the cluster:

    from ray_tpu_torch.util.joblib_backend import register_rtpu
    register_rtpu()
    with joblib.parallel_backend("rtpu"):
        Parallel(n_jobs=8)(delayed(f)(i) for i in range(100))
"""

from __future__ import annotations

from typing import Any, Callable, List

import ray_tpu_torch
from .._private import serialization as _ser


@ray_tpu_torch.remote
def _run_batch(batch_blob: bytes) -> Any:
    # cloudpickle by value: joblib's BatchedCalls closes over user
    # callables that workers cannot import by module path
    return _ser.loads_function(batch_blob)()


def register_rtpu() -> None:
    """Register the ``"rtpu"`` joblib parallel backend."""
    from joblib.parallel import register_parallel_backend

    register_parallel_backend("rtpu", _RtpuBackend)


try:
    from joblib._parallel_backends import ParallelBackendBase
except Exception:  # pragma: no cover — joblib ships in the image
    ParallelBackendBase = object


class _RtpuBackend(ParallelBackendBase):
    """Each joblib batch (a callable of pre-bound work items) becomes
    one remote task; joblib's own batching controls granularity."""

    supports_timeout = True
    uses_threads = False
    supports_sharedmem = False

    def __init__(self, *args, **kwargs):
        if ParallelBackendBase is not object:
            super().__init__(*args, **kwargs)

    def configure(self, n_jobs: int = 1, parallel=None, **kwargs) -> int:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self.parallel = parallel
        return self.effective_n_jobs(n_jobs)

    def effective_n_jobs(self, n_jobs: int) -> int:
        cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
        if n_jobs is None or n_jobs == -1:
            return cpus
        return max(1, min(n_jobs, cpus))

    def apply_async(self, func: Callable, callback=None):
        ref = _run_batch.remote(_ser.dumps_function(func))
        return _RtpuFuture(ref, callback)

    def abort_everything(self, ensure_ready: bool = True) -> None:
        pass  # in-flight tasks finish; their results are discarded

    def terminate(self) -> None:
        pass


class _RtpuFuture:
    """joblib waits via .get(timeout) on what apply_async returns."""

    def __init__(self, ref, callback):
        self._ref = ref
        if callback is not None:
            fut = ray_tpu_torch._ctx.current_client.as_future(ref)
            fut.add_done_callback(lambda f: callback(None))

    def get(self, timeout=None) -> List[Any]:
        return ray_tpu_torch.get(self._ref, timeout=timeout)
