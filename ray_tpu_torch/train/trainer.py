"""TorchTrainer — gang-scheduled training driver over a torch.distributed
process group.

Counterpart of ``ray_tpu/train/trainer.py`` (`JaxTrainer`). Reference flow
(SURVEY §3.4): ``BaseTrainer.fit`` (``train/base_trainer.py:608``) →
``BackendExecutor`` (``_internal/backend_executor.py:46``) →
``WorkerGroup`` (``_internal/worker_group.py:101``) spawns N worker actors
in a placement-group gang, sets up a torch process group, runs
``train_loop_per_worker``, streams ``session.report`` results back.

Kept from JAX's trainer: `fit` and its drain loop, `Result`, the gang in a
placement group (STRICT_SPREAD falling back to PACK), the elastic restart
of the whole gang from the last reported checkpoint under
`FailureConfig.max_failures`, `num_to_keep`, and `datasets=`.

The rendezvous, which JAX's trainer has none of: before the loop runs,
each worker joins one `torch.distributed` process group over the gang
(NCCL when the worker has a GPU slot, gloo when it has none), through a
`FileStore` in the experiment directory (no TCP port). Each attempt gets
a new store file: a dead rank leaves its peers blocked in a collective
until teardown kills them, and a file that such a gang used cannot be
rendezvoused on again. A worker with a GPU slot sees its card as cuda:0
(the runtime sets ``CUDA_VISIBLE_DEVICES`` at dispatch), and NCCL binds
that device, whatever the rank. The loop's ``build_mesh(spec)`` then cuts
the group into the port's mesh. The group is destroyed when the loop
ends.
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import Any, Callable, Dict, List, Optional

from .. import cluster_resources, get, get_runtime_context, kill, wait
from ..api import remote
from ..exceptions import ActorDiedError, TaskError, WorkerCrashedError
from ..util import tracing
from ..util.placement_group import placement_group, remove_placement_group
from ..util.scheduling_strategies import PlacementGroupSchedulingStrategy
from .checkpoint import Checkpoint
from .config import (CheckpointConfig, FailureConfig, RunConfig,
                     ScalingConfig)
from .result import Result
from .session import TrainContext, _set_session

_STAGING = ".staging"


@remote
class _TrainWorker:
    """One gang member; joins the gang's process group and executes the
    user loop under a session."""

    def __init__(self, rank: int, world_size: int, storage_path: str,
                 experiment_name: str):
        self.rank = rank
        self.world_size = world_size
        self.storage_path = storage_path
        self.experiment_name = experiment_name

    def node_id(self):
        return get_runtime_context().get_node_id()

    def run(self, loop_fn: Callable, config: Dict[str, Any],
            results_queue, resume_ckpt_path: Optional[str],
            dataset_shards: Optional[Dict[str, Any]] = None, *,
            store_path: str, local_rank: int = 0, attempt: int = 0):
        resume = (Checkpoint(resume_ckpt_path)
                  if resume_ckpt_path else None)
        ctx = TrainContext(self.rank, self.world_size, results_queue,
                           resume, config=config,
                           storage_path=self.storage_path,
                           experiment_name=self.experiment_name,
                           dataset_shards=dataset_shards,
                           local_rank=local_rank, attempt=attempt)
        with tracing.start_span("train::" + "rendezvous",
                                attributes={"rank": self.rank}):
            _rendezvous(self.rank, self.world_size, store_path)
        _set_session(ctx)
        try:
            with tracing.start_span("train::" + "loop",
                                    attributes={"rank": self.rank}):
                if _loop_takes_config(loop_fn):
                    loop_fn(config)
                else:
                    loop_fn()
        finally:
            _set_session(None)
            import torch.distributed as dist
            dist.destroy_process_group()
        return self.rank


def _rendezvous(rank: int, world_size: int, store_path: str) -> None:
    """Join the gang's default process group through the attempt's
    `FileStore`: NCCL on this worker's card when it has a GPU slot, gloo
    otherwise (never gloo in place of a card the worker holds)."""
    import torch
    import torch.distributed as dist

    has_gpu = bool(get_runtime_context().get_accelerator_ids()["GPU"])
    backend = "nccl" if has_gpu else "gloo"
    kw = {}
    if has_gpu:
        # the card(s) of this worker's slot, as CUDA_VISIBLE_DEVICES names
        # them: the first is cuda:0 whatever the rank
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend,
                            store=dist.FileStore(store_path, world_size),
                            rank=rank, world_size=world_size, **kw)


def _loop_takes_config(fn: Callable) -> bool:
    import inspect
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    return len([p for p in params.values()
                if p.default is inspect.Parameter.empty
                and p.kind in (p.POSITIONAL_ONLY,
                               p.POSITIONAL_OR_KEYWORD)]) >= 1


class TorchTrainer:
    """Run ``train_loop_per_worker`` on a gang of workers joined in one
    `torch.distributed` process group.

    train_loop_per_worker: callable taking (config) or (); uses
    ``ray_tpu_torch.train.report`` / ``get_checkpoint`` / ``get_context``
    and builds its mesh with ``parallel.build_mesh``. Each worker joins
    the group over NCCL when it has a GPU slot and over gloo when it has
    none.
    """

    def __init__(self,
                 train_loop_per_worker: Callable,
                 *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None):
        self._loop = train_loop_per_worker
        self._loop_config = train_loop_config or {}
        self._scaling = scaling_config or ScalingConfig()
        self._run_config = run_config or RunConfig()
        self._failure = self._run_config.failure_config or FailureConfig()
        self._ckpt_config = (self._run_config.checkpoint_config
                             or CheckpointConfig())
        # {name: dataset} — each split into one streaming shard per worker
        # at fit() (and again per elastic restart); workers consume via
        # session.get_dataset_shard(name) (reference: Train datasets= +
        # data_config.py streaming split)
        self._datasets = datasets or {}
        # one line per failed attempt of the last fit(), restarted or not
        self.failures: List[str] = []

    # ------------------------------------------------------------------ fit
    def fit(self) -> Result:
        with tracing.start_span("train::" + "fit"):
            return self._fit()

    def _fit(self) -> Result:
        from ..util.queue import Queue

        sc = self._scaling
        need = sc.bundle().get("GPU", 0) * sc.num_workers
        have = cluster_resources().get("GPU", 0)
        if need > have:
            raise RuntimeError(
                f"the gang needs {need:g} GPU slots and the cluster has "
                f"{have:g}; pass ScalingConfig(use_gpu=False) for CPU "
                "workers")
        name = self._run_config.name or "torch_train"
        storage = self._run_config.storage_path or os.path.join(
            os.path.expanduser("~"), "rtpu_results")
        exp_dir = os.path.join(storage, name)
        os.makedirs(exp_dir, exist_ok=True)

        attempts = 0
        self.failures = []
        latest_ckpt: Optional[Checkpoint] = None
        history: List[Dict[str, Any]] = []
        last_metrics: Dict[str, Any] = {}
        saved_ckpts: List[str] = []
        error: Optional[Exception] = None

        while True:
            queue = Queue()
            gang, shard_sets = {}, {}
            # a new rendezvous file for every attempt
            store_path = os.path.join(
                exp_dir, f".rendezvous_{attempts}_{uuid.uuid4().hex[:8]}")
            try:
                # the gang is up once every worker has answered
                with tracing.start_span("train::" + "gang",
                                        attributes={"attempt": attempts}):
                    gang = self._spawn_gang(name, storage)
                    nodes = get([w.node_id.remote()
                                 for w in gang["workers"]])
                # fresh streaming shards per attempt: the pipeline
                # re-executes from the start on an elastic restart
                shard_sets = {
                    ds_name: ds.streaming_split(self._scaling.num_workers)
                    for ds_name, ds in self._datasets.items()}
                refs = [w.run.remote(self._loop, self._loop_config, queue,
                                     latest_ckpt.path if latest_ckpt
                                     else None,
                                     {ds_name: shards[rank]
                                      for ds_name, shards
                                      in shard_sets.items()},
                                     store_path=store_path,
                                     local_rank=nodes[:rank].count(
                                         nodes[rank]),
                                     attempt=attempts)
                        for rank, w in enumerate(gang["workers"])]
                pending = list(refs)
                while pending:
                    _drain(queue, exp_dir, saved_ckpts, self._ckpt_config,
                           history)
                    latest_ckpt, last_metrics = _latest(history, latest_ckpt,
                                                        last_metrics)
                    done, pending = wait(pending,
                                         num_returns=len(pending),
                                         timeout=0.05)
                    for ref in done:
                        get(ref)        # surface worker exceptions
                _drain(queue, exp_dir, saved_ckpts, self._ckpt_config,
                       history)
                latest_ckpt, last_metrics = _latest(history, latest_ckpt,
                                                    last_metrics)
                error = None
                break
            except (TaskError, WorkerCrashedError, ActorDiedError) as e:
                # capture reports that landed before the crash — the last
                # checkpoint is the restart point (a gang member found dead
                # at a later call, say killed by the memory monitor, is a
                # crash too)
                try:
                    _drain(queue, exp_dir, saved_ckpts, self._ckpt_config,
                           history)
                    latest_ckpt, last_metrics = _latest(
                        history, latest_ckpt, last_metrics)
                except Exception:
                    pass
                self.failures.append(f"attempt {attempts}: "
                                     f"{type(e).__name__}: {e}")
                attempts += 1
                budget = self._failure.max_failures
                if budget >= 0 and attempts > budget:
                    error = e
                    break
                # elastic restart from last checkpoint
            finally:
                self._teardown_gang(gang)
                try:
                    queue.shutdown()
                except Exception:
                    pass
                # shard queues + their feeder threads must die with the
                # attempt, or elastic restarts leak a queue-actor set
                # (and the pinned block refs inside) per retry
                for shards in shard_sets.values():
                    for shard in shards:
                        shard.shutdown()
                try:
                    os.unlink(store_path)
                except OSError:
                    pass
        shutil.rmtree(os.path.join(exp_dir, _STAGING), ignore_errors=True)

        # surface the persisted copy of the final checkpoint if any
        final_ckpt = Checkpoint(saved_ckpts[-1]) if saved_ckpts else \
            latest_ckpt
        return Result(metrics=last_metrics, checkpoint=final_ckpt,
                      path=exp_dir, error=error,
                      metrics_history=[h["metrics"] for h in history
                                       if h["rank"] == 0])

    # ------------------------------------------------------------- plumbing
    def _spawn_gang(self, name: str, storage: str) -> dict:
        sc = self._scaling
        bundle = sc.bundle()
        pg = placement_group([bundle] * sc.num_workers,
                             strategy=sc.placement_strategy)
        try:
            pg.ready(timeout=60.0)
        except TimeoutError:
            if sc.placement_strategy == "STRICT_SPREAD":
                # dev fallback: fewer nodes than workers — pack instead
                remove_placement_group(pg)
                pg = placement_group([bundle] * sc.num_workers,
                                     strategy="PACK")
                pg.ready(timeout=60.0)
            else:
                raise
        workers = []
        try:
            for rank in range(sc.num_workers):
                strat = PlacementGroupSchedulingStrategy(
                    placement_group=pg, placement_group_bundle_index=rank)
                opts = {"scheduling_strategy": strat,
                        "num_cpus": bundle.get("CPU", 1.0),
                        "num_gpus": bundle.get("GPU", 0)}
                extra = {k: v for k, v in bundle.items()
                         if k not in ("CPU", "GPU")}
                if extra:
                    opts["resources"] = extra
                workers.append(_TrainWorker.options(**opts).remote(
                    rank, sc.num_workers, storage, name))
            return {"pg": pg, "workers": workers}
        except Exception:
            for w in workers:
                try:
                    kill(w)
                except Exception:
                    pass
            remove_placement_group(pg)
            raise

    def _teardown_gang(self, gang: dict) -> None:
        for w in gang.get("workers", ()):
            try:
                kill(w)
            except Exception:
                pass
        try:
            remove_placement_group(gang["pg"])
        except Exception:
            pass


def _latest(history, latest_ckpt, last_metrics):
    """Rank-0's most recent report drives Result metrics/checkpoint."""
    for payload in reversed(history):
        if payload["rank"] == 0:
            last_metrics = payload["metrics"]
            if payload.get("checkpoint_path"):
                latest_ckpt = Checkpoint(payload["checkpoint_path"])
            break
    return latest_ckpt, last_metrics


def _drain(queue, exp_dir: str, saved: List[str],
           ckpt_config: CheckpointConfig,
           history: List[Dict[str, Any]]) -> None:
    """Pull all pending reports; persist rank-0 checkpoints into the
    experiment dir (checkpoint_000N) honoring num_to_keep. A checkpoint
    the gang wrote into the experiment's staging area (a sharded one:
    every rank's files, complete once rank 0 has reported it) is moved
    there, any other copied."""
    from ..util.queue import Empty
    staging = os.path.join(exp_dir, _STAGING) + os.sep
    while True:
        try:
            payload = queue.get_nowait()
        except Empty:
            break
        history.append(payload)
        src = payload.get("checkpoint_path")
        if src and os.path.isdir(src):
            dst = os.path.join(exp_dir,
                               f"checkpoint_{len(saved):06d}")
            if os.path.exists(dst):
                shutil.rmtree(dst)
            if os.path.abspath(src).startswith(staging):
                shutil.move(src, dst)
            else:
                shutil.copytree(src, dst)
            payload["checkpoint_path"] = dst
            saved.append(dst)
            keep = ckpt_config.num_to_keep
            if keep and len(saved) > keep:
                for old in saved[:-keep]:
                    shutil.rmtree(old, ignore_errors=True)
                del saved[:-keep]
