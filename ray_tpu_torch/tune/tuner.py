"""Tuner + trial controller.

Reference: ``tune/tuner.py:59`` (Tuner.fit :337), controller
``tune/execution/tune_controller.py:81`` (trials as actors via the AIR
actor manager), experiment resume ``tune/execution/experiment_state.py``
+ ``Tuner.restore``.

Each trial is an actor running the trainable under a train-session; its
``report()`` stream feeds scheduler decisions (ASHA early stop, PBT
exploit/explore) and is journaled to ``experiment.json`` for resume.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional

from .. import get, kill, wait
from ..api import remote
from ..exceptions import TaskError, WorkerCrashedError
from ..train.checkpoint import Checkpoint
from ..train.config import RunConfig
from ..train.result import Result
from ..train.session import TrainContext, _set_session
from .result_grid import ResultGrid
from .schedulers import CONTINUE, EXPLOIT, STOP, FIFOScheduler
from .search import BasicVariantGenerator


@dataclasses.dataclass
class TuneConfig:
    metric: str = "loss"
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Any = None
    search_seed: int = 0
    # a Searcher (tune.searcher) — when set, trials are created lazily
    # from its suggest() stream instead of BasicVariantGenerator
    search_alg: Any = None


@remote
class _TrialActor:
    def run(self, trainable: Callable, config: Dict[str, Any],
            queue, trial_id: str, resume_ckpt_path: Optional[str]):
        resume = Checkpoint(resume_ckpt_path) if resume_ckpt_path else None
        ctx = TrainContext(0, 1, _TaggedQueue(queue, trial_id), resume,
                           config=config, experiment_name=trial_id)
        _set_session(ctx)
        try:
            trainable(config)
        finally:
            _set_session(None)
        return trial_id


class _TaggedQueue:
    """Wraps the shared results queue, stamping payloads with trial id."""

    def __init__(self, queue, trial_id: str):
        self._q = queue
        self._tid = trial_id

    def put(self, payload):
        payload["trial_id"] = self._tid
        self._q.put(payload)


class Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any]):
        self.trial_id = trial_id
        self.config = config
        self.status = "PENDING"       # PENDING/RUNNING/TERMINATED/ERROR
        self.history: List[Dict[str, Any]] = []
        self.iteration = 0
        self.checkpoint_path: Optional[str] = None
        self.error: Optional[str] = None
        self.actor = None
        self.ref = None
        self.resume_from: Optional[str] = None

    def last_metrics(self) -> Dict[str, Any]:
        return self.history[-1] if self.history else {}

    def snapshot(self) -> dict:
        return {"trial_id": self.trial_id, "config": _jsonable(self.config),
                "status": self.status, "iteration": self.iteration,
                "checkpoint_path": self.checkpoint_path,
                "error": self.error, "history": _jsonable(self.history)}


def _jsonable(x):
    try:
        json.dumps(x)
        return x
    except (TypeError, ValueError):
        if isinstance(x, dict):
            return {k: _jsonable(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [_jsonable(v) for v in x]
        return repr(x)


def _drain_reports(queue, by_id, exp_dir, scheduler, stop_trial, exploit,
                   launch, Empty, on_result=None) -> None:
    """Apply every queued report: record history, persist checkpoints,
    let the scheduler stop/exploit running trials."""
    while True:
        try:
            payload = queue.get_nowait()
        except Empty:
            return
        trial = by_id.get(payload.get("trial_id"))
        if trial is None:
            continue
        if trial.status != "RUNNING":
            # late reports from a stopped/exploited actor are dropped —
            # the reference's killed actors simply never send them
            continue
        metrics = payload["metrics"]
        trial.iteration += 1
        metrics.setdefault("training_iteration", trial.iteration)
        trial.history.append(metrics)
        if on_result is not None:
            on_result(trial, metrics)
        if payload.get("checkpoint_path"):
            src = payload["checkpoint_path"]
            dst = os.path.join(exp_dir, trial.trial_id,
                               f"checkpoint_{trial.iteration:06d}")
            if os.path.isdir(src):
                if os.path.exists(dst):
                    shutil.rmtree(dst)
                shutil.copytree(src, dst)
                trial.checkpoint_path = dst
        decision = scheduler.on_result(trial, metrics)
        if decision == STOP:
            stop_trial(trial, "TERMINATED")
        elif decision == EXPLOIT:
            exploit(trial, scheduler, launch, stop_trial)


class Tuner:
    def __init__(self, trainable: Callable, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune = tune_config or TuneConfig()
        self._run = run_config or RunConfig()
        self._restored_trials: Optional[List[Trial]] = None

    # ------------------------------------------------------------- restore
    @classmethod
    def restore(cls, path: str, trainable: Callable) -> "Tuner":
        with open(os.path.join(path, "experiment.json")) as f:
            state = json.load(f)
        tuner = cls(trainable,
                    tune_config=TuneConfig(**state["tune_config"]),
                    run_config=RunConfig(name=state["name"],
                                         storage_path=state["storage"]))
        trials = []
        for snap in state["trials"]:
            t = Trial(snap["trial_id"], snap["config"])
            t.history = snap["history"]
            t.iteration = snap["iteration"]
            t.checkpoint_path = snap["checkpoint_path"]
            # finished trials stay finished; others rerun from checkpoint
            if snap["status"] == "TERMINATED":
                t.status = "TERMINATED"
            else:
                t.status = "PENDING"
                t.resume_from = snap["checkpoint_path"]
        # (configs with non-json values were stringified — restore only
        # supports json-able param spaces, like the reference's json journal)
            trials.append(t)
        tuner._restored_trials = trials
        return tuner

    # ----------------------------------------------------------------- fit
    def fit(self) -> ResultGrid:
        from ..util.queue import Empty, Queue

        name = self._run.name or f"tune_{int(time.time())}"
        storage = self._run.storage_path or os.path.join(
            os.path.expanduser("~"), "rtpu_results")
        exp_dir = os.path.join(storage, name)
        os.makedirs(exp_dir, exist_ok=True)
        scheduler = self._tune.scheduler or FIFOScheduler()

        searcher = self._tune.search_alg
        if self._restored_trials is not None:
            trials = self._restored_trials
            searcher = None     # restored experiments rerun as journaled
        elif searcher is not None:
            from .searcher import FINISHED  # noqa: F401
            searcher.set_search_properties(
                self._tune.metric, self._tune.mode, self._param_space)
            trials = []         # created lazily from suggest()
        else:
            gen = BasicVariantGenerator(self._param_space,
                                        self._tune.num_samples,
                                        seed=self._tune.search_seed)
            trials = [Trial(f"{name}_{i:05d}", cfg)
                      for i, cfg in enumerate(gen.variants())]

        queue = Queue()
        by_id = {t.trial_id: t for t in trials}
        pending = [t for t in trials if t.status == "PENDING"]
        running: List[Trial] = []
        n_created = len(trials)
        search_done = searcher is None

        def launch(trial: Trial) -> None:
            trial.actor = _TrialActor.remote()
            trial.ref = trial.actor.run.remote(
                self._trainable, trial.config, queue, trial.trial_id,
                trial.resume_from)
            trial.status = "RUNNING"
            running.append(trial)

        def stop_trial(trial: Trial, status: str,
                       error: Optional[str] = None) -> None:
            trial.status = status
            trial.error = error
            if trial in running:
                running.remove(trial)
            if trial.actor is not None:
                try:
                    kill(trial.actor)
                except Exception:
                    pass
                trial.actor = None
            scheduler.on_trial_complete(trial)
            # PBT exploit re-launches as PENDING — not a completion
            if searcher is not None and status in ("TERMINATED", "ERROR"):
                searcher.on_trial_complete(
                    trial.trial_id, trial.last_metrics() or None,
                    error=status == "ERROR")

        def persist() -> None:
            state = {
                "name": name, "storage": storage,
                "tune_config": {
                    "metric": self._tune.metric, "mode": self._tune.mode,
                    "num_samples": self._tune.num_samples,
                    "max_concurrent_trials":
                        self._tune.max_concurrent_trials,
                    "search_seed": self._tune.search_seed,
                },
                "trials": [t.snapshot() for t in trials],
            }
            tmp = os.path.join(exp_dir, ".experiment.json.tmp")
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, os.path.join(exp_dir, "experiment.json"))
            if searcher is not None:
                try:
                    searcher.save(os.path.join(exp_dir,
                                               "searcher_state.pkl"))
                except Exception:
                    pass   # search state is best-effort, like the ref

        def on_result(trial: Trial, metrics: Dict[str, Any]) -> None:
            if searcher is not None:
                searcher.on_trial_result(trial.trial_id, metrics)

        while pending or running or not search_done:
            if not search_done:
                from .searcher import FINISHED
                while (n_created < self._tune.num_samples
                       and len(running) + len(pending)
                       < self._tune.max_concurrent_trials):
                    tid = f"{name}_{n_created:05d}"
                    cfg = searcher.suggest(tid)
                    if cfg is FINISHED:
                        search_done = True
                        break
                    if cfg is None:    # e.g. ConcurrencyLimiter at cap
                        break
                    t = Trial(tid, cfg)
                    trials.append(t)
                    by_id[tid] = t
                    pending.append(t)
                    n_created += 1
                if n_created >= self._tune.num_samples:
                    search_done = True
            while pending and len(running) < \
                    self._tune.max_concurrent_trials:
                launch(pending.pop(0))
            if not running and not pending and not search_done:
                time.sleep(0.02)   # searcher momentarily out of configs

            _drain_reports(queue, by_id, exp_dir, scheduler, stop_trial,
                           self._exploit, launch, Empty, on_result)

            # completed/failed trial actors. A finished actor's reports
            # are all queued before its run-ref resolves, so drain once
            # more after wait() and before marking trials TERMINATED —
            # otherwise the final report would be dropped as "late".
            refs = {t.ref: t for t in running if t.ref is not None}
            if refs:
                done, _ = wait(list(refs), num_returns=len(refs),
                               timeout=0.05)
                if done:
                    _drain_reports(queue, by_id, exp_dir, scheduler,
                                   stop_trial, self._exploit, launch,
                                   Empty, on_result)
                for ref in done:
                    trial = refs[ref]
                    if trial not in running:
                        continue
                    try:
                        get(ref)
                        stop_trial(trial, "TERMINATED")
                    except (TaskError, WorkerCrashedError) as e:
                        stop_trial(trial, "ERROR", error=str(e))
            persist()
        # final drain: reports can land between the last drain and the
        # trial-completion check that ended the loop
        _drain_reports(queue, by_id, exp_dir, scheduler, stop_trial,
                       self._exploit, launch, Empty, on_result)
        persist()
        try:
            queue.shutdown()
        except Exception:
            pass

        results = []
        for t in trials:
            ckpt = Checkpoint(t.checkpoint_path) if t.checkpoint_path \
                else None
            err = RuntimeError(t.error) if t.error else None
            results.append(Result(metrics=t.last_metrics(), checkpoint=ckpt,
                                  path=os.path.join(exp_dir, t.trial_id),
                                  error=err, metrics_history=t.history))
        return ResultGrid(results, metric=self._tune.metric,
                          mode=self._tune.mode)

    def _exploit(self, trial: Trial, scheduler, launch, stop_trial) -> None:
        """PBT exploit/explore: restart from a better trial's checkpoint
        with a mutated config."""
        target = scheduler.exploit_target(trial)
        if target is None or target.checkpoint_path is None:
            return
        stop_trial(trial, "PENDING")
        trial.config = scheduler.explore(dict(target.config))
        trial.resume_from = target.checkpoint_path
        launch(trial)
