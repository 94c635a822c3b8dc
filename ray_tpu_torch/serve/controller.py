"""ServeController — declarative state reconciliation + autoscaling.

Reference: ``serve/controller.py:80`` (ServeController actor),
``_private/deployment_state.py:2258`` (DeploymentStateManager.update —
diff target vs actual, start/stop replicas), ``_private/
autoscaling_policy.py`` (queue-depth driven replica counts). One
controller actor owns all deployment state; handles poll it for replica
lists (the reference pushes via long-poll — polling with a TTL is the
same contract with simpler liveness).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from .._private import locksan
from ..api import remote


@remote(num_cpus=0, max_concurrency=8)
class ServeController:
    def __init__(self):
        # name -> {"deployment": Deployment, "replicas": [handles],
        #          "target": int}
        self._deployments: Dict[str, dict] = {}
        self._lock = locksan.lock("serve.controller")
        # (due_ts, metric, tags) for a second gauge_delete ~1s after a
        # replica kill: kill() is async, so the dying replica can still
        # publish its queue depth with a ts NEWER than the immediate
        # delete marker (the plane's tombstone only refuses older-ts
        # stragglers); once the process is actually dead a re-delete
        # is strictly the newest write and retires the series for good
        self._retire_queue: List[tuple] = []
        self._last_replica_health = 0.0
        self._autoscale_thread = threading.Thread(
            target=self._autoscale_loop, daemon=True)
        self._autoscale_thread.start()

    # ------------------------------------------------------------ lifecycle
    def deploy(self, name: str, deployment_blob: bytes,
               init_args: tuple, init_kwargs: dict,
               num_replicas: int, ray_actor_options: dict,
               autoscaling_config: Optional[dict],
               max_concurrency: int) -> None:
        from .._private import serialization as ser
        cls = ser.loads_function(deployment_blob)
        with self._lock:
            rec = self._deployments.get(name)
            if rec is None:
                rec = {"replicas": [], "target": 0}
                self._deployments[name] = rec
            rec.update(
                cls_blob=deployment_blob, cls=cls,
                init_args=init_args, init_kwargs=init_kwargs,
                actor_options=ray_actor_options or {},
                autoscaling=autoscaling_config,
                max_concurrency=max_concurrency,
                target=num_replicas)
        self._reconcile(name)

    def delete(self, name: str) -> None:
        with self._lock:
            rec = self._deployments.pop(name, None)
        if rec:
            tags = rec.get("replica_tags") or []
            pairs = [(r, tags[i] if i < len(tags) else None)
                     for i, r in enumerate(rec["replicas"])]
            self._stop_replicas(pairs, name)

    def shutdown(self) -> None:
        with self._lock:
            names = list(self._deployments)
        for n in names:
            self.delete(n)

    # ---------------------------------------------------------- introspection
    def get_replicas(self, name: str) -> List[Any]:
        with self._lock:
            rec = self._deployments.get(name)
            return list(rec["replicas"]) if rec else []

    def list_deployments(self) -> Dict[str, int]:
        with self._lock:
            return {n: len(r["replicas"])
                    for n, r in self._deployments.items()}

    # ------------------------------------------------------------- internals
    def _reconcile(self, name: str) -> None:
        from . import replica as rep
        with self._lock:
            rec = self._deployments.get(name)
            if rec is None:
                return
            want = rec["target"]
            have = len(rec["replicas"])
            cls_blob = rec["cls_blob"]
            args, kwargs = rec["init_args"], rec["init_kwargs"]
            opts = dict(rec["actor_options"])
            opts.setdefault("max_concurrency", rec["max_concurrency"])
        while have < want:
            with self._lock:
                # monotonic per-deployment tag (indices shift as
                # replicas stop; the tag names THIS replica forever in
                # access logs, metrics and worker log prefixes)
                tag = rec["next_replica_seq"] = \
                    rec.get("next_replica_seq", 0) + 1
            replica = rep.Replica.options(**opts).remote(
                cls_blob, args, kwargs, name, str(tag - 1))
            with self._lock:
                rec["replicas"].append(replica)
                rec.setdefault("replica_tags", []).append(str(tag - 1))
            have += 1
        excess = []
        with self._lock:
            tags = rec.setdefault("replica_tags", [])
            while len(rec["replicas"]) > want:
                excess.append((rec["replicas"].pop(),
                               tags.pop() if tags else None))
        self._stop_replicas(excess, name)

    def _stop_replicas(self, replicas: List[Any], name: str) -> None:
        from .. import kill
        zeroed = False
        for r, tag in replicas:
            try:
                kill(r)
            except Exception:
                pass
            if tag is not None:
                zeroed = True
                # retire the stopped replica's queue-depth series so
                # serve_health's sum/table — and every raw gauge
                # surface (Prometheus scrape, dashboard, summary) —
                # forget the dead replica instead of reporting its
                # last value forever
                self._retire_replica_series(name, tag)
        if zeroed:
            # ship the zeros NOW: the controller itself may be killed
            # right after a delete (serve.shutdown), and the
            # rate-limited task-boundary flush could skip them
            from .._private import telemetry
            telemetry.flush()

    def _retire_replica_series(self, name: str, tag: str) -> None:
        """One replica's gauge series -> the delete/tombstone path (the
        immediate marker plus a ~1s re-delete, see _retire_queue)."""
        from . import replica as rep
        from .._private import telemetry
        tags = (("deployment", name or "default"), ("replica", tag))
        telemetry.gauge_delete(rep.M_SERVE_QUEUE_DEPTH, tags)
        with self._lock:
            self._retire_queue.append(
                (time.time() + 1.0, rep.M_SERVE_QUEUE_DEPTH, tags))

    def _check_replica_health(self) -> None:
        """Replica-DEATH observation: a replica that CRASHES — rather
        than being scaled down — leaves its
        queue-depth gauge series live forever, because only the
        controlled stop path retired it. Poll the control plane's
        actor table (~1/s, one STATE_QUERY) and route every dead
        replica through the same gauge_delete/tombstone path, dropping
        the dead handle so fan-outs stop paying its timeout. The
        target count is untouched; the next reconcile/autoscale pass
        decides whether to replace the capacity."""
        now = time.time()
        if now - self._last_replica_health < 1.0:
            return
        self._last_replica_health = now
        from .._private import context as _ctx
        client = _ctx.current_client
        if client is None:
            return
        try:
            rows = client.state_query("actors", None) or []
        except Exception:   # noqa: BLE001 — health poll is best-effort
            return
        dead = set()
        for r in rows:
            if r.get("state") == "DEAD":
                aid = r.get("actor_id")
                dead.add(aid.hex() if hasattr(aid, "hex") else str(aid))
        if not dead:
            return
        crashed: List[tuple] = []
        with self._lock:
            for name, rec in self._deployments.items():
                tags = rec.setdefault("replica_tags", [])
                keep_r: List[Any] = []
                keep_t: List[Any] = []
                for i, r in enumerate(rec["replicas"]):
                    tag = tags[i] if i < len(tags) else None
                    if r.actor_id.hex() in dead:
                        crashed.append((name, tag))
                    else:
                        keep_r.append(r)
                        keep_t.append(tag)
                rec["replicas"] = keep_r
                rec["replica_tags"] = keep_t
        zeroed = False
        for name, tag in crashed:
            if tag is not None:
                zeroed = True
                self._retire_replica_series(name, tag)
        if zeroed:
            from .._private import telemetry
            telemetry.flush()
        # restore target capacity: the target count is unchanged, so a
        # reconcile spawns replacements (fresh tags) — without this, a
        # non-autoscaling deployment shrinks forever and an autoscaling
        # one whose replicas ALL crashed is skipped by the autoscale
        # loop's empty-replica guard and never recovers
        for name in {n for n, _t in crashed}:
            try:
                self._reconcile(name)
            except Exception:   # noqa: BLE001 — next pass retries
                pass

    def _flush_retires(self) -> None:
        now = time.time()
        with self._lock:
            due = [e for e in self._retire_queue if e[0] <= now]
            self._retire_queue = [e for e in self._retire_queue
                                  if e[0] > now]
        if due:
            from .._private import telemetry
            for _ts, metric, tags in due:
                telemetry.gauge_delete(metric, tags)
            telemetry.flush()

    def _autoscale_loop(self) -> None:
        from .. import get
        while True:
            time.sleep(0.25)
            self._flush_retires()
            try:
                self._check_replica_health()
            except Exception:   # noqa: BLE001 — observation only
                pass
            with self._lock:
                items = [(n, rec) for n, rec in self._deployments.items()
                         if rec.get("autoscaling")]
            for name, rec in items:
                try:
                    cfg = rec["autoscaling"]
                    with self._lock:
                        replicas = list(rec["replicas"])
                    if not replicas:
                        continue
                    depths = get([r.queue_depth.remote()
                                  for r in replicas], timeout=2.0)
                    avg = sum(depths) / len(depths)
                    target_per = cfg.get(
                        "target_num_ongoing_requests_per_replica", 2)
                    want = len(replicas)
                    if avg > target_per:
                        want += 1
                    elif avg < target_per / 2 and want > 1:
                        want -= 1
                    want = max(cfg.get("min_replicas", 1),
                               min(cfg.get("max_replicas", 4), want))
                    if want != len(replicas):
                        with self._lock:
                            rec["target"] = want
                        self._reconcile(name)
                except Exception:
                    continue
