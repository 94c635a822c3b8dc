"""REST front for the JobManager.

Reference: ``dashboard/modules/job/job_head.py`` — the same endpoint
shapes on the head node:

    POST /api/jobs/            {entrypoint, runtime_env?, submission_id?}
    GET  /api/jobs/            list
    GET  /api/jobs/<id>        status record
    GET  /api/jobs/<id>/logs   {"logs": "..."}
    POST /api/jobs/<id>/stop   {"stopped": bool}
"""

from __future__ import annotations

from .._private.http_util import HttpServerBase, JsonHandler
from .manager import JobManager


class _Handler(JsonHandler):
    manager: JobManager = None   # set by server factory

    def do_POST(self):
        parts = [p for p in self.path.split("/") if p]
        try:
            if parts[:2] == ["api", "jobs"] and len(parts) == 2:
                req = self._body()
                job_id = self.manager.submit(
                    entrypoint=req["entrypoint"],
                    runtime_env=req.get("runtime_env"),
                    submission_id=req.get("submission_id"),
                    metadata=req.get("metadata"),
                    working_dir_zip=req.get("working_dir_zip"))
                self._json(200, {"job_id": job_id})
            elif (parts[:2] == ["api", "jobs"] and len(parts) == 4
                  and parts[3] == "stop"):
                self._json(200, {"stopped": self.manager.stop(parts[2])})
            else:
                self._json(404, {"error": f"no route {self.path}"})
        except ValueError as e:
            self._json(400, {"error": str(e)})
        except Exception as e:   # noqa: BLE001 — API surface
            self._json(500, {"error": str(e)})

    def do_GET(self):
        parts = [p for p in self.path.split("/") if p]
        try:
            if parts[:2] == ["api", "jobs"] and len(parts) == 2:
                self._json(200, {"jobs": self.manager.list_jobs()})
            elif parts[:2] == ["api", "jobs"] and len(parts) == 3:
                rec = self.manager.get_status(parts[2])
                if rec is None:
                    self._json(404, {"error": f"no job {parts[2]}"})
                else:
                    self._json(200, rec)
            elif (parts[:2] == ["api", "jobs"] and len(parts) == 4
                  and parts[3] == "logs"):
                self._json(200, {"logs": self.manager.get_logs(parts[2])})
            else:
                self._json(404, {"error": f"no route {self.path}"})
        except Exception as e:   # noqa: BLE001 — API surface
            self._json(500, {"error": str(e)})


class JobRestServer(HttpServerBase):
    thread_name = "rtpu-job-rest"

    # loopback by default: the REST API exposes job submission (arbitrary
    # code execution) — binding all interfaces requires an explicit opt-in
    # (reference dashboard defaults to 127.0.0.1 for the same reason)
    def __init__(self, manager: JobManager, host: str = "127.0.0.1",
                 port: int = 0):
        super().__init__(_Handler, host=host, port=port, manager=manager)
