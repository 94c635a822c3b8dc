"""JobSubmissionClient: talk to the job REST API from anywhere.

Reference: ``python/ray/dashboard/modules/job/sdk.py``
(JobSubmissionClient.submit_job / get_job_status / get_job_logs).
"""

from __future__ import annotations

import base64
import io
import json
import os
import time
import urllib.error
import urllib.request
import zipfile
from typing import Any, Dict, List, Optional

from .manager import JobStatus


class JobSubmissionError(RuntimeError):
    pass


class JobSubmissionClient:
    def __init__(self, address: str):
        """``address`` is ``host:port`` of the head's job REST server
        (or a full ``http://...`` URL)."""
        if not address.startswith("http"):
            address = f"http://{address}"
        self._base = address.rstrip("/")

    def _call(self, method: str, path: str,
              payload: Optional[dict] = None) -> Dict[str, Any]:
        data = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(
            self._base + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            # surface the server's JSON error body, not a bare traceback
            try:
                message = json.loads(e.read()).get("error", str(e))
            except Exception:
                message = str(e)
            raise JobSubmissionError(
                f"{method} {path} failed ({e.code}): {message}") from None

    @staticmethod
    def _package_dir(path: str, max_bytes: int = 200 << 20) -> str:
        """Zip a client-side working_dir so it ships with the request —
        the head cannot see the client's filesystem (reference: zip to
        GCS, ``packaging.py``)."""
        buf = io.BytesIO()
        total = 0
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            for root, _, files in os.walk(path):
                for name in files:
                    full = os.path.join(root, name)
                    total += os.path.getsize(full)
                    if total > max_bytes:
                        raise ValueError(
                            f"working_dir exceeds {max_bytes >> 20}MB")
                    zf.write(full, os.path.relpath(full, path))
        return base64.b64encode(buf.getvalue()).decode()

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[dict] = None,
                   submission_id: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        payload = {
            "entrypoint": entrypoint, "runtime_env": runtime_env,
            "submission_id": submission_id, "metadata": metadata,
        }
        wd = (runtime_env or {}).get("working_dir")
        if wd and os.path.isdir(wd):
            env = dict(runtime_env)
            del env["working_dir"]
            payload["runtime_env"] = env or None
            payload["working_dir_zip"] = self._package_dir(wd)
        return self._call("POST", "/api/jobs/", payload)["job_id"]

    def get_job_status(self, job_id: str) -> Dict[str, Any]:
        return self._call("GET", f"/api/jobs/{job_id}")

    def get_job_logs(self, job_id: str) -> str:
        return self._call("GET", f"/api/jobs/{job_id}/logs")["logs"]

    def stop_job(self, job_id: str) -> bool:
        return self._call("POST", f"/api/jobs/{job_id}/stop")["stopped"]

    def list_jobs(self) -> List[Dict[str, Any]]:
        return self._call("GET", "/api/jobs/")["jobs"]

    def wait_until_finished(self, job_id: str,
                            timeout: float = 300.0) -> Dict[str, Any]:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            rec = self.get_job_status(job_id)
            if rec["status"] in JobStatus.TERMINAL:
                return rec
            time.sleep(0.5)
        raise TimeoutError(f"job {job_id} still running after {timeout}s")
