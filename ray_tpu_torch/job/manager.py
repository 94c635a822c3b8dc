"""JobManager: supervised driver-script execution with status + logs.

Reference: ``dashboard/modules/job/job_manager.py:525``. A submitted
entrypoint (a shell command) runs as a supervised subprocess in the head
node's process group with ``RTPU_ADDRESS`` pointing at the cluster, so
the script's ``ray_tpu_torch.init(address=os.environ["RTPU_ADDRESS"])``
attaches as a real driver. Status and metadata live in the GCS KV under
``job:<submission_id>`` (PENDING → RUNNING → SUCCEEDED/FAILED/STOPPED);
stdout+stderr are captured per job and served back through
``get_logs``/REST.

Difference from the reference, on purpose: supervision is a thread in
the head process rather than a detached supervisor actor — one fewer
moving part at this scale; the actor-based form can land once jobs need
to survive head-component restarts.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from .._private import locksan
from .._private import runtime_env as renv


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


class JobManager:
    def __init__(self, gcs, cluster_address: str, session_dir: str):
        self.gcs = gcs
        self.cluster_address = cluster_address
        self.log_dir = os.path.join(session_dir, "job_logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self.session_dir = session_dir
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = locksan.lock("jobs.manager")

    # ------------------------------------------------------------- records
    def _key(self, job_id: str) -> bytes:
        return b"job:" + job_id.encode()

    def _write(self, job_id: str, rec: Dict[str, Any]) -> None:
        self.gcs.kv_put(self._key(job_id), json.dumps(rec).encode())

    def _read(self, job_id: str) -> Optional[Dict[str, Any]]:
        raw = self.gcs.kv_get(self._key(job_id))
        return json.loads(raw) if raw else None

    # ---------------------------------------------------------------- API
    def submit(self, entrypoint: str,
               runtime_env: Optional[dict] = None,
               submission_id: Optional[str] = None,
               metadata: Optional[Dict[str, str]] = None,
               working_dir_zip: Optional[str] = None) -> str:
        job_id = submission_id or f"rtpu-job-{uuid.uuid4().hex[:10]}"
        if self._read(job_id) is not None:
            raise ValueError(f"job {job_id!r} already exists")
        if working_dir_zip:
            # client shipped its working_dir (the head can't see the
            # client's filesystem); unpack and use as the job's cwd
            runtime_env = dict(runtime_env or {})
            runtime_env["working_dir"] = self._unpack_package(
                job_id, working_dir_zip)
        env = renv.validate(runtime_env)
        rec = {
            "job_id": job_id,
            "entrypoint": entrypoint,
            "status": JobStatus.PENDING,
            "start_time": time.time(),
            "end_time": None,
            "return_code": None,
            "message": "",
            "metadata": metadata or {},
        }
        self._write(job_id, rec)
        t = threading.Thread(target=self._supervise,
                             args=(job_id, entrypoint, env),
                             name=f"rtpu-job-{job_id}", daemon=True)
        t.start()
        return job_id

    def _unpack_package(self, job_id: str, b64: str) -> str:
        import base64
        import io
        import zipfile
        target = os.path.join(self.session_dir, "job_pkgs", job_id)
        os.makedirs(target, exist_ok=True)
        with zipfile.ZipFile(io.BytesIO(base64.b64decode(b64))) as zf:
            for name in zf.namelist():
                # refuse path traversal out of the package dir
                dest = os.path.realpath(os.path.join(target, name))
                if not dest.startswith(os.path.realpath(target) + os.sep):
                    raise ValueError(f"unsafe path in package: {name!r}")
            zf.extractall(target)
        return target

    def _supervise(self, job_id: str, entrypoint: str,
                   runtime_env: Optional[dict]) -> None:
        rec = self._read(job_id)
        log_path = os.path.join(self.log_dir, f"{job_id}.log")
        try:
            env = dict(os.environ)
            env["RTPU_ADDRESS"] = self.cluster_address
            env["RTPU_JOB_ID"] = job_id
            env["PYTHONUNBUFFERED"] = "1"
            cwd = os.getcwd()
            if runtime_env:
                overrides, env_cwd = renv.stage(runtime_env,
                                                self.session_dir)
                env.update(overrides)
                if env_cwd:
                    cwd = env_cwd
            # the framework itself must stay importable from the job
            # (dev checkouts only; installed builds import anywhere)
            from .._private.config import fw_importable_without_path
            fw_root = os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
            pp = env.get("PYTHONPATH", "")
            if (not fw_importable_without_path()
                    and fw_root not in pp.split(os.pathsep)):
                env["PYTHONPATH"] = (pp + os.pathsep if pp else "") + fw_root
            with open(log_path, "ab") as out:
                proc = subprocess.Popen(
                    entrypoint, shell=True, stdout=out,
                    stderr=subprocess.STDOUT, env=env, cwd=cwd,
                    start_new_session=True)    # own group: stop kills all
            with self._lock:
                self._procs[job_id] = proc
            rec["status"] = JobStatus.RUNNING
            self._write(job_id, rec)
            rc = proc.wait()
        except Exception as e:   # noqa: BLE001 — surfaced via the record
            rec["status"] = JobStatus.FAILED
            rec["message"] = f"supervisor error: {e}"
            rec["end_time"] = time.time()
            self._write(job_id, rec)
            return
        with self._lock:
            # finalize under the lock: a concurrent stop() must not
            # overwrite SUCCEEDED/FAILED with STOPPED (or vice versa)
            self._procs.pop(job_id, None)
            current = self._read(job_id) or rec
            if current["status"] in JobStatus.TERMINAL:
                return                   # stop() already finalized it
            current["return_code"] = rc
            current["status"] = (JobStatus.SUCCEEDED if rc == 0
                                 else JobStatus.FAILED)
            current["end_time"] = time.time()
            self._write(job_id, current)

    def stop(self, job_id: str) -> bool:
        with self._lock:
            rec = self._read(job_id)
            if rec is None or rec["status"] in JobStatus.TERMINAL:
                return False
            proc = self._procs.get(job_id)
            rec["status"] = JobStatus.STOPPED
            rec["end_time"] = time.time()
            self._write(job_id, rec)
        if proc is not None:
            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except (OSError, ProcessLookupError):
                pass
        return True

    def get_status(self, job_id: str) -> Optional[Dict[str, Any]]:
        return self._read(job_id)

    def get_logs(self, job_id: str, tail_bytes: int = 1 << 20) -> str:
        path = os.path.join(self.log_dir, f"{job_id}.log")
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - tail_bytes))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return ""

    def list_jobs(self) -> List[Dict[str, Any]]:
        out = []
        for key in self.gcs.kv_keys(b"job:"):
            raw = self.gcs.kv_get(key)
            if raw:
                out.append(json.loads(raw))
        return sorted(out, key=lambda r: r.get("start_time") or 0)
