"""Job submission on ray_tpu_torch (copies of
tests/test_job_submission.py): scripts submitted from outside the cluster
process.

Reference analogues: ``dashboard/modules/job/job_manager.py:525`` +
``sdk.py`` JobSubmissionClient; tests modeled on
``python/ray/dashboard/modules/job/tests/test_job_manager.py``.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.job import JobStatus, JobSubmissionClient


@pytest.fixture(scope="module")
def job_cluster():
    cluster = Cluster(initialize_head=True, process_isolated=True,
                      head_node_args={"num_cpus": 4})
    client = JobSubmissionClient(f"127.0.0.1:{cluster.head.job_port}")
    yield cluster, client
    cluster.shutdown()
    # conftest reports only ray_tpu's sanitizers: hold the port's here
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []


SCRIPT_OK = """
import os
import ray_tpu_torch
ray_tpu_torch.init(address=os.environ["RTPU_ADDRESS"])

@ray_tpu_torch.remote
def sq(x):
    return x * x

print("job-sum:", sum(ray_tpu_torch.get([sq.remote(i) for i in range(10)])))
ray_tpu_torch.shutdown()
"""


def test_submit_script_runs_against_cluster(job_cluster, tmp_path):
    cluster, client = job_cluster
    script = tmp_path / "job_ok.py"
    script.write_text(SCRIPT_OK)
    job_id = client.submit_job(
        entrypoint=f"python {script}",
        metadata={"who": "test"})
    rec = client.wait_until_finished(job_id, timeout=120)
    logs = client.get_job_logs(job_id)
    assert rec["status"] == JobStatus.SUCCEEDED, logs
    assert rec["return_code"] == 0
    assert "job-sum: 285" in logs
    assert rec["metadata"] == {"who": "test"}


def test_failing_job_reports_failed(job_cluster, tmp_path):
    cluster, client = job_cluster
    script = tmp_path / "job_bad.py"
    script.write_text("raise SystemExit('kaboom')\n")
    job_id = client.submit_job(entrypoint=f"python {script}")
    rec = client.wait_until_finished(job_id, timeout=60)
    assert rec["status"] == JobStatus.FAILED
    assert rec["return_code"] != 0
    assert "kaboom" in client.get_job_logs(job_id)


def test_stop_job(job_cluster, tmp_path):
    cluster, client = job_cluster
    script = tmp_path / "job_sleep.py"
    script.write_text("import time\nprint('sleeping')\ntime.sleep(600)\n")
    job_id = client.submit_job(entrypoint=f"python {script}")
    deadline = time.monotonic() + 30
    while client.get_job_status(job_id)["status"] == JobStatus.PENDING:
        assert time.monotonic() < deadline
        time.sleep(0.2)
    assert client.stop_job(job_id)
    rec = client.wait_until_finished(job_id, timeout=30)
    assert rec["status"] == JobStatus.STOPPED


def test_working_dir_and_listing(job_cluster, tmp_path):
    cluster, client = job_cluster
    wd = tmp_path / "jobwd"
    wd.mkdir()
    (wd / "helper_mod.py").write_text("ANSWER = 41\n")
    (wd / "main.py").write_text(
        "import helper_mod\nprint('answer:', helper_mod.ANSWER + 1)\n")
    job_id = client.submit_job(
        entrypoint="python main.py",
        runtime_env={"working_dir": str(wd)},
        submission_id="wd-job")
    rec = client.wait_until_finished(job_id, timeout=60)
    assert rec["status"] == JobStatus.SUCCEEDED
    assert "answer: 42" in client.get_job_logs("wd-job")
    assert any(j["job_id"] == "wd-job" for j in client.list_jobs())


def test_cli_submit_and_status(job_cluster, tmp_path, capsys):
    cluster, client = job_cluster
    script = tmp_path / "cli_job.py"
    script.write_text("print('from-the-cli-job')\n")
    from ray_tpu_torch.scripts import cli
    cli.main(["submit", "--address", cluster.gcs_address,
              "--", "python", str(script)])
    out = capsys.readouterr().out
    assert "from-the-cli-job" in out
    assert "SUCCEEDED" in out
