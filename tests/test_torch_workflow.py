"""Workflow (durable DAG) tests aimed at ray_tpu_torch.workflow (copies of
tests/test_workflow.py; reference analogue:
``python/ray/workflow/tests/test_basic_workflows*.py`` — checkpointing,
failure resume, idempotent re-run), and torch tensors as workflow inputs.

The module-level steps go to the workers by name: this module imports
neither torch nor JAX at its top, so a worker that imports it stays light."""

import os

import pytest

import ray_tpu_torch
from ray_tpu_torch import workflow
from ray_tpu_torch.dag import InputNode


def _check_sanitizers():
    # conftest reports only ray_tpu's sanitizers: hold the port's here
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []


@pytest.fixture
def rtpu_init():
    """The port's runtime per test, as conftest's is ray_tpu's."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    _check_sanitizers()


@pytest.fixture
def wf_storage(tmp_path):
    workflow.init(str(tmp_path / "wf"))
    yield str(tmp_path / "wf")
    workflow.init(None)


@ray_tpu_torch.remote
def traced_add(path, tag, a, b):
    with open(path, "a") as f:
        f.write(tag + "\n")
    return a + b


@ray_tpu_torch.remote
def fail_once(path, x):
    attempts_file = path + ".attempts"
    with open(attempts_file, "a") as f:
        f.write("a\n")
    with open(attempts_file) as f:
        if len(f.read().splitlines()) == 1:
            raise RuntimeError("transient step failure")
    return x * 10


def _trace(path):
    try:
        with open(path) as f:
            return f.read().splitlines()
    except OSError:
        return []


def test_run_and_idempotent_rerun(rtpu_init, wf_storage, tmp_path):
    marker = str(tmp_path / "trace.txt")
    dag = traced_add.bind(marker, "outer", 1,
                          traced_add.bind(marker, "inner", 2, 3))
    out = workflow.run(dag, workflow_id="wf1")
    assert out == 6
    assert sorted(_trace(marker)) == ["inner", "outer"]
    assert workflow.get_status("wf1") == workflow.SUCCESSFUL
    assert workflow.get_output("wf1") == 6

    # re-running the same workflow id recomputes NOTHING
    assert workflow.run(dag, workflow_id="wf1") == 6
    assert sorted(_trace(marker)) == ["inner", "outer"]


def test_failure_then_resume_skips_done_steps(rtpu_init, wf_storage,
                                              tmp_path):
    marker = str(tmp_path / "trace.txt")
    step1 = traced_add.bind(marker, "step1", 10, 20)
    dag = fail_once.options(max_retries=0).bind(marker, step1)

    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="wf-fail")
    assert workflow.get_status("wf-fail") == workflow.FAILED
    assert _trace(marker) == ["step1"]           # step1 checkpointed

    out = workflow.resume("wf-fail")
    assert out == 300
    # step1 was NOT re-executed on resume
    assert _trace(marker) == ["step1"]
    assert workflow.get_status("wf-fail") == workflow.SUCCESSFUL


def test_workflow_with_input(rtpu_init, wf_storage, tmp_path):
    marker = str(tmp_path / "trace.txt")
    with InputNode() as inp:
        dag = traced_add.bind(marker, "t", inp, 5)
    assert workflow.run(dag, 37, workflow_id="wf-in") == 42


def test_run_async_and_list(rtpu_init, wf_storage, tmp_path):
    marker = str(tmp_path / "trace.txt")
    dag = traced_add.bind(marker, "a", 4, 4)
    fut = workflow.run_async(dag, workflow_id="wf-async")
    assert fut.result(timeout=60) == 8
    ids = dict(workflow.list_all())
    assert ids.get("wf-async") == workflow.SUCCESSFUL

    workflow.delete("wf-async")
    assert "wf-async" not in dict(workflow.list_all())


def test_actor_nodes_rejected(rtpu_init, wf_storage):
    @ray_tpu_torch.remote
    class A:
        def f(self):
            return 1

    node = A.bind()
    with pytest.raises(ValueError):
        workflow.run(node.f.bind(), workflow_id="wf-actor")


def test_parallel_branches_both_checkpoint(rtpu_init, wf_storage, tmp_path):
    marker = str(tmp_path / "trace.txt")
    left = traced_add.bind(marker, "left", 1, 2)
    right = traced_add.bind(marker, "right", 3, 4)
    dag = traced_add.bind(marker, "join", left, right)
    assert workflow.run(dag, workflow_id="wf-par") == 10
    assert sorted(_trace(marker)) == ["join", "left", "right"]


def test_live_actor_method_rejected(rtpu_init, wf_storage):
    @ray_tpu_torch.remote
    class Acc:
        def addv(self, k):
            return k

    acc = Acc.remote()
    with pytest.raises(ValueError):
        workflow.run(acc.addv.bind(5), workflow_id="wf-live-actor")


def test_different_dag_same_id_rejected(rtpu_init, wf_storage, tmp_path):
    marker = str(tmp_path / "trace.txt")
    workflow.run(traced_add.bind(marker, "a", 1, 2), workflow_id="wf-id")
    with pytest.raises(ValueError):
        workflow.run(traced_add.bind(marker, "b", 9, 9),
                     workflow_id="wf-id")


def test_workflow_kwargs_input(rtpu_init, wf_storage, tmp_path):
    marker = str(tmp_path / "trace.txt")
    with InputNode() as inp:
        dag = traced_add.bind(marker, "t", inp.x, inp.y)
    assert workflow.run(dag, x=20, y=22, workflow_id="wf-kw") == 42


def _fingerprint_in_a_fresh_process(code):
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(root)
    prog = ("import json, torch, ray_tpu_torch as rt\n"
            "from ray_tpu_torch import workflow as wf\n"
            "def step(a, b):\n"
            "    return a\n"
            "f = rt.remote(step)\n"
            + code +
            "print(json.dumps(wf._plan_fingerprint(dag, args, {})))\n")
    proc = subprocess.run([sys.executable, "-c", prog], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def test_tensor_fingerprint_is_the_same_in_two_processes():
    """Equal CPU tensors (f32, bf16, strided; bound and as the workflow's
    input) give the same plan fingerprint in two fresh processes, so a
    resumed or re-run workflow of tensors is recognised. torch's own
    pickle of a tensor differs between processes (it embeds the storage's
    address); ray_tpu's jax.Array pickles stably, so the port hashes a
    tensor's bytes as it does an array's."""
    code = ("x = torch.arange(12, dtype=torch.float32).reshape(3, 4)\n"
            "dag = f.bind(x.t(), torch.ones(5, dtype=torch.bfloat16))\n"
            "args = (torch.full((2, 2), 0.5),)\n")
    first = _fingerprint_in_a_fresh_process(code)
    assert _fingerprint_in_a_fresh_process(code) == first
    other = _fingerprint_in_a_fresh_process(
        code.replace("torch.full((2, 2), 0.5)", "torch.full((2, 2), 0.25)"))
    assert other != first


def test_rerun_with_an_equal_tensor_input_reads_its_checkpoints(
        rtpu_init, wf_storage, tmp_path):
    """A re-run of a workflow whose input is a torch tensor, given an equal
    tensor (a new object), returns the stored output and runs no step; a
    different tensor is refused."""
    import torch

    marker = str(tmp_path / "trace.txt")
    with InputNode() as inp:
        dag = traced_add.bind(marker, "t", inp, 1)
    out = workflow.run(dag, torch.arange(4.0), workflow_id="wf-tensor")
    assert torch.equal(out, torch.arange(4.0) + 1)
    again = workflow.run(dag, torch.arange(4.0), workflow_id="wf-tensor")
    assert torch.equal(again, out)
    assert _trace(marker) == ["t"]
    with pytest.raises(ValueError):
        workflow.run(dag, torch.arange(4.0) * 2, workflow_id="wf-tensor")
