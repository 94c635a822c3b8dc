# A copy of tests/test_log_streaming.py on ray_tpu_torch's runtime: the same
# tests under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown. Docstrings leave
# out the JAX package's issue history.
"""Worker log streaming to the driver.

Reference: ``python/ray/_private/log_monitor.py:103`` — worker
stdout/stderr is tailed per node and surfaced on the driver.
"""

import sys
import time

import ray_tpu_torch
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


def _wait_for(capsys, needle: str, timeout: float = 20.0) -> str:
    deadline = time.monotonic() + timeout
    seen = ""
    while time.monotonic() < deadline:
        seen += capsys.readouterr().out
        if needle in seen:
            return seen
        time.sleep(0.2)
    raise AssertionError(f"{needle!r} never reached the driver; saw:\n{seen}")


def test_remote_print_reaches_driver(rtpu_init, capsys):
    @ray_tpu_torch.remote
    def chatty():
        print("hello-from-rtpu-task")
        sys.stderr.write("stderr-from-rtpu-task\n")
        return 1

    assert ray_tpu_torch.get(chatty.remote(), timeout=60) == 1
    out = _wait_for(capsys, "hello-from-rtpu-task")
    # stderr is merged into the worker log stream too (may land in the
    # same batch the first wait already consumed)
    if "stderr-from-rtpu-task" not in out:
        out += _wait_for(capsys, "stderr-from-rtpu-task")
    # lines carry a worker/node prefix for attribution
    line = next(ln for ln in out.splitlines()
                if "hello-from-rtpu-task" in ln)
    assert line.startswith("(worker ")


def test_actor_print_reaches_driver(rtpu_init, capsys):
    @ray_tpu_torch.remote
    class A:
        def speak(self):
            print("actor-says-moo")
            return "ok"

    a = A.remote()
    assert ray_tpu_torch.get(a.speak.remote(), timeout=60) == "ok"
    _wait_for(capsys, "actor-says-moo")


def test_serve_replica_log_attribution(rtpu_init, capsys):
    """Lines printed inside a serve replica carry the deployment name
    (deployment#tag) in the ``(worker ...)`` prefix instead of a bare
    worker id, so driver output / `rtpu logs` is greppable by
    deployment."""
    from ray_tpu_torch import serve

    @serve.deployment
    def chatty_dep(x):
        print("hello-from-serve-replica")
        return x

    try:
        handle = serve.run(chatty_dep.bind())
        assert handle.remote(1).result(timeout=60) == 1
        out = _wait_for(capsys, "hello-from-serve-replica")
        line = next(ln for ln in out.splitlines()
                    if "hello-from-serve-replica" in ln)
        assert line.startswith("(worker chatty_dep#0 "), line
    finally:
        serve.shutdown()


def test_multinode_logs_reach_driver(rtpu_cluster, capsys):
    cluster = rtpu_cluster
    cluster.add_node(num_cpus=2, resources={"side": 2.0})

    @ray_tpu_torch.remote(resources={"side": 1.0})
    def far_away():
        print("printed-on-the-other-node")
        return True

    assert ray_tpu_torch.get(far_away.remote(), timeout=60)
    _wait_for(capsys, "printed-on-the-other-node")
