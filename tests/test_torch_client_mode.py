"""Ray-Client-equivalent attach on ray_tpu_torch (copies of
tests/test_client_mode.py): a driver on a DIFFERENT host (no shared
/dev/shm) drives the cluster with object payloads riding the socket.

Reference analogue: ``python/ray/util/client/`` (Ray Client proxies
get/put over gRPC). The fake "other host" is induced with
``RTPU_NODE_HOST``, the same override the object plane uses to simulate
cross-host nodes in tests.
"""

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import context
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture
def remote_driver_cluster():
    cluster = Cluster(initialize_head=True, process_isolated=True,
                      head_node_args={"num_cpus": 2})
    os.environ["RTPU_NODE_HOST"] = "fake-client-host"
    ray_tpu_torch.init(address=cluster)
    yield cluster
    os.environ.pop("RTPU_NODE_HOST", None)
    ray_tpu_torch.shutdown()
    cluster.shutdown()
    _check_sanitizers()


def _check_sanitizers():
    # conftest reports only ray_tpu's sanitizers: hold the port's here
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []


@ray_tpu_torch.remote
def _double(arr):
    return arr * 2


@ray_tpu_torch.remote
class _Acc:
    def __init__(self):
        self.n = 0

    def add(self, k):
        self.n += k
        return self.n


def test_wire_mode_detected(remote_driver_cluster):
    assert context.current_client.wire_data_plane is True


def test_put_get_large_over_wire(remote_driver_cluster):
    arr = np.arange(500_000, dtype=np.float32)      # ~2MB, > inline cap
    ref = ray_tpu_torch.put(arr)
    out = ray_tpu_torch.get(ref, timeout=60)
    np.testing.assert_array_equal(arr, out)


def test_task_large_arg_and_return(remote_driver_cluster):
    arr = np.ones(400_000, dtype=np.float32)
    out = ray_tpu_torch.get(_double.remote(arr), timeout=60)
    np.testing.assert_array_equal(out, arr * 2)


def test_task_ref_arg_over_wire(remote_driver_cluster):
    ref = ray_tpu_torch.put(np.full(300_000, 3.0, dtype=np.float32))
    out = ray_tpu_torch.get(_double.remote(ref), timeout=60)
    assert float(out[0]) == 6.0


def test_actor_over_wire(remote_driver_cluster):
    acc = _Acc.remote()
    assert ray_tpu_torch.get(acc.add.remote(5), timeout=60) == 5
    assert ray_tpu_torch.get(acc.add.remote(7), timeout=60) == 12


def test_same_host_attach_keeps_shm_plane():
    cluster = Cluster(initialize_head=True, process_isolated=True,
                      head_node_args={"num_cpus": 2})
    try:
        ray_tpu_torch.init(address=cluster)
        assert context.current_client.wire_data_plane is False
        arr = np.arange(300_000, dtype=np.float32)
        np.testing.assert_array_equal(
            ray_tpu_torch.get(ray_tpu_torch.put(arr), timeout=60), arr)
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
    _check_sanitizers()
