"""Fixtures for the copies of the JAX package's runtime tests on
ray_tpu_torch's runtime (tests/test_torch_<original stem>.py).

`rtpu_init` and `rtpu_cluster` are conftest.py's fixtures of the same
names, on the port's runtime: a copy imports them, and a fixture a test
module defines or imports overrides conftest's. `port_sanitizers` is
module-scoped and autouse: conftest's session report reads only
`ray_tpu`'s locksan and fieldsan, so each copy holds the port's to no
violation when its last test ends.
"""

import pytest

import ray_tpu_torch


@pytest.fixture
def rtpu_init():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def rtpu_cluster():
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2})
    ray_tpu_torch.init(address=cluster)
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()


@pytest.fixture(scope="module", autouse=True)
def port_sanitizers():
    yield
    from ray_tpu_torch._private import fieldsan, locksan
    for san in (locksan, fieldsan):
        found = san.violations()
        assert not found, found
