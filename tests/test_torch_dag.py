# A copy of tests/test_dag.py on ray_tpu_torch's runtime: the same tests under
# the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU slots) and
# the fixtures of torch_runtime_fixtures.py, which also hold the port's locksan
# and fieldsan to no violation at teardown.
"""DAG API tests (reference analogue: ``python/ray/dag/tests/``)."""

import pytest

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


@ray_tpu_torch.remote
def add(a, b):
    return a + b


@ray_tpu_torch.remote
def double(x):
    return 2 * x


@ray_tpu_torch.remote
def bump_file(path, x):
    with open(path, "a") as f:
        f.write("x\n")
    return x + 1


def test_simple_chain(rtpu_init):
    dag = double.bind(add.bind(2, 3))
    assert ray_tpu_torch.get(dag.execute()) == 10


def test_input_node(rtpu_init):
    with InputNode() as inp:
        dag = add.bind(inp, 10)
    assert ray_tpu_torch.get(dag.execute(5)) == 15
    # the same DAG re-executes with new input
    assert ray_tpu_torch.get(dag.execute(7)) == 17


def test_input_item_access(rtpu_init):
    with InputNode() as inp:
        dag = add.bind(inp["a"], inp["b"])
    assert ray_tpu_torch.get(dag.execute({"a": 3, "b": 4})) == 7


def test_diamond_submits_shared_node_once(rtpu_init, tmp_path):
    marker = str(tmp_path / "count.txt")
    shared = bump_file.bind(marker, 1)
    dag = add.bind(double.bind(shared), double.bind(shared))
    assert ray_tpu_torch.get(dag.execute()) == 8          # 2*(1+1) + 2*(1+1)
    with open(marker) as f:
        assert len(f.read().splitlines()) == 1      # memoized per execute


def test_multi_output(rtpu_init):
    dag = MultiOutputNode([add.bind(1, 2), double.bind(5)])
    refs = dag.execute()
    assert ray_tpu_torch.get(refs) == [3, 10]


def test_actor_dag_shares_instance(rtpu_init):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def incr(self, k):
            self.n += k
            return self.n

    node = Counter.bind(100)
    first = node.incr.bind(1)
    second = node.incr.bind(first)       # chained on the SAME instance
    out = ray_tpu_torch.get(second.execute())
    assert out == 100 + 1 + 101          # 101 then 101+101=202
    # a fresh execute creates a fresh actor (no state bleed)
    assert ray_tpu_torch.get(second.execute()) == 202


def test_live_handle_method_bind(rtpu_init):
    @ray_tpu_torch.remote
    class Acc:
        def __init__(self):
            self.n = 0

        def addv(self, k):
            self.n += k
            return self.n

    acc = Acc.remote()
    dag = acc.addv.bind(add.bind(1, 2))
    assert ray_tpu_torch.get(dag.execute()) == 3
    assert ray_tpu_torch.get(dag.execute()) == 6   # live handle keeps state


def test_execute_without_input_raises(rtpu_init):
    with InputNode() as inp:
        dag = double.bind(inp)
    with pytest.raises(ValueError):
        dag.execute()


def test_execute_with_kwargs(rtpu_init):
    with InputNode() as inp:
        dag = add.bind(inp.a, inp.b)
    assert ray_tpu_torch.get(dag.execute(a=3, b=9)) == 12
    # mixed positional + keyword
    with InputNode() as inp:
        dag2 = add.bind(inp[0], inp.k)
    assert ray_tpu_torch.get(dag2.execute(5, k=6)) == 11
