"""ray_tpu_torch's runtime against ray_tpu's on the CPU: ids, serialization
bytes, protocol fields, scheduler decisions and one driver program's
results, with the same inputs on both sides; and the port's tensor
serialization."""

import dataclasses
import os
import pickle
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
import torch_runtime_tasks as T
from ray_tpu._private import ids as jids
from ray_tpu._private import protocol as jP
from ray_tpu._private import scheduler as jsched
from ray_tpu._private import serialization as jser
from ray_tpu._private.object_store import ObjectMeta as jObjectMeta
from ray_tpu_torch._private import ids as tids
from ray_tpu_torch._private import protocol as tP
from ray_tpu_torch._private import scheduler as tsched
from ray_tpu_torch._private import serialization as tser
from ray_tpu_torch._private.object_store import ObjectMeta as tObjectMeta

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def port_sanitizers_clean():
    """conftest reports only ray_tpu's sanitizers: hold the port's here."""
    yield
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []


# --- ids --------------------------------------------------------------------

def _seeded_bytes(seed):
    rng = random.Random(seed)
    return lambda n=16: bytes(rng.getrandbits(8) for _ in range(n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_id_derivations_match(seed, monkeypatch):
    monkeypatch.setattr(jids, "_random_bytes", _seeded_bytes(seed))
    monkeypatch.setattr(tids, "_random_bytes", _seeded_bytes(seed))
    out = []
    for mod in (jids, tids):
        job = mod.JobID.from_random()
        task = mod.TaskID.for_job(job)
        owner = mod.WorkerID.from_random()
        out.append([job.binary(), task.binary(),
                    mod.ActorID.from_random().binary(),
                    mod.NodeID.from_random().binary(),
                    mod.PlacementGroupID.from_random().binary(),
                    mod.ObjectID.for_task_return(task, 3).binary(),
                    mod.ObjectID.for_gen_item(task, 70000).binary(),
                    mod.ObjectID.for_put(owner).binary(),
                    mod.ObjectID.nil().binary()])
    assert out[0] == out[1]


# --- serialization ----------------------------------------------------------

_VALUES = [
    42, "text", None, 2.5, (1, "a"), {"k": [1, 2, {"n": None}]},
    np.arange(12, dtype=np.int64).reshape(3, 4),
    {"big": np.linspace(0, 1, 300_000), "small": np.ones(3, np.float32)},
    [np.zeros((0, 5)), np.asfortranarray(np.ones((4, 6)))],
    np.random.default_rng(0).standard_normal((64, 64)).astype(np.float16),
]


@pytest.mark.parametrize("value", _VALUES, ids=range(len(_VALUES)))
def test_serialize_bytes_match(value):
    jmeta, jviews = jser.serialize(value)
    tmeta, tviews = tser.serialize(value)
    assert tmeta == jmeta
    assert [bytes(v) for v in tviews] == [bytes(v) for v in jviews]
    assert tser.to_bytes(value) == jser.to_bytes(value)


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "bf16": torch.randn(4, 6, generator=g).bfloat16(),
        "i64": torch.arange(10, dtype=torch.int64),
        "strided": torch.randn(6, 8, generator=g)[:, ::2].t(),
        "scalar": torch.tensor(1.5),
        "grad": torch.randn(2, 3, generator=g).requires_grad_(),
        "empty": torch.empty(0, 3),
        "bool": torch.tensor([True, False, True]),
        "param": torch.nn.Parameter(torch.ones(4)),
        "nested": {"half": torch.randn(2, 2, generator=g).half()},
    }


def _assert_same_tensors(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_same_tensors(g, w)
            continue
        assert type(g) is type(w), k
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.requires_grad == w.requires_grad, k
        assert g.device.type == "cpu", k
        assert torch.equal(g.detach(), w.detach()), k


def test_tensors_round_trip():
    want = _tensors()
    _assert_same_tensors(tser.from_bytes(tser.to_bytes(want)), want)


def test_tensor_goes_out_of_band():
    t = torch.arange(1 << 20, dtype=torch.float32)          # 4 MB
    meta, views = tser.serialize({"t": t})
    assert len(meta) < 1024
    assert [len(v) for v in views] == [4 << 20]
    assert bytes(views[0]) == t.numpy().tobytes()


def test_restored_tensor_owns_its_bytes():
    blob = bytearray(tser.to_bytes(torch.ones(8)))
    t = tser.read_from(memoryview(blob))
    t += 1
    assert torch.equal(tser.read_from(memoryview(blob)), torch.ones(8))


def _cuda_record(t):
    """The pickle a CUDA tensor leaves in the store, made on the CPU: the
    reduction of `t` with its device tag set to cuda:0."""
    fn, args = tser._reduce_tensor(t)

    class Record:
        def __reduce__(self):
            return fn, args[:4] + ("cuda:0",) + args[5:]

    return Record()


def test_cuda_record_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    data = tser.to_bytes({"w": _cuda_record(torch.ones(4))})
    with pytest.raises(tser.TensorDeviceError, match="cuda:0"):
        tser.from_bytes(data)


def test_serialization_does_not_import_torch():
    code = ("import sys; from ray_tpu_torch._private import serialization "
            "as s; import numpy as np; "
            "s.from_bytes(s.to_bytes({'a': np.ones(3), 'b': [1, 'x']})); "
            "sys.exit(1 if 'torch' in sys.modules else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_main_function_without_cloudpickle_names_the_cause(monkeypatch):
    monkeypatch.setattr(tser, "_function_pickler", pickle)
    main_fn = type(lambda: None)(T.add.__code__, {}, "add")
    main_fn.__module__ = "__main__"
    with pytest.raises(pickle.PicklingError, match="__main__.*cloudpickle"):
        tser.dumps_function(main_fn)
    with pytest.raises(pickle.PicklingError, match="__main__.*cloudpickle"):
        tser.serialize({"f": main_fn})


# --- protocol ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["TaskSpec", "ActorSpec",
                                  "PlacementGroupSpec", "ObjectMeta"])
def test_protocol_fields_match(name):
    jcls = jObjectMeta if name == "ObjectMeta" else getattr(jP, name)
    tcls = tObjectMeta if name == "ObjectMeta" else getattr(tP, name)

    def fields(cls):
        return [(f.name, f.default, f.default_factory)
                for f in dataclasses.fields(cls)]

    assert fields(tcls) == fields(jcls)


def test_protocol_message_codes_match():
    def codes(mod):
        return {k: v for k, v in vars(mod).items()
                if k.isupper() and isinstance(v, (int, bytes, str))}

    assert codes(tP) and codes(tP) == codes(jP)


def test_spec_wire_roundtrip():
    """TaskSpec/ObjectMeta use hand-flattened __reduce__ tuples for wire
    speed; this guards the port's field lists against drifting from the
    dataclass definitions (a copy of tests/test_core_basic.py's guard)."""
    from ray_tpu_torch._private.ids import (ActorID, JobID, NodeID,
                                            ObjectID, TaskID, WorkerID)

    job = JobID.from_random()
    tid = TaskID.for_job(job)
    spec = tP.TaskSpec(
        task_id=tid, job_id=job, name="n", function_id=b"f" * 16,
        args=[("v", 1)], kwargs={"k": ("r", ObjectID.from_random())},
        num_returns=2,
        return_ids=[ObjectID.for_task_return(tid, i) for i in range(2)],
        resources={"CPU": 2.0}, max_retries=3, retry_exceptions=True,
        actor_id=ActorID.from_random(), method_name="m", seq_no=7,
        scheduling_strategy="SPREAD",
        owner_id=WorkerID.from_random().binary(),
        origin_node_id=NodeID.from_random().binary(), namespace="ns",
        runtime_env={"env_vars": {"A": "1"}}, trace_context={"t": 1},
        accel_ids=[0, 1], request_ctx=("r", "/r", "http", 1.0, None))
    for f in dataclasses.fields(tP.TaskSpec):
        assert getattr(spec, f.name) != f.default or f.name == "name", \
            f"give field {f.name!r} a non-default value in this test"
    back = pickle.loads(pickle.dumps(spec, protocol=5))
    for f in dataclasses.fields(tP.TaskSpec):
        assert getattr(back, f.name) == getattr(spec, f.name), f.name

    meta = tObjectMeta(object_id=ObjectID.from_random(), size=9,
                       inline=b"x", shm_name="s", error=b"e",
                       node_hint=b"n" * 16, arena_ref=("/p", 4))
    mback = pickle.loads(pickle.dumps(meta, protocol=5))
    for f in dataclasses.fields(tObjectMeta):
        assert getattr(mback, f.name) == getattr(meta, f.name), f.name


# --- scheduler --------------------------------------------------------------

def _resources(rng, accel):
    res = {"CPU": float(rng.randint(0, 8))}
    if rng.random() < 0.7:
        res[accel] = float(rng.choice([0.5, 1, 2, 4]))
    if rng.random() < 0.3:
        res["mem"] = float(rng.randint(1, 4))
    return res


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_decisions_match(seed):
    """Seeded random resource sets, with "TPU" on the JAX side and "GPU" on
    the port's, give the same fits/subtract/add results, node choices and
    bundle packings."""
    decisions = []
    for sched, ids, accel in ((jsched, jids, "TPU"), (tsched, tids, "GPU")):
        rng = random.Random(seed)
        nodes = []
        for i in range(5):
            total = _resources(rng, accel)
            avail = {k: v - rng.choice([0, 0.5, 1]) * v
                     for k, v in total.items()}
            nodes.append((ids.NodeID(bytes([i]) * 16), total, avail))
        out = []
        for _ in range(40):
            demand = _resources(rng, accel)
            pool = dict(nodes[rng.randrange(5)][2])
            fit = sched.fits(pool, demand)
            sched.subtract(pool, demand)
            after_sub = dict(pool)
            sched.add(pool, demand)
            strategy = rng.choice([sched.DEFAULT, sched.SPREAD])
            pick = sched.pick_node(demand, strategy, nodes,
                                   local_node=nodes[0][0],
                                   rng=random.Random(rng.random()))
            bundles = [_resources(rng, accel) for _ in range(3)]
            packed = sched.pack_bundles(
                bundles, rng.choice(["PACK", "SPREAD", "STRICT_PACK",
                                     "STRICT_SPREAD"]), nodes)
            rename = {accel: "ACCEL"}
            out.append((fit,
                        sorted((rename.get(k, k), v)
                               for k, v in after_sub.items()),
                        pick and pick.binary(),
                        packed and [n.binary() for n in packed]))
        decisions.append(out)
    assert decisions[0] == decisions[1]


# --- one driver program through both runtimes --------------------------------

def _program(rt, name):
    add, echo = rt.remote(T.add), rt.remote(T.echo)
    out = {}
    a = rt.put(10)
    out["ref_args"] = rt.get(add.remote(add.remote(a, 5), rt.put(1)))
    # nested tasks with both CPUs held by parents, then a chain on one
    out["nested"] = rt.get([rt.remote(T.nested_parent).remote(name, i)
                            for i in range(2)], timeout=60)
    out["chain"] = rt.get(rt.remote(T.chain).options(num_cpus=2).remote(
        name, 3), timeout=60)
    counter = rt.remote(T.Counter).options(name="prog_counter").remote(5)
    out["actor"] = (rt.get([counter.incr.remote() for _ in range(3)])
                    + [rt.get(rt.get_actor("prog_counter").read.remote())])
    arr = np.arange(1 << 20, dtype=np.float32)              # 4 MB
    back = rt.get(rt.put(arr))
    out["put_get_4mb"] = (back.dtype.str, back.shape,
                          bool(np.array_equal(back, arr)))
    sleep = rt.remote(T.sleep_then)
    slow, fast = sleep.remote(30, "late"), sleep.remote(0, "early")
    first = rt.wait([slow, fast], num_returns=1, timeout=30)
    timed_out = rt.wait([slow, fast], num_returns=2, timeout=0.5)
    out["wait"] = (first == ([fast], [slow]), rt.get(timed_out[0]),
                   timed_out[1] == [slow])
    rt.cancel(slow, force=True)
    out["multiple_returns"] = rt.get(
        rt.remote(T.three).options(num_returns=3).remote())
    errors = {}
    for key, ref in (("task", rt.remote(T.boom).remote("kapow")),
                     ("dependency", echo.remote(
                         rt.remote(T.boom).remote("root cause")))):
        try:
            rt.get(ref, timeout=30)
        except Exception as exc:   # noqa: BLE001 — the class is the result
            errors[key] = (type(exc).__name__,
                           [c.__name__ for c in type(exc).__mro__])
    try:
        rt.get(sleep.remote(30, "late"), timeout=0.5)
    except Exception as exc:   # noqa: BLE001
        errors["timeout"] = type(exc).__name__
    out["errors"] = errors
    return out


def test_one_program_through_both_runtimes():
    results = {}
    for rt in (ray_tpu, ray_tpu_torch):
        rt.init(num_cpus=2)
        try:
            results[rt.__name__] = _program(rt, rt.__name__)
        finally:
            rt.shutdown()
    want, got = results["ray_tpu"], results["ray_tpu_torch"]
    assert got == want
    assert want["nested"] == [1, 3] and want["chain"] == 3
    assert want["wait"] == (True, ["early"], True)
    assert want["errors"]["task"][0] == "TaskError"
    assert want["errors"]["timeout"] == "GetTimeoutError"


def test_task_routed_away_from_a_node_whose_connection_is_gone():
    """A node the directory still lists alive, but whose connection is gone
    (its death not yet noticed), gets no task: a soft affinity to it runs
    the task elsewhere, a hard one or a placement group's bundle on it
    fails it (ray_tpu fails all three with "target node died before
    dispatch")."""
    from ray_tpu_torch import exceptions
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util import PlacementGroupSchedulingStrategy
    from ray_tpu_torch.util import placement_group
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    ray_tpu_torch.init(address=cluster)
    try:
        far = cluster.add_node(num_cpus=2, resources={"far": 1})
        pg = placement_group([{"CPU": 1, "far": 1}])
        pg.ready(timeout=30)
        head = ray_tpu_torch._global_node
        far_id = far.node_id
        peer = head._peer
        head._peer = lambda nid: None if nid == far_id else peer(nid)
        where = ray_tpu_torch.remote(T.slot_home)
        soft = NodeAffinitySchedulingStrategy(node_id=far_id, soft=True)
        home = ray_tpu_torch.get(where.options(
            scheduling_strategy=soft).remote(ray_tpu_torch.__name__),
            timeout=60)[2]
        assert home == head.node_id.hex()
        hard = NodeAffinitySchedulingStrategy(node_id=far_id, soft=False)
        with pytest.raises(exceptions.WorkerCrashedError,
                           match="died before dispatch"):
            ray_tpu_torch.get(where.options(scheduling_strategy=hard).remote(
                ray_tpu_torch.__name__), timeout=60)
        bundle = PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0)
        with pytest.raises(exceptions.WorkerCrashedError,
                           match="died before dispatch"):
            ray_tpu_torch.get(where.options(
                scheduling_strategy=bundle).remote(ray_tpu_torch.__name__),
                timeout=60)
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
