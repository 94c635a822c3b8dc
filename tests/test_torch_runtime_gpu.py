"""ray_tpu_torch's runtime and the GPU: exclusive "GPU" slots and the
CUDA_VISIBLE_DEVICES each worker sees (no card is needed: the slots are a
resource of the node), pooled workers that keep their role, the light
worker process, and the device telemetry on the card."""

import pytest
import torch

import ray_tpu_torch as rt
import torch_runtime_tasks as T
from ray_tpu_torch import exceptions

NAME = rt.__name__


@pytest.fixture(scope="module", autouse=True)
def port_sanitizers_clean():
    """conftest reports only ray_tpu's sanitizers: hold the port's here."""
    yield
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []


@pytest.fixture
def runtime(request):
    rt.init(**request.param)
    yield
    rt.shutdown()


@pytest.mark.parametrize("runtime", [{"num_cpus": 4, "num_gpus": 2}],
                         indirect=True)
def test_gpu_slot_assignment(runtime):
    """Whole-card demands get exclusive per-instance slot ids, and the
    task's CUDA_VISIBLE_DEVICES names them (a port of
    test_core_basic.py's test_accelerator_slot_assignment)."""
    assert rt.cluster_resources() == {"CPU": 4.0, "GPU": 2.0}
    # two holders at once get disjoint slots (actors hold theirs for their
    # lifetime; two tasks may also run one after the other on slot 0's
    # warm worker, where ray_tpu's pool would hand the second any worker)
    holders = [rt.remote(T.Slots).options(num_gpus=1).remote()
               for _ in range(2)]
    held = rt.get([h.ids.remote(NAME) for h in holders], timeout=60)
    assert sorted(ids["GPU"][0] for ids, _ in held) == [0, 1]
    for ids, visible in held:
        assert visible == str(ids["GPU"][0])
    for h in holders:
        rt.kill(h)

    one = rt.remote(T.slots).options(num_gpus=1)

    # slots recycle once released
    ids, visible = rt.get(one.remote(NAME), timeout=60)
    assert ids["GPU"] in ([0], [1]) and visible == str(ids["GPU"][0])

    # a two-card task owns both, and sees both
    both = rt.get(rt.remote(T.slots).options(num_gpus=2).remote(NAME),
                  timeout=60)
    assert sorted(both[0]["GPU"]) == [0, 1]
    assert sorted(both[1].split(",")) == ["0", "1"]

    # actors hold their slots for their lifetime
    holder = rt.remote(T.Slots).options(num_gpus=1).remote()
    held, held_visible = rt.get(holder.ids.remote(NAME), timeout=60)
    assert held["GPU"] in ([0], [1]) and held_visible == str(held["GPU"][0])
    # with one card held, a 1-card task gets the other id
    other, _ = rt.get(one.remote(NAME), timeout=60)
    assert other != held and other["GPU"] in ([0], [1])

    # no slots: no card
    assert rt.get(rt.remote(T.slots).remote(NAME), timeout=60) == (
        {"GPU": []}, "")
    # driver context: no slots
    assert rt.get_runtime_context().get_accelerator_ids() == {"GPU": []}

    # fractional GPU demands are capacity-only (no slot, no card), and
    # more than one card must be whole
    frac = rt.get(rt.remote(T.slots).options(num_gpus=0.5).remote(NAME),
                  timeout=60)
    assert frac == ({"GPU": []}, "")
    with pytest.raises(ValueError):
        rt.remote(T.slots).options(num_gpus=1.5).remote(NAME)


@pytest.mark.parametrize("runtime", [{"num_cpus": 1, "num_gpus": 1}],
                         indirect=True)
def test_pooled_worker_keeps_its_role(runtime):
    """Torch reads CUDA_VISIBLE_DEVICES once, at CUDA's first use: a worker
    that touched torch.cuda without a slot never serves a GPU task, and a
    GPU worker never serves a slot-less one, even on one CPU."""
    probe = rt.remote(T.cuda_probe)
    available, visible, cpu_pid = rt.get(probe.remote(), timeout=60)
    assert (available, visible) == (False, "")

    ids, visible = rt.get(rt.remote(T.slots).options(num_gpus=1).remote(
        NAME), timeout=60)
    assert ids == {"GPU": [0]} and visible == "0"
    _, visible, gpu_pid = rt.get(probe.options(num_gpus=1).remote(),
                                 timeout=60)
    assert visible == "0" and gpu_pid != cpu_pid

    _, visible, pid = rt.get(probe.remote(), timeout=60)
    assert visible == "" and pid != gpu_pid


@pytest.mark.parametrize("runtime", [{"num_cpus": 1}], indirect=True)
def test_tensor_free_worker_stays_light(runtime):
    """A worker that ran only tensor-free tasks (from a module that imports
    neither torch nor jax) has imported neither."""
    add = rt.remote(T.add)
    assert rt.get(add.remote(rt.put(1), add.remote(2, 3))) == 6
    import numpy as np
    big = rt.put(np.ones(1 << 18))
    assert rt.get(rt.remote(T.echo).remote(big)).sum() == 1 << 18
    assert rt.get(rt.remote(T.heavy_modules).remote(), timeout=60) == []


@pytest.mark.parametrize("runtime", [{"num_cpus": 2, "num_tpus": 1}],
                         indirect=True)
def test_num_tpus_means_gpus(runtime):
    assert rt.cluster_resources()["GPU"] == 1.0
    ids, visible = rt.get(rt.remote(T.slots).options(num_tpus=1).remote(
        NAME), timeout=60)
    assert ids == {"GPU": [0]} and visible == "0"


def test_cluster_add_node_num_gpus():
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(head_node_args={"num_cpus": 1})
    try:
        cluster.add_node(num_cpus=1, num_gpus=2)
        rt.init(address=cluster)
        try:
            assert rt.cluster_resources() == {"CPU": 2.0, "GPU": 2.0}
            ids, visible = rt.get(
                rt.remote(T.slots).options(num_gpus=2).remote(NAME),
                timeout=60)
            assert sorted(ids["GPU"]) == [0, 1] and visible in ("0,1", "1,0")
        finally:
            rt.shutdown()
    finally:
        cluster.shutdown()


def _node_env(**extra):
    """A node process's environment: the task bodies' module on its path
    (its workers import it by name), and `extra`."""
    import os

    tests = os.path.dirname(os.path.abspath(__file__))
    pp = os.environ.get("PYTHONPATH", "")
    return {"PYTHONPATH": tests + (os.pathsep + pp if pp else ""), **extra}


def _node_gpus():
    return {n["node_id"].hex(): n["resources"].get("GPU")
            for n in rt.nodes() if n["alive"]}


def _loaded_libraries(pid):
    with open(f"/proc/{pid}/maps") as f:
        return f.read()


def test_process_isolated_gpu_node_maps_its_slot():
    """A node process started with one GPU slot and
    CUDA_VISIBLE_DEVICES=3 takes a num_gpus=1 task from a driver attached
    to a head that has no GPU: the task runs on that node and sees device
    3. Neither node process loads torch or the CUDA driver."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(process_isolated=True,
                      head_node_args={"num_cpus": 1, "env": _node_env()})
    try:
        gpu_node = cluster.add_node(
            num_cpus=1, num_gpus=1,
            env=_node_env(CUDA_VISIBLE_DEVICES="3"))
        rt.init(address=cluster)
        try:
            assert _node_gpus() == {cluster.head.node_id_hex: None,
                                    gpu_node.node_id_hex: 1.0}
            ids, visible, home, torch_loaded = rt.get(
                rt.remote(T.slot_home).options(num_gpus=1).remote(NAME),
                timeout=60)
            assert ids == {"GPU": [0]} and visible == "3"
            assert home == gpu_node.node_id_hex and not torch_loaded
        finally:
            rt.shutdown()
        for node in cluster.nodes:
            maps = _loaded_libraries(node.pid)
            assert "libtorch" not in maps and "libcuda" not in maps
    finally:
        cluster.shutdown()


def test_process_isolated_node_maps_slot_i_to_the_ith_visible_device():
    """CUDA_VISIBLE_DEVICES set to a subset: slot i is the subset's i-th
    device, as for an in-process node."""
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(process_isolated=True,
                      head_node_args={
                          "num_cpus": 2, "num_gpus": 2,
                          "env": _node_env(CUDA_VISIBLE_DEVICES="5,2")})
    try:
        rt.init(address=cluster)
        try:
            holders = [rt.remote(T.Slots).options(num_gpus=1).remote()
                       for _ in range(2)]
            held = rt.get([h.ids.remote(NAME) for h in holders], timeout=60)
            assert sorted((ids["GPU"][0], visible) for ids, visible in held) \
                == [(0, "5"), (1, "2")]
        finally:
            rt.shutdown()
    finally:
        cluster.shutdown()


def test_node_main_without_num_gpus_counts_the_visible_cards(tmp_path):
    """A node started without --num-gpus counts the cards its process
    sees, without torch: none on a host without an NVIDIA driver."""
    import json
    import os
    import subprocess
    import sys
    import time

    from ray_tpu_torch._private import gpus

    if gpus._physical_gpu_count():
        pytest.skip("this checks a host without NVIDIA devices")
    ready = tmp_path / "ready.json"
    env = {k: v for k, v in os.environ.items()
           if k != "CUDA_VISIBLE_DEVICES"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.main", "--head",
         "--num-cpus", "1", "--dashboard-port", "-1",
         "--session-dir", str(tmp_path / "node"),
         "--ready-file", str(ready)], env=env,
        stdout=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 30
        while not ready.exists():
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        port = json.loads(ready.read_text())["gcs_port"]
        rt.init(address=f"127.0.0.1:{port}")
        try:
            assert rt.cluster_resources() == {"CPU": 1.0}
        finally:
            rt.shutdown()
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_visible_gpu_count_reads_cuda_visible_devices():
    """CUDA_VISIBLE_DEVICES read as CUDA reads it: unset is every device,
    empty none, and the list stops at its first entry that names no
    device."""
    from ray_tpu_torch._private.gpus import visible_gpu_count

    assert visible_gpu_count(None, physical=4) == 4
    assert visible_gpu_count("", physical=4) == 0
    assert visible_gpu_count("0,1", physical=4) == 2
    assert visible_gpu_count("3", physical=4) == 1
    assert visible_gpu_count("3", physical=2) == 0
    assert visible_gpu_count("1,7,0", physical=4) == 1
    assert visible_gpu_count("1,1", physical=4) == 1
    assert visible_gpu_count("GPU-8a1c,0", physical=2) == 2
    assert visible_gpu_count("0,x", physical=2) == 1
    assert visible_gpu_count("0", physical=0) == 0


@pytest.mark.cuda
def test_sample_devices_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from ray_tpu_torch._private import telemetry

    x = torch.ones(1 << 20, device="cuda")
    assert telemetry.sample_devices() == torch.cuda.device_count()
    gauges = telemetry.snapshot_local()["gauges"]
    tags = (("device", "cuda:0"),)
    used = gauges[(telemetry.M_HBM_USED, tags)][0]
    limit = gauges[(telemetry.M_HBM_LIMIT, tags)][0]
    assert x.numel() * 4 <= used <= limit


def test_sample_devices_without_cuda_initialised():
    """Sampling never initialises CUDA (nor raises) where torch has not."""
    from ray_tpu_torch._private import telemetry

    if torch.cuda.is_initialized():
        pytest.skip("CUDA is initialised in this process")
    assert telemetry.sample_devices() == 0
    assert not torch.cuda.is_initialized()


def test_cuda_tensor_record_fails_a_task_without_a_card():
    """A CUDA tensor sent to a task without a slot fails that task with
    the named error; it never lands on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    from test_torch_runtime import _cuda_record

    rt.init(num_cpus=1)
    try:
        ref = rt.put({"w": _cuda_record(torch.ones(4))})
        with pytest.raises(exceptions.RayTpuError, match="cuda:0"):
            rt.get(rt.remote(T.echo).remote(ref), timeout=60)
    finally:
        rt.shutdown()


@pytest.mark.parametrize("runtime", [{"num_cpus": 4, "num_gpus": 1}],
                         indirect=True)
def test_whole_card_waits_for_a_killed_actors_slot(runtime):
    """A placement group removed right after its actor is killed gives its
    GPU back at once, the actor's slot only when its death is processed: a
    new gang's whole-card actor waits for the slot instead of running with
    none (CUDA_VISIBLE_DEVICES "", no card), as TorchTrainer's restart
    would have it."""
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy)

    holder = rt.remote(T.Slots)
    for _ in range(3):
        pg = placement_group([{"CPU": 1, "GPU": 1}])
        pg.ready(timeout=30)
        strategy = PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0)
        actor = holder.options(num_gpus=1,
                               scheduling_strategy=strategy).remote()
        assert rt.get(actor.ids.remote(NAME), timeout=60) == ({"GPU": [0]},
                                                              "0")
        rt.kill(actor)
        remove_placement_group(pg)


@pytest.mark.parametrize("runtime", [{"num_cpus": 4, "num_gpus": 1}],
                         indirect=True)
def test_killed_pending_actor_never_starts(runtime):
    """An actor killed while it waits for a card stays dead when the card
    frees: its queued creation goes with it. (Left queued, it came up
    and held the slot, so a redeployed serve replica waited forever;
    ray_tpu keeps that fault.)"""
    import time

    holder = rt.remote(T.Slots).options(num_gpus=1)
    first = holder.remote()
    assert rt.get(first.ids.remote(NAME), timeout=60) == ({"GPU": [0]}, "0")
    pending = holder.remote()
    from ray_tpu_torch import state

    def state_of(actor):
        return {row["actor_id"]: row["state"]
                for row in state.list_actors()}.get(actor.actor_id.hex())

    deadline = time.monotonic() + 20
    while (state_of(pending) != "PENDING_CREATION"
           and time.monotonic() < deadline):
        time.sleep(0.1)
    assert state_of(pending) == "PENDING_CREATION"
    rt.kill(pending)
    rt.kill(first)
    deadline = time.monotonic() + 20
    while (rt.available_resources().get("GPU", 0) != 1
           and time.monotonic() < deadline):
        time.sleep(0.1)
    time.sleep(1.0)              # a revived creation would take it by now
    assert rt.available_resources().get("GPU", 0) == 1
    assert state_of(pending) == "DEAD"
    with pytest.raises(exceptions.ActorDiedError):
        rt.get(pending.ids.remote(NAME), timeout=30)
    # the slot serves the next holder
    third = holder.remote()
    assert rt.get(third.ids.remote(NAME), timeout=60) == ({"GPU": [0]}, "0")


@pytest.mark.parametrize("runtime", [{"num_cpus": 2, "num_gpus": 1}],
                         indirect=True)
def test_tasks_of_one_slot_share_one_worker(runtime):
    """One live worker serves a slot: GPU tasks between bursts of slot-less
    tasks all run in it. A second worker bound to the same slot would
    import torch and make a CUDA context of its own on the card, and the
    idle pool, which hands tasks out oldest first, would alternate them."""
    probe = rt.remote(T.cuda_probe).options(num_gpus=1)
    pids = []
    for _ in range(4):
        pids.append(rt.get(probe.remote(), timeout=60)[2])
        rt.get([rt.remote(T.sleep_then).remote(0.2, i) for i in range(3)],
               timeout=60)
    assert len(set(pids)) == 1, pids
    node = rt._global_node
    bound = [w for w in node._workers.values()
             if w.env_key.endswith("|gpu:0") and w.state != "DEAD"]
    assert len(bound) == 1, [(w.env_key, w.state) for w in bound]


@pytest.mark.parametrize("runtime", [{"num_cpus": 4, "num_gpus": 2}],
                         indirect=True)
def test_task_waits_for_the_worker_started_for_its_slots(runtime, tmp_path):
    """Two concurrent one-slot tasks get disjoint slots even where the
    second one's worker starts after the first task has ended: the second
    task keeps the slot its worker was started for, and does not take the
    first one's freed slot and run after it."""
    # the worker for slot 1 takes 3 s to start: its interpreter sleeps in
    # a sitecustomize module before the worker's own code runs
    (tmp_path / "sitecustomize.py").write_text(
        "import time\ntime.sleep(3.0)\n")
    node = rt._global_node
    spawn = node._spawn_worker

    def slow_second(env_key="", worker_runtime_env=None, gpus=None):
        if gpus == [1]:
            worker_runtime_env = {"env_vars": {"PYTHONPATH": str(tmp_path)}}
        return spawn(env_key, worker_runtime_env, gpus)

    node._spawn_worker = slow_second

    @rt.remote(num_gpus=1)
    def which_card():
        import time
        time.sleep(0.5)
        return rt.get_runtime_context().get_accelerator_ids()["GPU"]

    a, b = rt.get([which_card.remote(), which_card.remote()], timeout=60)
    assert sorted(a + b) == [0, 1]


@pytest.mark.parametrize("runtime", [{"num_cpus": 3, "num_gpus": 1}],
                         indirect=True)
def test_slot_task_runs_beside_a_worker_parked_in_get(runtime, tmp_path):
    """A slot's worker with a thread left parked in a get() by an earlier
    task is not leased; the slot's next task gets a worker of its own
    instead of waiting for that get() to return."""
    release = tmp_path / "release"

    @rt.remote
    def wait_for_file(path):
        import os
        import time
        while not os.path.exists(path):
            time.sleep(0.05)
        return "released"

    @rt.remote(num_gpus=1)
    def park(refs):
        import os
        import threading
        import time
        threading.Thread(target=rt.get, args=(refs[0],),
                         daemon=True).start()
        time.sleep(0.5)         # the thread is parked in get() by now
        return os.getpid()

    @rt.remote(num_gpus=1)
    def pid():
        import os
        return os.getpid()

    parked = rt.get(park.remote([wait_for_file.remote(str(release))]),
                    timeout=60)
    try:
        assert rt.get(pid.remote(), timeout=30) != parked
    finally:
        release.touch()
