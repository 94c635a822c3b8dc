"""Serve tests aimed at ray_tpu_torch.serve (copies of tests/test_serve.py;
reference model: ``python/ray/serve/tests/`` — deploy, handle routing,
batching, autoscaling, HTTP), and the port's own cases: GPU slots for
replicas, the import without grpcio, and a replica result the gateway
cannot restore."""

import json
import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve


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
def rtpu_cluster():
    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(initialize_head=True,
                      head_node_args={"num_cpus": 2})
    ray_tpu_torch.init(address=cluster)
    yield cluster
    ray_tpu_torch.shutdown()
    cluster.shutdown()
    _check_sanitizers()


@pytest.fixture
def serve_session(rtpu_init):
    yield
    serve.shutdown()


def test_function_deployment(serve_session):
    @serve.deployment
    def square(x):
        return x * x

    handle = serve.run(square.bind())
    assert handle.remote(7).result(timeout=10) == 49


def test_class_deployment_and_replicas(serve_session):
    @serve.deployment(num_replicas=2)
    class Adder:
        def __init__(self, bias):
            self.bias = bias

        def __call__(self, x):
            return x + self.bias

    handle = serve.run(Adder.bind(10))
    results = [handle.remote(i).result(timeout=10) for i in range(6)]
    assert results == [10, 11, 12, 13, 14, 15]
    controller = ray_tpu_torch.get_actor("rtpu:serve_controller")
    counts = ray_tpu_torch.get(controller.list_deployments.remote())
    assert counts["Adder"] == 2


def test_batching(serve_session):
    @serve.deployment(max_concurrent_queries=8)
    class Model:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.1)
        def _infer(self, xs):
            self.batch_sizes.append(len(xs))
            return [x * 2 for x in xs]

        def __call__(self, x):
            return self._infer(x)

        def seen_batches(self):
            return self.batch_sizes

    handle = serve.run(Model.bind())
    # concurrent requests coalesce into batches
    responses = [handle.remote(i) for i in range(8)]
    values = sorted(r.result(timeout=15) for r in responses)
    assert values == [0, 2, 4, 6, 8, 10, 12, 14]
    controller = ray_tpu_torch.get_actor("rtpu:serve_controller")
    replicas = ray_tpu_torch.get(
        controller.get_replicas.remote("Model"))
    sizes = ray_tpu_torch.get(
        replicas[0].call_method.remote("seen_batches"))
    assert max(sizes) > 1          # at least one real batch formed


def test_http_gateway(serve_session):
    @serve.deployment
    def echo(body):
        return {"echo": body}

    serve.run(echo.bind())
    url = serve.start_http(port=0)
    req = urllib.request.Request(
        f"{url}/echo", data=json.dumps({"hi": 1}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        payload = json.loads(resp.read())
    assert payload["result"]["echo"] == {"hi": 1}


def test_autoscaling_up(serve_session):
    @serve.deployment(num_replicas=1,
                      autoscaling_config={"min_replicas": 1,
                                          "max_replicas": 3,
                                          "target_num_ongoing_requests_per_replica": 1})
    class Slow:
        def __call__(self, x):
            time.sleep(0.4)
            return x

    handle = serve.run(Slow.bind())
    responses = [handle.remote(i) for i in range(12)]
    deadline = time.monotonic() + 15
    controller = ray_tpu_torch.get_actor("rtpu:serve_controller")
    scaled = False
    while time.monotonic() < deadline:
        counts = ray_tpu_torch.get(controller.list_deployments.remote())
        if counts.get("Slow", 1) > 1:
            scaled = True
            break
        time.sleep(0.2)
    for r in responses:
        r.result(timeout=30)
    assert scaled, "autoscaler never added a replica under load"


def test_batch_deadline_is_absolute():
    """Under a trickle of requests arriving faster than the batch
    timeout, the first caller must not wait longer than ~timeout — the
    deadline is absolute per batch, not reset per arrival."""
    import threading
    import time as _t

    from ray_tpu_torch.serve.batching import _Batcher

    b = _Batcher(lambda xs: [len(xs)] * len(xs),
                 max_batch_size=100, timeout_s=0.25)
    first_latency = {}

    def first():
        t0 = _t.monotonic()
        b.submit(0)
        first_latency["dt"] = _t.monotonic() - t0

    t = threading.Thread(target=first)
    t.start()
    # trickle: one request every 80ms for ~1.2s — with a per-arrival
    # reset the batch would only close after the trickle ends
    feeders = []
    for i in range(15):
        _t.sleep(0.08)
        th = threading.Thread(target=b.submit, args=(i + 1,))
        th.start()
        feeders.append(th)
    t.join(timeout=5)
    for th in feeders:
        th.join(timeout=5)
    assert first_latency["dt"] < 0.8, (
        f"first caller waited {first_latency['dt']:.2f}s (deadline reset)")


def test_http_gateway_routes_and_errors(serve_session):
    @serve.deployment
    def greet(body):
        if body and body.get("boom"):
            raise ValueError("deployment exploded")
        return {"hello": (body or {}).get("who", "world")}

    serve.run(greet.bind())
    url = serve.start_http(port=0)

    # route listing
    with urllib.request.urlopen(f"{url}/-/routes", timeout=10) as resp:
        assert json.loads(resp.read()) == {"/greet": "greet"}

    # GET with query params
    with urllib.request.urlopen(f"{url}/greet?who=tpu", timeout=10) as resp:
        assert json.loads(resp.read())["result"] == {"hello": "tpu"}

    # unknown deployment -> 404 (not a generic 500)
    try:
        urllib.request.urlopen(f"{url}/nope", timeout=10)
        assert False, "expected HTTPError"
    except urllib.error.HTTPError as e:
        assert e.code == 404

    # deployment exception -> 500 with the error message
    req = urllib.request.Request(
        f"{url}/greet", data=json.dumps({"boom": True}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        urllib.request.urlopen(req, timeout=30)
        assert False, "expected HTTPError"
    except urllib.error.HTTPError as e:
        assert e.code == 500
        assert "exploded" in json.loads(e.read())["error"]


def test_http_gateway_concurrent_posts(serve_session):
    import concurrent.futures

    @serve.deployment(num_replicas=2)
    def double(body):
        return body["x"] * 2

    serve.run(double.bind())
    url = serve.start_http(port=0)

    def post(i):
        req = urllib.request.Request(
            f"{url}/double", data=json.dumps({"x": i}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())["result"]

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        out = list(pool.map(post, range(16)))
    assert out == [i * 2 for i in range(16)]


def test_stop_http_releases_port(serve_session):
    @serve.deployment
    def one(body):
        return 1

    serve.run(one.bind())
    url = serve.start_http(port=0)
    port = int(url.rsplit(":", 1)[1])
    serve.stop_http()
    # the port is free for an immediate rebind (server_close ran)
    import socket as s
    sock = s.socket()
    sock.bind(("127.0.0.1", port))
    sock.close()


def test_streaming_handle(serve_session):
    import time as _time

    @serve.deployment
    class Tokens:
        def __call__(self, n):
            for i in range(int(n)):
                _time.sleep(0.2)
                yield f"tok{i}"

    h = serve.run(Tokens.bind())
    t0 = _time.time()
    times = []
    vals = []
    for v in h.stream(6):
        vals.append(v)
        times.append(_time.time() - t0)
    assert vals == [f"tok{i}" for i in range(6)]
    # items arrived incrementally, not as one batch at the end
    assert times[0] < 0.7 * times[-1], times


def test_streaming_http(serve_session):
    import time as _time
    import urllib.request

    @serve.deployment
    class Chunks:
        def __call__(self, arg):
            for i in range(5):
                _time.sleep(0.2)
                yield {"i": i}

    serve.run(Chunks.bind())
    url = serve.start_http(port=0)
    req = urllib.request.Request(f"{url}/Chunks", method="GET",
                                 headers={"X-RTPU-Stream": "1"})
    t0 = _time.time()
    lines, stamps = [], []
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert resp.headers["Content-Type"] == "application/x-ndjson"
        for raw in resp:
            lines.append(json.loads(raw))
            stamps.append(_time.time() - t0)
    assert [ln["item"]["i"] for ln in lines] == list(range(5))
    assert stamps[0] < 0.7 * stamps[-1], stamps


def test_multiplexed_model_loading(serve_session):
    """@serve.multiplexed LRU-loads models per replica under a cap and
    routes by model affinity (reference: serve/multiplex.py)."""

    @serve.deployment(num_replicas=1)
    class MuxModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            self.loads.append(model_id)
            return f"model-{model_id}"

        def __call__(self, x):
            mid = serve.get_multiplexed_model_id()
            model = self.get_model(mid)
            return {"model": model, "x": x, "loads": list(self.loads)}

    handle = serve.run(MuxModel.bind())
    r1 = handle.options(multiplexed_model_id="a").remote(1).result()
    assert r1["model"] == "model-a" and r1["loads"] == ["a"]
    # cache hit: same model, no reload
    r2 = handle.options(multiplexed_model_id="a").remote(2).result()
    assert r2["loads"] == ["a"]
    # second model fits the cap
    handle.options(multiplexed_model_id="b").remote(3).result()
    # third evicts LRU ("a"); re-requesting "a" reloads it
    handle.options(multiplexed_model_id="c").remote(4).result()
    r5 = handle.options(multiplexed_model_id="a").remote(5).result()
    assert r5["loads"] == ["a", "b", "c", "a"]
    serve.delete("MuxModel")


def test_proxy_on_every_node(rtpu_cluster):
    """serve.start(proxy_location='EveryNode') puts a gateway on each
    node; a request through ANY node's address reaches the app
    (reference: proxy_state.py per-node proxies)."""
    import json
    import urllib.request

    node = rtpu_cluster.add_node(num_cpus=2)
    try:
        @serve.deployment(num_replicas=1)
        def double(x):
            return {"doubled": (x or {"v": 0})["v"] * 2}

        serve.run(double.bind())
        addrs = serve.start(proxy_location="EveryNode")
        assert len(addrs) == 2, addrs
        for node_hex, addr in addrs.items():
            body = json.dumps({"v": 21}).encode()
            req = urllib.request.Request(
                f"{addr}/double", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                out = json.loads(resp.read())
            assert out == {"result": {"doubled": 42}}, (node_hex, out)
        assert set(serve.proxy_addresses()) == set(addrs)
    finally:
        serve.shutdown()


def test_multiplexed_streaming(serve_session):
    """Pin: options(multiplexed_model_id=...).stream() binds the model
    id both at call time and during generator iteration."""

    @serve.deployment(num_replicas=1)
    class S:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, mid):
            return mid

        def __call__(self, n):
            eager = self.get_model(serve.get_multiplexed_model_id())

            def gen():
                for i in range(n):
                    lazy = serve.get_multiplexed_model_id()
                    yield {"eager": eager, "lazy": lazy}
            return gen()

    handle = serve.run(S.bind())
    items = list(handle.options(multiplexed_model_id="mx").stream(2))
    assert items == [{"eager": "mx", "lazy": "mx"}] * 2, items
    serve.delete("S")


def test_grpc_ingress_call_stream_and_multiplex(serve_session):
    """gRPC ingress (reference: serve gRPCProxy): unary call, server
    streaming with mid-stream error frames, multiplexed model id
    propagation, unknown-deployment errors."""

    @serve.deployment(num_replicas=1)
    class G:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, mid):
            return f"M{mid}"

        def __call__(self, x):
            mid = serve.get_multiplexed_model_id()
            if isinstance(x, dict) and x.get("stream"):
                def gen():
                    for i in range(int(x["stream"])):
                        if x.get("boom") and i == 1:
                            raise ValueError("mid-stream boom")
                        yield {"i": i, "m": self.get_model(mid) if mid
                               else None}
                return gen()
            return {"x": x, "m": self.get_model(mid) if mid else None}

    serve.run(G.bind())
    addr = serve.start_grpc()

    out = serve.grpc_call(addr, "G", {"v": 1})
    assert out == {"result": {"x": {"v": 1}, "m": None}}
    out = serve.grpc_call(addr, "G", 5, multiplexed_model_id="a")
    assert out["result"]["m"] == "Ma"
    out = serve.grpc_call(addr, "Nope", 1)
    assert "error" in out

    frames = list(serve.grpc_stream(addr, "G", {"stream": 3},
                                    multiplexed_model_id="b"))
    assert frames == [{"item": {"i": i, "m": "Mb"}} for i in range(3)]
    frames = list(serve.grpc_stream(addr, "G",
                                    {"stream": 3, "boom": True}))
    assert frames[0] == {"item": {"i": 0, "m": None}}
    assert "error" in frames[-1]
    serve.stop_grpc()
    serve.delete("G")


def test_proxy_grpc_on_every_node(rtpu_cluster):
    """Per-node proxies serve gRPC alongside HTTP (reference: the
    proxy actor hosts both protocol frontends)."""
    rtpu_cluster.add_node(num_cpus=2)

    try:
        @serve.deployment(num_replicas=1)
        def triple(x):
            return {"tripled": (x or {"v": 0})["v"] * 3}

        serve.run(triple.bind())
        serve.start(proxy_location="EveryNode")
        from ray_tpu_torch import get, get_actor
        from ray_tpu_torch.serve.proxy import _PROXY_PREFIX, _alive_nodes

        grpc_addrs = []
        for node in _alive_nodes():
            proxy = get_actor(_PROXY_PREFIX + node["node_id"].hex())
            grpc_addrs.append(get(proxy.grpc_address.remote(),
                                  timeout=30))
        assert len(grpc_addrs) == 2 and all(grpc_addrs)
        for addr in grpc_addrs:
            out = serve.grpc_call(addr, "triple", {"v": 14})
            assert out == {"result": {"tripled": 42}}, (addr, out)
    finally:
        serve.shutdown()


def test_proxy_recreated_after_death(rtpu_cluster):
    """ensure_proxies is a reconciler: a dead proxy actor is replaced
    on the next start() (reference: ProxyStateManager restarts
    unhealthy proxies)."""
    import urllib.request

    try:
        @serve.deployment(num_replicas=1)
        def ping(x):
            return {"pong": True}

        serve.run(ping.bind())
        addrs = serve.start(proxy_location="EveryNode")
        (node_hex,) = list(addrs)
        from ray_tpu_torch import get_actor, kill
        from ray_tpu_torch.serve.proxy import _PROXY_PREFIX
        kill(get_actor(_PROXY_PREFIX + node_hex))
        time.sleep(0.5)
        addrs2 = serve.start(proxy_location="EveryNode")
        assert node_hex in addrs2
        with urllib.request.urlopen(f"{addrs2[node_hex]}/ping",
                                    timeout=30) as resp:
            assert resp.status == 200
    finally:
        serve.shutdown()


# ------------------------------------------------------------ the port's

def _actor_state(actor_id_hex):
    from ray_tpu_torch import state

    for row in state.list_actors():
        aid = row.get("actor_id")
        if (aid.hex() if hasattr(aid, "hex") else str(aid)) == actor_id_hex:
            return row.get("state")
    return None


def _wait_for(predicate, timeout=20.0, period=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(period)
    return predicate()


def test_gpu_replica_holds_its_slot_until_deleted():
    """A num_gpus=1 replica sees its slot as CUDA_VISIBLE_DEVICES; with one
    slot a second such replica stays pending; serve.delete gives the slot
    back and a redeploy gets it (no card needed: slots are a resource)."""
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    try:
        @serve.deployment(ray_actor_options={"num_gpus": 1})
        class Card:
            def __call__(self, x):
                import os

                import ray_tpu_torch as rt
                return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                        "ids": rt.get_runtime_context()
                        .get_accelerator_ids()["GPU"], "x": x}

        handle = serve.run(Card.bind())
        out = handle.remote(1).result(timeout=30)
        assert out == {"visible": "0", "ids": [0], "x": 1}
        assert ray_tpu_torch.available_resources().get("GPU", 0) == 0

        serve.run(Card.options(num_replicas=2).bind())
        controller = ray_tpu_torch.get_actor("rtpu:serve_controller")
        first, second = ray_tpu_torch.get(
            controller.get_replicas.remote("Card"))
        assert _wait_for(lambda: _actor_state(second.actor_id.hex())
                         == "PENDING_CREATION")
        time.sleep(1.0)          # it stays pending: the one slot is held
        assert _actor_state(first.actor_id.hex()) == "ALIVE"
        assert _actor_state(second.actor_id.hex()) == "PENDING_CREATION"

        serve.delete("Card")
        assert _wait_for(lambda: ray_tpu_torch.available_resources()
                         .get("GPU", 0) == 1), \
            ray_tpu_torch.available_resources()
        handle = serve.run(Card.bind())
        out = handle.remote(2).result(timeout=30)
        assert out == {"visible": "0", "ids": [0], "x": 2}
        serve.shutdown()
    finally:
        ray_tpu_torch.shutdown()
    _check_sanitizers()


def test_serve_imports_and_serves_http_without_grpc(tmp_path):
    """The card's machine has no grpcio: `import ray_tpu_torch.serve` and
    the HeadOnly HTTP gateway work without it; only the gRPC ingress
    needs it, and says so when it starts."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    code = (
        "import sys, json, urllib.request\n"
        "sys.modules['grpc'] = None\n"          # import grpc now fails
        "import ray_tpu_torch as rt\n"
        "from ray_tpu_torch import serve\n"
        "rt.init(num_cpus=2)\n"
        "@serve.deployment\n"
        "def double(body):\n"
        "    return body['x'] * 2\n"
        "serve.run(double.bind())\n"
        "url = serve.start(proxy_location='HeadOnly', http_port=0)\n"
        "req = urllib.request.Request(url + '/double',\n"
        "    data=json.dumps({'x': 21}).encode(),\n"
        "    headers={'Content-Type': 'application/json'})\n"
        "with urllib.request.urlopen(req, timeout=30) as resp:\n"
        "    assert json.loads(resp.read()) == {'result': 42}\n"
        "try:\n"
        "    serve.start_grpc()\n"
        "except ImportError as e:\n"
        "    print('grpc refused:', e)\n"
        "else:\n"
        "    sys.exit('the gRPC ingress started without grpcio')\n"
        "serve.shutdown()\n"
        "rt.shutdown()\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and m.split('.')[0] in ('grpc', 'jax', 'ray_tpu')]\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "grpc refused" in proc.stdout


class _CudaTensorOnTheWire:
    """Pickles exactly as a replica's CUDA tensor does (the store's
    out-of-band form with its device), so a caller without a card has to
    restore a CUDA tensor; no card is needed to make it."""

    def __reduce__(self):
        from ray_tpu_torch._private import serialization as ser
        return ser._restore_tensor, (bytes(8), "float32", (2,), False,
                                     "cuda:0", False)


def test_gateway_answers_500_for_a_cuda_result_it_cannot_restore(
        serve_session):
    """A replica that returns a CUDA tensor to a gateway that sees no card:
    the Python handle raises TensorDeviceError, and an HTTP caller gets the
    500 body a failing replica gives ({"error": ...}), never a tensor
    landed on the CPU."""
    import torch

    from ray_tpu_torch._private.serialization import TensorDeviceError

    if torch.cuda.is_available():
        pytest.skip("this checks a caller that sees no card")
    wire = _CudaTensorOnTheWire

    @serve.deployment
    def logits(body):
        return wire()

    handle = serve.run(logits.bind())
    with pytest.raises(TensorDeviceError, match="sees no CUDA device"):
        handle.remote(None).result(timeout=30)

    url = serve.start_http(port=0)
    req = urllib.request.Request(
        f"{url}/logits", data=json.dumps({"x": 1}).encode(),
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as info:
        urllib.request.urlopen(req, timeout=30)
    assert info.value.code == 500
    body = json.loads(info.value.read())
    assert list(body) == ["error"]
    assert "tensor from cuda:0" in body["error"]
    assert "sees no CUDA device" in body["error"]
