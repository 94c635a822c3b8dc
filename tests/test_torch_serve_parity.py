"""ray_tpu_torch.serve, .workflow and .autoscaler against ray_tpu's, on the
same inputs, on the CPU.

Each side runs on its own runtime, the port's first, in one process:

* a 2-layer GPT (d 128, 4 heads, vocab 512, seq 64) served from one
  replica through ``@serve.batch``: JAX's replica runs ``GPT.apply`` (its
  Pallas attention under the interpreter), the port's runs ``GPT`` on
  ``device="cpu"`` (the kernels' plain versions) on the same weights
  through ``convert.params_from_jax``; 12 prompts of seeded lengths,
  right-padded, and each answer's last-position logits held normwise;
* the HTTP gateway's answers to the same deployments: routes, a result,
  404, a replica's 500, and a stream's NDJSON frames;
* the access log's row keys, the serve health keys and the serve metrics
  registered with their kinds;
* a workflow that fails, is resumed and re-run: results, step ids and
  statuses.

The batcher and the autoscaler are held without a runtime: the batch
sizes a batcher forms for a fixed arrival sequence, and the nodes an
autoscaler update launches by node type for the same pending demand.
"""

import json
import os
import time
import urllib.error
import urllib.request
from concurrent.futures import Future

import jax
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch as rt
import torch_dist_worker

torch_dist_worker.settle()

# f32 on both sides, sums in another order: the last-position logit vector
# of each prompt, normwise
LOGITS_RTOL = 1e-5
GPT_FAMILY = dict(vocab_size=512, n_layers=2, d_model=128, n_heads=4,
                  max_seq_len=64, activation="gelu", norm="layernorm",
                  positions="learned", tie_embeddings=True, remat=False)
N_PROMPTS = 12
MAX_BATCH = 4


def _prompts():
    rng = np.random.default_rng(3)
    lens = rng.integers(1, GPT_FAMILY["max_seq_len"] + 1, N_PROMPTS)
    return [rng.integers(0, GPT_FAMILY["vocab_size"], n).tolist()
            for n in lens]


def _jax_params():
    from ray_tpu.models import gpt as jgpt

    import jax.numpy as jnp
    cfg = jgpt.GPTConfig(dtype=jnp.float32,
                         attention_impl="pallas_interpret", **GPT_FAMILY)
    params = jgpt.GPT(cfg).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _gpt_server(serve, side):
    """The served GPT (made here, so the class goes to the replica by
    value): each request is one prompt (a token list); a batch is
    right-padded to [MAX_BATCH, seq] (one shape, so JAX compiles once) and
    each answer is the f32 logits at the prompt's last position."""
    family, max_batch = dict(GPT_FAMILY), MAX_BATCH

    @serve.deployment(max_concurrent_queries=16)
    class Server:
        def __init__(self, weights):
            if side == "jax":
                import jax.numpy as jnp

                from ray_tpu.models import gpt
                model = gpt.GPT(gpt.GPTConfig(
                    dtype=jnp.float32, attention_impl="pallas_interpret",
                    **family))
                self._forward = lambda toks: np.asarray(
                    model.apply(weights, jnp.asarray(toks)))
            else:
                import torch

                from ray_tpu_torch.models import gpt
                model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32,
                                              **family), device="cpu")
                model.load_state_dict(weights)
                model.eval()

                def forward(toks):
                    with torch.inference_mode():
                        return model.apply(
                            torch.from_numpy(toks).long()).numpy()
                self._forward = forward
            self.batch_sizes = []

        @serve.batch(max_batch_size=max_batch, batch_wait_timeout_s=0.2)
        def infer(self, prompts):
            self.batch_sizes.append(len(prompts))
            toks = np.zeros((max_batch, family["max_seq_len"]), np.int32)
            for i, p in enumerate(prompts):
                toks[i, :len(p)] = p
            logits = self._forward(toks)
            return [logits[i, len(p) - 1].astype(np.float32)
                    for i, p in enumerate(prompts)]

        def __call__(self, prompt):
            return self.infer(prompt)

        def seen_batches(self):
            return self.batch_sizes

    return Server


def _gateway_apps(serve):
    @serve.deployment
    def echo(body):
        return {"echo": body}

    @serve.deployment
    def greet(body):
        if body and body.get("boom"):
            raise ValueError("deployment exploded")
        return {"hello": (body or {}).get("who", "world")}

    @serve.deployment
    class Chunks:
        def __call__(self, arg):
            def gen():
                for i in range(4):
                    if arg and arg.get("fail_at") == i:
                        raise ValueError("mid-stream boom")
                    yield {"i": i, "sq": i * i}
            return gen()

    return echo, greet, Chunks


def _exchange(url, path, body=None, headers=None):
    """One HTTP request: (status, content type, body bytes)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url + path, data=data,
        headers={"Content-Type": "application/json", **(headers or {})},
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


EXCHANGES = (
    ("/-/routes", None, None),
    ("/echo", {"hi": [1, 2.5, "x"]}, None),
    ("/greet?who=gpu", None, None),
    ("/nope", {"x": 1}, None),
    ("/greet", {"boom": True}, None),
    ("/Chunks", None, {"X-RTPU-Stream": "1"}),
    ("/Chunks", {"fail_at": 2}, {"X-RTPU-Stream": "1"}),
)


def _workflow_steps(rt_mod, marker):
    """A failing-then-resumed DAG and an input DAG (by value, same names on
    both sides, so the step ids match)."""
    def add(path, tag, a, b):
        with open(path, "a") as f:
            f.write(tag + "\n")
        return a + b

    def flaky(path, x):
        with open(path + ".attempts", "a") as f:
            f.write("a\n")
        with open(path + ".attempts") as f:
            if len(f.read().splitlines()) == 1:
                raise RuntimeError("transient step failure")
        return x * 10

    add_r = rt_mod.remote(add)
    flaky_r = rt_mod.remote(flaky).options(max_retries=0)
    left = add_r.bind(marker, "left", 1, 2)
    right = add_r.bind(marker, "right", 3, 4)
    failing = flaky_r.bind(marker, add_r.bind(marker, "join", left, right))
    return add_r, failing


def _side(pkg, tmp, weights):
    """Drive one package's runtime; returns what the tests compare."""
    import importlib

    serve = importlib.import_module(f"{pkg.__name__}.serve")
    state = importlib.import_module(f"{pkg.__name__}.state")
    telemetry = importlib.import_module(f"{pkg.__name__}._private.telemetry")
    workflow = importlib.import_module(f"{pkg.__name__}.workflow")
    dag = importlib.import_module(f"{pkg.__name__}.dag")
    side = "jax" if pkg is ray_tpu else "port"
    out = {}
    pkg.init(num_cpus=4)
    try:
        # the served GPT: 12 concurrent requests through the handle
        handle = serve.run(_gpt_server(serve, side).bind(weights))
        refs = [handle.remote(p) for p in _prompts()]
        out["logits"] = [np.asarray(r.result(timeout=300)) for r in refs]
        controller = pkg.get_actor("rtpu:serve_controller")
        (replica,) = pkg.get(controller.get_replicas.remote("Server"))
        out["batch_sizes"] = pkg.get(
            replica.call_method.remote("seen_batches"))
        deadline = time.monotonic() + 20
        rows = []
        while len(rows) < N_PROMPTS and time.monotonic() < deadline:
            rows = state.serve_requests(limit=100)
            time.sleep(0.2)
        out["row_keys"] = sorted({k for r in rows for k in r})
        out["row_batch_sizes"] = sorted(r["batch_size"] for r in rows)
        health = None
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            dep = (state.serve_health().get("deployments")
                   or {}).get("Server")
            if dep and (dep.get("batch_size") or {}).get("count"):
                health = dep
                break
            time.sleep(0.2)
        out["health_keys"] = sorted(health or {})
        # every serve module defines its metrics when it is imported
        for mod in ("replica", "controller", "batching", "proxy"):
            importlib.import_module(f"{pkg.__name__}.serve.{mod}")
        out["metrics"] = {n: m["kind"] for n, m in telemetry._meta.items()
                          if n.startswith("rtpu_serve_")}
        serve.delete("Server")

        # the gateway's answers
        for app in _gateway_apps(serve):
            serve.run(app.bind())
        url = serve.start_http(port=0)
        out["http"] = [_exchange(url, *ex) for ex in EXCHANGES]
        serve.shutdown()

        # a workflow: fails, is resumed, is re-run; and one with an input
        workflow.init(str(tmp / "wf"))
        marker = str(tmp / "trace.txt")
        add_r, failing = _workflow_steps(pkg, marker)
        wf = {}
        try:
            workflow.run(failing, workflow_id="p")
        except Exception as e:   # noqa: BLE001 — the step's own failure
            wf["error"] = type(e).__name__
        wf["failed_status"] = workflow.get_status("p")
        steps_dir = tmp / "wf" / "p" / "steps"
        wf["steps_after_failure"] = sorted(os.listdir(steps_dir))
        wf["resumed"] = workflow.resume("p")
        wf["status"] = workflow.get_status("p")
        wf["steps"] = sorted(os.listdir(steps_dir))
        wf["rerun"] = workflow.run(failing, workflow_id="p")
        # left and right run in parallel: their order is the runtime's
        wf["trace"] = sorted(open(marker).read().splitlines())
        with dag.InputNode() as inp:
            kw = add_r.bind(marker, "kw", inp.x, inp.y)
        wf["kw"] = workflow.run(kw, x=20, y=22, workflow_id="kw")
        wf["list"] = workflow.list_all()
        workflow.init(None)
        out["workflow"] = wf
    finally:
        serve.shutdown()
        pkg.shutdown()
    return out


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models import gpt as tgpt
    import torch

    params = _jax_params()
    port_weights = params_from_jax(params, tgpt.GPTConfig(
        dtype=torch.float32, **GPT_FAMILY))
    port = _side(rt, tmp_path_factory.mktemp("port"), port_weights)
    ref = _side(ray_tpu, tmp_path_factory.mktemp("jax"), params)
    yield port, ref
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []


def test_served_gpt_logits_match_jax(sides):
    port, ref = sides
    assert len(port["logits"]) == len(ref["logits"]) == N_PROMPTS
    for i, (t, j) in enumerate(zip(port["logits"], ref["logits"])):
        assert t.dtype == j.dtype == np.float32
        assert t.shape == j.shape == (GPT_FAMILY["vocab_size"],)
        err = np.linalg.norm(t - j) / np.linalg.norm(j)
        assert err <= LOGITS_RTOL, (i, err)
    # every request went through a batch of at most MAX_BATCH
    for side in (port, ref):
        assert sum(side["batch_sizes"]) == N_PROMPTS
        assert max(side["batch_sizes"]) <= MAX_BATCH


def _cut_traceback(error: str) -> tuple:
    """A replica's error up to its remote traceback, and the traceback's
    last line: the frames between name each package's own files."""
    head, sep, tb = error.partition("\n--- remote traceback ---\n")
    return head, tb.strip().splitlines()[-1] if sep else None


def _comparable(status, ctype, body):
    if status == 200 and ctype == "application/json":
        return status, ctype, body
    if ctype == "application/x-ndjson":
        frames = [json.loads(ln) for ln in body.splitlines()]
        return status, ctype, [
            {"error": _cut_traceback(f["error"])} if "error" in f else f
            for f in frames]
    payload = json.loads(body)
    return status, ctype, {"error": _cut_traceback(payload["error"])}


def test_gateway_answers_match_jax(sides):
    """Routes, a JSON result, the query form and the streams' item frames
    are byte-equal; a 404's body too; a replica's 500 and a stream's error
    frame are equal up to the remote traceback."""
    port, ref = sides
    assert [h[:2] for h in port["http"]] == [h[:2] for h in ref["http"]]
    assert [h[0] for h in port["http"]] == [200, 200, 200, 404, 500, 200,
                                            200]
    for (path, body, _), p, j in zip(EXCHANGES, port["http"], ref["http"]):
        if p[0] in (200, 404) and p[1] == "application/json":
            assert p[2] == j[2], path           # byte for byte
        assert _comparable(*p) == _comparable(*j), path
    stream = port["http"][5][2]
    assert stream == ref["http"][5][2]
    assert [json.loads(ln) for ln in stream.splitlines()] == [
        {"item": {"i": i, "sq": i * i}} for i in range(4)]
    failed = [json.loads(ln) for ln in port["http"][6][2].splitlines()]
    assert failed[:2] == [{"item": {"i": 0, "sq": 0}},
                          {"item": {"i": 1, "sq": 1}}]
    assert "mid-stream boom" in failed[2]["error"]
    assert "deployment exploded" in json.loads(port["http"][4][2])["error"]


def test_access_rows_health_and_metrics_match_jax(sides):
    port, ref = sides
    assert port["row_keys"] == ref["row_keys"]
    assert "batch_size" in port["row_keys"]
    assert port["health_keys"] == ref["health_keys"] != []
    assert port["metrics"] == ref["metrics"]
    assert len(port["metrics"]) >= 6
    for side in (port, ref):
        assert len(side["row_batch_sizes"]) >= N_PROMPTS
        assert max(side["row_batch_sizes"]) <= MAX_BATCH


def test_workflow_results_step_ids_and_statuses_match_jax(sides):
    port, ref = sides
    assert port["workflow"] == ref["workflow"]
    wf = port["workflow"]
    assert wf["failed_status"] == "FAILED" and wf["status"] == "SUCCESSFUL"
    assert wf["resumed"] == wf["rerun"] == 100 and wf["kw"] == 42
    assert len(wf["steps_after_failure"]) == 3
    assert len(wf["steps"]) == 5            # 4 steps and the output
    assert wf["trace"] == ["join", "left", "right"]      # once each


# ------------------------------------------------ the batcher, no runtime

ARRIVALS = ((7, 4, 10), (1, 1, 5), (12,))


@pytest.mark.parametrize("waves", ARRIVALS, ids=str)
def test_batch_sizes_match_jax_for_an_arrival_sequence(waves):
    """Each wave of requests arrives before the collector takes the first
    (queued at once, so timing plays no part): both batchers form the same
    batches, each of max_batch_size until the wave runs out."""
    from ray_tpu.serve.batching import _Batcher as JaxBatcher
    from ray_tpu_torch.serve.batching import _Batcher as PortBatcher

    def sizes(cls):
        seen = []
        for n in waves:
            b = cls(lambda xs: (seen.append(len(xs)), xs)[1],
                    max_batch_size=4, timeout_s=0.05)
            futures = []
            for i in range(n):
                fut = Future()
                b.q.put((i, fut, None, None))
                futures.append(fut)
            b._ensure_thread()
            assert [f.result(timeout=30) for f in futures] == list(range(n))
        return seen

    port, ref = sizes(PortBatcher), sizes(JaxBatcher)
    assert port == ref
    assert sum(port) == sum(waves) and max(port) <= 4


# --------------------------------------------- the autoscaler, no runtime

class _Id(str):
    def hex(self):
        return str(self)


class _Node:
    def __init__(self, node_id, total, available=None, pending=()):
        self.node_id = _Id(node_id)
        self.resources_total = dict(total)
        self.resources_available = dict(available or total)
        self.pending_shapes = list(pending)


class _Gcs:
    def __init__(self, nodes, gangs=()):
        self.nodes = nodes
        self.gangs = list(gangs)

    def alive_nodes(self):
        return list(self.nodes)

    def pending_pgs_snapshot(self):
        return [{"spec": g, "last_attempt": time.time()} for g in self.gangs]

    def directory_snapshot(self):
        return []

    def gang_hosts(self):
        return set()


class _Gang:
    def __init__(self, bundles, strategy):
        self.bundles = bundles
        self.strategy = strategy


class _Provider:
    def __init__(self):
        self.nodes = []

    def create_node(self, node_type, resources, labels):
        self.nodes.append({"type": node_type,
                           "id": _Id(f"n{len(self.nodes)}")})
        return self.nodes[-1]

    def non_terminated_nodes(self):
        return list(self.nodes)

    def node_type_of(self, handle):
        return handle["type"]

    def node_id_of(self, handle):
        return handle["id"]

    def terminate_node(self, handle):
        self.nodes.remove(handle)


GPU = {"CPU": 2.0, "GPU": 1.0}
GPU4 = {"CPU": 8.0, "GPU": 4.0}
DEMANDS = {
    "gpu_tasks": dict(pending=[{"GPU": 1.0}] * 10),
    "mixed_shapes": dict(pending=[{"GPU": 4.0}] * 2 + [{"GPU": 1.0}] * 3
                         + [{"CPU": 1.0}] * 2),
    "strict_spread": dict(gangs=[([{"GPU": 1.0}] * 3, "STRICT_SPREAD")]),
    "strict_pack": dict(gangs=[([{"GPU": 2.0}] * 2, "STRICT_PACK")]),
    "pack": dict(gangs=[([{"GPU": 3.0}] * 2, "PACK")]),
    "tasks_and_gang": dict(pending=[{"GPU": 1.0}] * 2,
                           gangs=[([{"GPU": 4.0}] * 2, "STRICT_SPREAD")]),
    "one_launch_per_update": dict(pending=[{"GPU": 1.0}] * 5, speed=0.0,
                                  updates=3),
    "idle_drain": dict(pending=[], start=2),
}


@pytest.mark.parametrize("case", sorted(DEMANDS))
def test_autoscaler_launches_match_jax(case):
    """The same cluster (a 2-CPU head without a GPU) and the same pending
    demand: both autoscalers launch the same nodes by type (capped by each
    type's max_workers and the upscaling speed), and drain the same idle
    ones."""
    from ray_tpu.autoscaler import autoscaler as jas
    from ray_tpu_torch.autoscaler import autoscaler as tas

    spec = DEMANDS[case]

    def run(mod):
        config = mod.AutoscalerConfig(
            node_types={"gpu1": mod.NodeType(resources=GPU, max_workers=3),
                        "gpu4": mod.NodeType(resources=GPU4,
                                             max_workers=2)},
            idle_timeout_s=0.0, upscaling_speed=spec.get("speed", 8.0))
        gangs = [_Gang(b, s) for b, s in spec.get("gangs", ())]
        head = _Node("head", {"CPU": 2.0}, pending=spec.get("pending", ()))
        provider = _Provider()
        scaler = mod.StandardAutoscaler(_Gcs([head], gangs), provider,
                                        config)
        started = []
        for _ in range(spec.get("start", 0)):
            started.append(provider.create_node("gpu1", GPU, {}))
        scaler.gcs.nodes += [_Node(h["id"], GPU) for h in started]
        for _ in range(spec.get("updates", 1)):
            scaler.update()
        by_type = {}
        for h in provider.non_terminated_nodes():
            by_type[h["type"]] = by_type.get(h["type"], 0) + 1
        return by_type, scaler.num_launched, scaler.num_terminated

    port, ref = run(tas), run(jas)
    assert port == ref
    if case == "idle_drain":
        assert port == ({}, 0, 2)
    else:
        assert port[1] >= 1
