"""Port parity of the node main and the head's services: one driver
program on a process-isolated cluster of ray_tpu and of ray_tpu_torch, the
same job submitted to each, the dashboards' endpoints and keys, the CLIs'
subcommands and flags, and both packages' lints on the same fixture trees.
The only differences allowed are the port's on purpose: ``gpu_*`` in place
of ``tpu_*`` and ``--num-gpus`` beside ``--num-tpus``."""

import argparse
import ast
import json
import os
import re
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
import torch_runtime_tasks as T

TESTS = str(Path(__file__).resolve().parent)


def _node_env():
    """The task bodies' module on the node processes' path: their workers
    import it by name."""
    pp = os.environ.get("PYTHONPATH", "")
    return {"PYTHONPATH": TESTS + (os.pathsep + pp if pp else "")}


def _cluster_module(pkg):
    import importlib
    return importlib.import_module(f"{pkg.__name__}.cluster_utils")


def _check_port_sanitizers():
    # conftest reports only ray_tpu's sanitizers: hold the port's here
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []


# --- one driver program on both --------------------------------------------

def _drive(rt):
    cluster = _cluster_module(rt).Cluster(
        process_isolated=True,
        head_node_args={"num_cpus": 2, "env": _node_env()})
    try:
        cluster.add_node(num_cpus=2, resources={"side": 2.0},
                         env=_node_env())
        rt.init(address=cluster)
        try:
            deadline = time.monotonic() + 30
            while sum(n["alive"] for n in rt.nodes()) < 2:
                assert time.monotonic() < deadline
                time.sleep(0.1)
            name = rt.__name__
            counter = rt.remote(T.Counter).options(
                resources={"side": 1.0}).remote(3)
            big = np.arange(200_000, dtype=np.float64)
            out = {
                "add": rt.get([rt.remote(T.add).remote(i, i)
                               for i in range(6)], timeout=60),
                "side": rt.get(rt.remote(T.echo).options(
                    resources={"side": 1.0}).remote("far"), timeout=60),
                "nested": rt.get(rt.remote(T.nested_parent).remote(name, 5),
                                 timeout=60),
                "chain": rt.get(rt.remote(T.chain).remote(name, 3),
                                timeout=60),
                "counter": [rt.get(counter.incr.remote(2), timeout=60)
                            for _ in range(3)],
                "big": float(rt.get(rt.remote(T.echo).options(
                    resources={"side": 1.0}).remote(rt.put(big)),
                    timeout=60).sum()),
                "resources": rt.cluster_resources(),
                "alive": sorted(n["alive"] for n in rt.nodes()),
            }
            try:
                rt.get(rt.remote(T.boom).remote("bad"), timeout=60)
            except Exception as exc:   # noqa: BLE001 — compared below
                out["error"] = (type(exc).__name__, "bad" in str(exc))
        finally:
            rt.shutdown()
    finally:
        cluster.shutdown()
    return out


def test_driver_program_gives_equal_results():
    jax_out = _drive(ray_tpu)
    port_out = _drive(ray_tpu_torch)
    _check_port_sanitizers()
    assert port_out == jax_out
    assert port_out["resources"] == {"CPU": 4.0, "side": 2.0}
    assert port_out["counter"] == [5, 7, 9]


# --- the same job on both ---------------------------------------------------

JOB = """
import os, time
import {pkg} as rt
rt.init(address=os.environ["RTPU_ADDRESS"])

@rt.remote
def sq(x):
    return x * x

time.sleep(1.0)
print("job-sum:", sum(rt.get([sq.remote(i) for i in range(10)])))
rt.shutdown()
"""


def _statuses(client, job_id, timeout=120):
    """The statuses a poll saw, in order, until the job ended."""
    seen = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status = client.get_job_status(job_id)["status"]
        if not seen or seen[-1] != status:
            seen.append(status)
        if status in ("SUCCEEDED", "FAILED", "STOPPED"):
            return seen
        time.sleep(0.05)
    raise TimeoutError(f"job {job_id} never ended: {seen}")


def _run_jobs(pkg, tmp_path):
    import importlib
    job = importlib.import_module(f"{pkg.__name__}.job")
    cluster = _cluster_module(pkg).Cluster(
        process_isolated=True, head_node_args={"num_cpus": 2})
    try:
        client = job.JobSubmissionClient(
            f"127.0.0.1:{cluster.head.job_port}")
        ok = tmp_path / f"{pkg.__name__}_ok.py"
        ok.write_text(JOB.format(pkg=pkg.__name__))
        bad = tmp_path / f"{pkg.__name__}_bad.py"
        bad.write_text("print('before')\nraise SystemExit('kaboom')\n")
        out = {}
        for name, script in (("ok", ok), ("bad", bad)):
            job_id = client.submit_job(entrypoint=f"python {script}",
                                       submission_id=f"parity-{name}",
                                       metadata={"case": name})
            seq = _statuses(client, job_id)
            rec = client.get_job_status(job_id)
            out[name] = {"statuses": seq, "keys": sorted(rec),
                         "status": rec["status"],
                         "return_code": rec["return_code"],
                         "metadata": rec["metadata"],
                         "logs": client.get_job_logs(job_id)}
        out["listed"] = sorted((r["job_id"], sorted(r))
                               for r in client.list_jobs())
    finally:
        cluster.shutdown()
    return out


def test_job_gives_same_statuses_records_and_logs(tmp_path):
    jax_out = _run_jobs(ray_tpu, tmp_path)
    port_out = _run_jobs(ray_tpu_torch, tmp_path)
    _check_port_sanitizers()
    for name, last in (("ok", "SUCCEEDED"), ("bad", "FAILED")):
        j, t = jax_out[name], port_out[name]
        # a poll may or may not catch the short PENDING before the start
        assert [s for s in j["statuses"] if s != "PENDING"] == \
            [s for s in t["statuses"] if s != "PENDING"]
        assert t["statuses"][-1] == last
        for key in ("keys", "status", "return_code", "metadata", "logs"):
            assert t[key] == j[key], (name, key)
    assert port_out["ok"]["statuses"][-2:] == ["RUNNING", "SUCCEEDED"]
    assert "job-sum: 285" in port_out["ok"]["logs"]
    assert "kaboom" in port_out["bad"]["logs"]
    assert port_out["listed"] == jax_out["listed"]


# --- the dashboards ----------------------------------------------------------

def _routes(pkg):
    """The paths the dashboard's handler compares the request's path
    with: ``path == ...``, ``path in (...)`` and ``path.startswith(...)``."""
    tree = ast.parse(Path(pkg.__file__).parent.joinpath(
        "dashboard", "__init__.py").read_text())
    routes = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Compare)
                and isinstance(node.left, ast.Name)
                and node.left.id == "path"):
            for comp in node.comparators:
                for c in ast.walk(comp):
                    if isinstance(c, ast.Constant) and isinstance(c.value,
                                                                  str):
                        routes.add(c.value)
        elif (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "startswith"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "path"):
            routes.add(node.args[0].value + "*")
    return routes


def _fetch(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.status, resp.read()


def _dashboard_keys(pkg, routes):
    """Each JSON endpoint's keys (and a history sample's), read from a
    dashboard on a one-node runtime that ran a task."""
    import importlib
    dash = importlib.import_module(f"{pkg.__name__}.dashboard")
    pkg.init(num_cpus=2)
    server = dash.DashboardServer(pkg._global_node, host="127.0.0.1")
    server.start()
    try:
        ref = pkg.remote(T.add).remote(1, 2)
        assert pkg.get(ref, timeout=60) == 3
        deadline = time.monotonic() + 30
        while not json.loads(_fetch(server.port, "/api/history")[1])[
                "samples"]:
            assert time.monotonic() < deadline
            time.sleep(0.2)
        keys = {}
        for route in sorted(routes):
            if route in ("", "/", "/index.html", "/metrics"):
                status, body = _fetch(server.port, route or "/")
                keys[route] = status
                continue
            path = (route[:-1] + ref.task_id().hex() if route.endswith("*")
                    else route)
            status, body = _fetch(server.port, path)
            data = json.loads(body)
            keys[route] = (status, sorted(data))
        sample = json.loads(_fetch(server.port, "/api/history")[1])[
            "samples"][-1]
        keys["history sample"] = sorted(sample)
    finally:
        server.stop()
        pkg.shutdown()
    return keys


def test_dashboard_endpoints_and_keys_match():
    routes = _routes(ray_tpu)
    assert _routes(ray_tpu_torch) == routes
    assert {"/api/cluster", "/api/jobs", "/api/history",
            "/api/task/*"} <= routes
    jax_keys = _dashboard_keys(ray_tpu, routes)
    port_keys = _dashboard_keys(ray_tpu_torch, routes)
    _check_port_sanitizers()
    sample = jax_keys.pop("history sample")
    port_sample = port_keys.pop("history sample")
    assert port_keys == jax_keys
    assert {"tpu_total", "tpu_used"} <= set(sample)
    assert port_sample == sorted(k.replace("tpu_", "gpu_") for k in sample)
# --- the CLIs ---------------------------------------------------------------

# --- the CLIs ------------------------------------------------------------------

def _parser(cli, monkeypatch):
    """The CLI's parser, as its main() builds it."""
    class _Built(Exception):
        pass

    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Built

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Built):
            cli.main(["status"])
    return seen["parser"]


def _flags(parser):
    """{subcommand: sorted option strings and positional names}, "" for
    the top level."""
    def of(p):
        out = []
        for action in p._actions:
            if isinstance(action, argparse._SubParsersAction):
                continue
            out += action.option_strings or [action.dest]
        return sorted(out)

    flags = {"": of(parser)}
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    for name, p in sub.choices.items():
        flags[name] = of(p)
    return flags


def test_cli_subcommands_and_flags_match(monkeypatch):
    from ray_tpu.scripts import cli as jcli
    from ray_tpu_torch.scripts import cli as tcli

    jax_flags = _flags(_parser(jcli, monkeypatch))
    port_parser = _parser(tcli, monkeypatch)
    port_flags = _flags(port_parser)
    assert set(port_flags) == set(jax_flags)
    assert "--num-tpus" in jax_flags["start"]
    assert "--num-gpus" not in jax_flags["start"]
    port_start = port_flags.pop("start")
    assert port_start == sorted(jax_flags.pop("start") + ["--num-gpus"])
    assert port_flags == jax_flags
    # --num-tpus and --num-gpus set the same thing
    for flag in ("--num-gpus", "--num-tpus"):
        args = port_parser.parse_args(["start", "--head", flag, "2"])
        assert args.num_gpus == 2.0


def test_node_main_flags_match():
    """The node main's flags: the port's --num-gpus is JAX's --num-tpus,
    which the port keeps as an alias."""
    from ray_tpu._private import main as jmain
    from ray_tpu_torch._private import main as tmain

    def flags(module):
        src = Path(module.__file__).read_text()
        return sorted(set(ast.literal_eval(c) for c in re.findall(
            r'add_argument\(\s*("--[a-z-]+")', src)))

    jax_flags, port_flags = flags(jmain), flags(tmain)
    assert port_flags == sorted(
        [f for f in jax_flags if f != "--num-tpus"] + ["--num-gpus"])
    assert '"--num-gpus", "--num-tpus"' in Path(tmain.__file__).read_text()


# --- the lints on the same fixture trees ----------------------------------

_DESIGN = """# x
## Threading model & lock hierarchy

| Lock | Module | Level | Kind | Protects |
|---|---|---|---|---|
| `t.a` | `mod.py` | 10 | lock | a |
| `t.b` | `mod.py` | 20 | lock | b |

## next
"""

_README = """# x
## Configuration

| Knob | Env override | Default | What it does |
|---|---|---|---|
| `some_knob` | `RTPU_SOME_KNOB` | `1` | x |

## next
"""

_BASE = {
    "locksan.py": ('REGISTRY = {"t.a": ("mod.py", "lock", 10, "a"),'
                   ' "t.b": ("mod.py", "lock", 20, "b")}\n'),
    "config.py": '_CONFIG_DEFS = {"some_knob": (int, 1, "x")}\n',
}

_MOD = ("class C:\n"
        "    def __init__(self):\n"
        "        self._a = locksan.lock(\"t.a\")\n"
        "        self._b = locksan.lock(\"t.b\")\n")

CONCURRENCY_TREES = {
    "baseline": ({"mod.py": _MOD}, _DESIGN, _README),
    "raw_lock": ({"mod.py": _MOD + "    def extra(self):\n"
                  "        self._c = threading.Lock()\n"}, _DESIGN, _README),
    "unregistered_name": ({"mod.py": _MOD.replace('"t.b"', '"t.mystery"')},
                          _DESIGN, _README),
    "inversion": ({"mod.py": _MOD + (
        "    def f(self):\n"
        "        with self._a:\n"
        "            with self._b:\n"
        "                pass\n"
        "    def g(self):\n"
        "        with self._b:\n"
        "            self.h()\n"
        "    def h(self):\n"
        "        with self._a:\n"
        "            pass\n")}, _DESIGN, _README),
    "send_under_lock": ({"mod.py": _MOD + (
        "    def f(self):\n"
        "        with self._a:\n"
        "            self.conn.send((1, 2))\n"
        "    def ok(self):\n"
        "        with self._a:\n"
        "            self.conn.send((1, 2))  "
        "# lint: allow-under-lock(frame order is the invariant)\n"
        "    def g(self):\n"
        "        with self._b:\n"
        "            self.gcs.kv_get(b'k')\n")}, _DESIGN, _README),
    "doc_drift": ({"mod.py": _MOD},
                  _DESIGN.replace("| `t.b` | `mod.py` | 20 | lock | b |",
                                  "| `t.b` | `mod.py` | 21 | lock | b |"),
                  _README.replace("`RTPU_SOME_KNOB`", "`RTPU_WRONG`")),
}

METRIC_TREES = {
    "clean": ('define("counter", "rtpu_ok_total", "x")\n'
              'self.events.info("KNOWN", "ok")\n',
              "`rtpu_ok_total`\n\n### Cluster event & span registry\n\n"
              "`KNOWN`\n"),
    "bad_name": ('define("counter", "rtpu_Bad-Name", "x")\n',
                 "`rtpu_Bad-Name`\n"),
    "undocumented": ('define("counter", "rtpu_new_thing_total", "x")\n',
                     "# no registry here\n"),
    "event_and_span": ('define("counter", "rtpu_ok_total", "x")\n'
                       'self.events.warning("NEW_SURPRISE", "boom")\n'
                       'tracing.start_span("mystery::" + name)\n',
                       "`rtpu_ok_total` `rtpu_stale_total`\n\n"
                       "### Cluster event & span registry\n\n`GONE`\n"),
}


def _both_trees(root, files, design, readme):
    """One fixture tree holding the same package as ray_tpu/ and as
    ray_tpu_torch/, with its design tables where each lint reads them."""
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        for rel, src in files.items():
            path = root / pkg / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(src)
    (root / "DESIGN.md").write_text(design)
    (root / "ray_tpu_torch" / "DESIGN.md").write_text(design)
    (root / "README.md").write_text(readme)
    return str(root)


def _same(problems):
    return sorted(p.replace("ray_tpu_torch/", "ray_tpu/") for p in problems)


@pytest.mark.parametrize("case", sorted(CONCURRENCY_TREES))
def test_concurrency_lints_agree(case, tmp_path):
    from ray_tpu.scripts import check_concurrency as jcc
    from ray_tpu_torch.scripts import check_concurrency as tcc

    files, design, readme = CONCURRENCY_TREES[case]
    root = _both_trees(tmp_path, {**_BASE, **files}, design, readme)
    jax_problems = jcc.check(root)
    assert _same(tcc.check(root)) == _same(jax_problems)
    assert tcc.waiver_report(root) == jcc.waiver_report(root)
    # the fixture package has no node, protocol or failpoints modules:
    # what the lints say of those is not a finding of the case
    findings = [p for p in jax_problems
                if "scanner is broken" not in p and "reader root" not in p
                and "no op constants" not in p and "no handler" not in p]
    assert bool(findings) == (case != "baseline"), findings


@pytest.mark.parametrize("case", sorted(METRIC_TREES))
def test_metric_lints_agree(case, tmp_path):
    from ray_tpu.scripts import check_metrics as jcm
    from ray_tpu_torch.scripts import check_metrics as tcm

    src, readme = METRIC_TREES[case]
    root = _both_trees(tmp_path, {"m.py": src}, "# x\n", readme)
    jax_problems = jcm.check(root)
    assert _same(tcm.check(root)) == _same(jax_problems)
    findings = [p for p in jax_problems if "debug_bundle.py" not in p]
    assert bool(findings) == (case != "clean"), findings
