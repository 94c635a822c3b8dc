"""ray_tpu_torch stands alone: no JAX, no ray_tpu, no library attention,
and its entry points run on the card unless asked for the CPU."""

import ast
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "ray_tpu_torch"


# the runtime's modules: the port's own copy of ray_tpu's core runtime
RUNTIME_MODULES = (
    "api", "cluster_utils", "exceptions", "runtime_context", "dag", "state",
    "util", "util.placement_group", "util.scheduling_strategies",
    "util.queue", "util.actor_pool", "util.tracing", "util.tqdm_ray",
    *(f"_private.{m}" for m in (
        "client", "coll_transport", "config", "context", "debug_bundle",
        "debugging", "events", "failpoints", "fieldsan", "flight_recorder",
        "gcs", "gcs_service", "gcs_storage", "history", "ids", "locksan",
        "memory_monitor", "native", "node", "object_ref", "object_store",
        "protocol", "rpc", "runtime_env", "scheduler", "serialization",
        "telemetry", "worker", "worker_bootstrap")),
)
# the data package's modules (pyarrow and PIL stay lazy imports in the
# readers that need them; the card's machine has neither)
DATA_MODULES = tuple(f"data.{m}" for m in (
    "aggregate", "block", "dataset", "datasource", "iterator", "read_api",
    "shuffle", "write_api", "_device"))
# the host collectives, Tune and the rest of util/: none imports torch
HOST_MODULES = (
    "comm", "comm.collective", "comm.device_mesh", "tune", "tune.tuner",
    "tune.search", "tune.searcher", "tune.schedulers", "tune.result_grid",
    "util.metrics", "util.multiprocessing", "util.joblib_backend")
# serving, workflows and the autoscaler: none imports torch, nor grpc (the
# gRPC ingress imports it where it starts or calls)
SERVE_MODULES = (
    "_private.http_util", "serve", "serve.api", "serve.batching",
    "serve.controller", "serve.grpc_ingress", "serve.handle",
    "serve.multiplex", "serve.proxy", "serve.replica",
    "serve.request_context", "workflow", "autoscaler",
    "autoscaler.autoscaler", "autoscaler.node_provider")
# the node main and the head's services (job submission, the dashboard)
# with the CLI and its lints: none imports torch, so a node process never
# does
NODE_MODULES = (
    "_private.main", "_private.gpus", "job", "job.client", "job.http_server", "job.manager",
    "dashboard", "scripts", "scripts.cli", "scripts.check_concurrency",
    "scripts.check_metrics")
# ray_tpu layers a copied module reaches lazily and the port does not have
# yet: importing one fails as for any missing module (none is left)
NOT_PORTED = set()


def _py_files():
    # the package, the chip scripts, and the module the gloo test ranks run
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "chip_mutations.py",
                                        ROOT / "tests" / "torch_dist_worker.py"]


def test_import_leaves_jax_and_ray_tpu_out():
    code = ("import sys, ray_tpu_torch, ray_tpu_torch.models.training, "
            "ray_tpu_torch.models.moe, "
            "ray_tpu_torch.models.convert, ray_tpu_torch.ops._ext, "
            "ray_tpu_torch.parallel, ray_tpu_torch.parallel.tensor_parallel, "
            "ray_tpu_torch.parallel.expert_parallel, "
            "ray_tpu_torch.parallel.pipeline, ray_tpu_torch.parallel.dryrun, "
            "ray_tpu_torch.ops.ring_attention, ray_tpu_torch.rl, "
            "ray_tpu_torch.rl.env, ray_tpu_torch.rl.sample_batch, "
            "ray_tpu_torch.rl.replay_buffers, ray_tpu_torch.rl.module, "
            "ray_tpu_torch.rl.convert, ray_tpu_torch.rl.learner, "
            "ray_tpu_torch.rl.dqn, ray_tpu_torch.rl.vector_env, "
            "ray_tpu_torch.rl.ppo, ray_tpu_torch.rl.impala, "
            "ray_tpu_torch.rl._remote, ray_tpu_torch.ops.cpu_numerics, "
            "ray_tpu_torch.train, ray_tpu_torch.train.trainer, "
            "ray_tpu_torch.train.checkpoint, ray_tpu_torch.train.session, "
            "ray_tpu_torch.train.config, ray_tpu_torch.train.result, "
            "ray_tpu_torch.rl.offline, "
            + ", ".join(f"ray_tpu_torch.{m}" for m in RUNTIME_MODULES
                        + DATA_MODULES + HOST_MODULES + SERVE_MODULES
                        + NODE_MODULES)
            + "; "
            "sys.path.insert(0, 'tests'); import torch_dist_worker; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_tpu', 'optax', 'triton', 'pyarrow', "
            "'PIL')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_runtime_import_is_light():
    """The package and the runtime a worker process runs import no torch,
    JAX or ray_tpu, nor do the data modules whose tasks a worker runs, nor
    the node main, the job service, the dashboard and the CLI that a node
    process runs: the ML subpackages load on first attribute access."""
    code = ("import sys, ray_tpu_torch, ray_tpu_torch._private.node, "
            "ray_tpu_torch._private.worker, ray_tpu_torch.data.dataset, "
            "ray_tpu_torch.data.shuffle, ray_tpu_torch.data.iterator, "
            "ray_tpu_torch._private.main, ray_tpu_torch.job, "
            "ray_tpu_torch.dashboard, ray_tpu_torch.scripts.cli; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'ray_tpu', 'torch')]; print(bad); "
            "import ray_tpu_torch as rt; rt.models, rt.rl, rt.train; "
            "from ray_tpu_torch import ops, parallel; "
            "sys.exit(1 if bad or 'torch' not in sys.modules else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_comm_and_tune_import_leave_torch_out():
    """The host collectives, Tune, the metrics and the pool and joblib
    shims import no torch, as lazy subpackages (`rt.comm`, `rt.tune`) or
    directly, and the train package they reach stays torch-free too: a
    worker that runs numpy collectives or a trial's controller stays
    light, and numpy arrays go through the collectives' ingest and
    output without it. torch loads when a tensor arrives."""
    code = ("import sys, ray_tpu_torch as rt; rt.comm, rt.tune; "
            + "; ".join(f"import ray_tpu_torch.{m}" for m in HOST_MODULES)
            + "; import ray_tpu_torch.train, numpy as np; "
            "from ray_tpu_torch.comm import collective as c; "
            "c._as_caller(c._to_numpy(np.ones(3)), np.ones(3)); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ray_tpu')]; print(bad); "
            "import torch; a = c._to_numpy(torch.ones(2, dtype=torch.bfloat16)); "
            "sys.exit(1 if bad or a.dtype != c._BF16 else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_serve_workflow_autoscaler_import_leave_torch_and_grpc_out():
    """Serve, workflows and the autoscaler import no torch (a replica, a
    workflow step or a proxy that moves no tensor stays light) and no
    grpc (the card's machine has no grpcio)."""
    code = ("import sys; "
            + "; ".join(f"import ray_tpu_torch.{m}" for m in SERVE_MODULES)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'grpc', 'jax', 'ray_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _module_file(parts):
    path = ROOT.joinpath(*parts)
    for cand in (path.with_suffix(".py"), path / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def _defined_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


def test_relative_imports_resolve():
    """Every relative import in the package, lazy ones included, names a
    module or a name of the port's own, except the layers NOT_PORTED lists:
    a missed copy fails here, not at run time."""
    missing = set()
    for path in sorted(PKG.rglob("*.py")):
        parts = list(path.relative_to(ROOT).with_suffix("").parts)
        pkg = parts[:-1]
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.ImportFrom) and node.level):
                continue
            base = pkg[:len(pkg) - node.level + 1]
            base += node.module.split(".") if node.module else []
            base_file = _module_file(base)
            for alias in node.names:
                if _module_file(base + [alias.name]) is not None:
                    continue
                if (base_file is not None
                        and alias.name in _defined_names(base_file)):
                    continue
                missing.add(".".join(base + [alias.name]))
    assert missing == NOT_PORTED


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: p.name)
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "ray_tpu",
                                              "optax"), (path, name)


def test_no_library_attention_in_package():
    """The port's attention is its own kernels: no SDPA, cuDNN attention,
    flash-attn package or torch.compile anywhere in the package.
    (chip_smoke.py times SDPA as a yardstick only.) The standard library's
    ``re.compile``, which the lints in ``scripts/`` use, is not torch's."""
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            name = (node.attr if isinstance(node, ast.Attribute) else
                    node.id if isinstance(node, ast.Name) else None)
            if (name == "compile" and isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "re"):
                continue
            assert name not in ("scaled_dot_product_attention", "compile",
                                "flash_attn", "cudnn"), (path, name)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    from ray_tpu_torch.models import (GPT, init_train_state, llama_tiny,
                                      make_optimizer, make_train_step)
    from ray_tpu_torch.models.training import eval_step_fn

    cfg = llama_tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        GPT(cfg)
    model = GPT(cfg, device="cpu")
    opt = make_optimizer()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(model, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(model, opt)
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_step_fn(model)
    init_train_state(model, opt, device="cpu")
    make_train_step(model, opt, device="cpu")

    # the RL learners and the env runner run on the card unless asked
    from ray_tpu_torch import rl

    for learner, module in ((rl.Learner, rl.DiscretePolicyModule),
                            (rl.DQNLearner, rl.QNetworkModule)):
        with pytest.raises(RuntimeError, match="CUDA"):
            learner(module(4, 2))
        assert learner(module(4, 2), device="cpu").device.type == "cpu"
    cfg = {"observation_size": 4, "action_size": 2}
    with pytest.raises(RuntimeError, match="CUDA"):
        rl.EnvRunner(rl.CartPoleEnv, cfg)
    runner = rl.EnvRunner(rl.CartPoleEnv, cfg, device="cpu")
    assert runner.device.type == "cpu"
    assert next(runner.module.parameters()).device.type == "cpu"

    # device batches: the call raises (no runtime is needed to refuse),
    # never yields CPU tensors unless asked
    from ray_tpu_torch import data

    ds = data.range(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ds.iter_device_batches(batch_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        data.DataIterator(None).iter_device_batches(batch_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        rl.OfflineDQN(_Logged(), observation_size=4, action_size=2)


class _Logged:
    """A dataset of one block of logged transitions, without a runtime."""

    def iter_blocks(self):
        rng = np.random.default_rng(0)
        yield {"obs": rng.normal(size=(4, 4)).astype(np.float32),
               "actions": np.zeros(4, np.int32),
               "rewards": np.ones(4, np.float32),
               "next_obs": rng.normal(size=(4, 4)).astype(np.float32),
               "dones": np.zeros(4, bool)}


def test_kernel_sources_ship():
    from ray_tpu_torch.ops import _ext

    for src, _ in _ext.KERNELS.values():
        assert (_ext.CSRC / src).is_file()
    text = (ROOT / "pyproject.toml").read_text()
    assert '"ray_tpu_torch" = ["csrc/*"]' in text
    assert "ray_tpu_torch/_build/" in (ROOT / ".gitignore").read_text()


def test_every_header_in_the_build_hash():
    """An edit to any header a kernel includes must rebuild the kernels:
    `_ext._target` hashes the sources and `_ext._HEADERS`."""
    from ray_tpu_torch.ops import _ext

    headers = sorted(p.name for p in _ext.CSRC.glob("*.cuh"))
    assert headers and sorted(_ext._HEADERS) == headers
    for src, _ in _ext.KERNELS.values():
        for inc in re.findall(r'#include "([^"]+)"',
                              (_ext.CSRC / src).read_text()):
            assert inc in _ext._HEADERS, (src, inc)


def test_kernels_are_hopper_designs():
    """Every kernel is built from the Hopper pieces (TMA, mbarriers, wgmma):
    each source includes hopper_common.cuh, and no source under csrc/ uses
    the pre-Hopper tensor-core or copy instructions."""
    from ray_tpu_torch.ops import _ext

    for src, _ in _ext.KERNELS.values():
        text = (_ext.CSRC / src).read_text()
        assert '#include "hopper_common.cuh"' in text, src
    for path in _ext.CSRC.iterdir():
        text = path.read_text()
        for legacy in ("mma.sync", "ldmatrix", "cp.async.cg"):
            assert legacy not in text, (path.name, legacy)


def test_flash_params_mirror_the_c_struct():
    """ctypes passes FlashParams by layout: its fields must be the C
    struct's, in order."""
    from ray_tpu_torch.ops import _ext

    text = (_ext.CSRC / "flash_common.cuh").read_text()
    body = re.search(r"struct FlashParams \{(.*?)\};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        # "const void* q", "long long q_sb, q_sh, q_ss", "int B, H, ..."
        first, *rest = [part.strip() for part in decl.split(",")]
        names.append(re.split(r"[\s*]+", first)[-1])
        names += rest
    assert names == [name for name, _ in _ext.FlashParams._fields_]


# the JAX package's runtime test files (none of them imports jax): each
# has a copy tests/test_torch_<stem>.py on the port's runtime
JAX_RUNTIME_TESTS = (
    "core_basic", "core_actors", "refcount", "util", "transport",
    "lease_pipelining", "object_plane", "native_arena", "generators", "dag",
    "runtime_env", "memory_monitor", "memory_introspection", "debugging",
    "history", "gcs_persistence", "log_streaming", "user_journey",
    "telemetry", "tracing_events")


def _test_names(path):
    return {node.name for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name.startswith("test_")}


@functools.lru_cache(maxsize=None)
def _port_test_names():
    return frozenset().union(*(_test_names(p) for p in
                               (ROOT / "tests").glob("test_torch_*.py")))


@pytest.mark.parametrize("stem", JAX_RUNTIME_TESTS)
def test_jax_runtime_tests_have_port_copies(stem):
    """Every test of the JAX package's runtime test file has a test of the
    same name on the port: in its copy, or (not copied twice) in another
    tests/test_torch_*.py; and the original imports no jax."""
    tests = ROOT / "tests"
    original = tests / f"test_{stem}.py"
    assert "jax" not in original.read_text()
    assert (tests / f"test_torch_{stem}.py").exists()
    assert sorted(_test_names(original) - _port_test_names()) == []
