# A copy of tests/test_runtime_env.py on ray_tpu_torch's runtime: the same
# tests under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown.
"""Runtime env tests (reference model: ``python/ray/tests/
test_runtime_env*.py`` — env_vars, working_dir, pool isolation)."""

import os

import pytest

import ray_tpu_torch
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


def test_env_vars_per_task(rtpu_init):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"RTPU_TEST_FLAG": "hello"}})
    def read_env():
        return os.environ.get("RTPU_TEST_FLAG")

    @ray_tpu_torch.remote
    def read_plain():
        return os.environ.get("RTPU_TEST_FLAG")

    assert ray_tpu_torch.get(read_env.remote()) == "hello"
    # default-env workers must NOT see the variable (pool isolation)
    assert ray_tpu_torch.get(read_plain.remote()) is None


def test_env_vars_actor(rtpu_init):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"ACTOR_ENV": "42"}})
    class A:
        def read(self):
            return os.environ.get("ACTOR_ENV")

    assert ray_tpu_torch.get(A.remote().read.remote()) == "42"


def test_working_dir(rtpu_init, tmp_path):
    pkg = tmp_path / "mypkg"
    pkg.mkdir()
    (pkg / "my_module_rtpu_test.py").write_text("VALUE = 'from_wd'\n")
    (pkg / "data.txt").write_text("payload")

    @ray_tpu_torch.remote(runtime_env={"working_dir": str(pkg)})
    def use_wd():
        import my_module_rtpu_test
        with open("data.txt") as f:
            return my_module_rtpu_test.VALUE, f.read()

    assert ray_tpu_torch.get(use_wd.remote()) == ("from_wd", "payload")


def test_job_level_runtime_env(tmp_path):
    ray_tpu_torch.init(num_cpus=2,
                       runtime_env={"env_vars": {"JOB_WIDE": "yes"}})
    try:
        @ray_tpu_torch.remote
        def read():
            return os.environ.get("JOB_WIDE")

        @ray_tpu_torch.remote(runtime_env={"env_vars": {"EXTRA": "1"}})
        def read_both():
            return (os.environ.get("JOB_WIDE"), os.environ.get("EXTRA"))

        assert ray_tpu_torch.get(read.remote()) == "yes"
        assert ray_tpu_torch.get(read_both.remote()) == ("yes", "1")
    finally:
        ray_tpu_torch.shutdown()


def test_rejected_keys(rtpu_init):
    from ray_tpu_torch._private.runtime_env import validate
    with pytest.raises(ValueError):
        validate({"conda": "env.yml"})
    with pytest.raises(ValueError):
        validate({"container": {"image": "x"}})
    with pytest.raises(ValueError):
        validate({"bogus_key": 1})


def test_broken_env_fails_fast(rtpu_init, tmp_path):
    """Workers that die on startup must fail the task with
    RuntimeEnvSetupError instead of pending forever (ADVICE r1 /
    reference: PopWorker failure callback, ``worker_pool.h:152``)."""
    pkg = tmp_path / "broken"
    pkg.mkdir()
    # staged working_dir becomes the worker's cwd (= sys.path[0]), so
    # this file shadows the real package and kills the worker at import
    (pkg / "ray_tpu_torch.py").write_text("raise ImportError('shadowed')\n")

    @ray_tpu_torch.remote(runtime_env={"working_dir": str(pkg)})
    def f():
        return 1

    from ray_tpu_torch.exceptions import RuntimeEnvSetupError
    with pytest.raises(RuntimeEnvSetupError):
        ray_tpu_torch.get(f.remote(), timeout=60)


def test_env_pool_eviction_no_starvation(tmp_path):
    """A pool full of idle other-env workers must evict one instead of
    starving a new env forever (ADVICE r1 #3)."""
    ray_tpu_torch.init(num_cpus=4)
    try:
        node = ray_tpu_torch._global_node

        @ray_tpu_torch.remote
        def whoami():
            return os.getpid()

        # fill the pool to _max_workers with distinct env keys
        n_fill = node._max_workers
        for i in range(n_fill):
            env = {"env_vars": {"POOL_FILL": str(i)}}
            assert ray_tpu_torch.get(
                whoami.options(runtime_env=env).remote(), timeout=60) > 0
        alive = sum(1 for w in node._workers.values()
                    if w.state != "DEAD")
        assert alive >= node._max_workers  # genuinely full

        # a fresh env must still get a worker (via idle eviction)
        out = ray_tpu_torch.get(whoami.options(
            runtime_env={"env_vars": {"POOL_FILL": "fresh"}}).remote(),
            timeout=60)
        assert out > 0
    finally:
        ray_tpu_torch.shutdown()


def test_broken_env_actor_fails_queued_calls(rtpu_init, tmp_path):
    """An actor whose workers can't start must fail its creation ref AND
    any method calls queued while it was pending — not leave them
    hanging."""
    pkg = tmp_path / "broken_actor"
    pkg.mkdir()
    (pkg / "ray_tpu_torch.py").write_text("raise ImportError('shadowed')\n")

    @ray_tpu_torch.remote(runtime_env={"working_dir": str(pkg)})
    class A:
        def ping(self):
            return "pong"

    a = A.remote()
    ref = a.ping.remote()          # queued while the actor is pending
    with pytest.raises(Exception):
        ray_tpu_torch.get(ref, timeout=60)


# ---------------------------------------------------------------- pip envs

def _make_wheel(tmp_path, name="rtpu_test_pkg", version="0.1.0",
                body="VALUE = 42\n"):
    """Hand-craft a minimal py3-none-any wheel (no network, no build
    backend) that pip can install from a path with --no-index."""
    import zipfile

    dist = f"{name}-{version}.dist-info"
    files = {
        f"{name}/__init__.py": body,
        f"{dist}/METADATA": (f"Metadata-Version: 2.1\nName: {name}\n"
                             f"Version: {version}\n"),
        f"{dist}/WHEEL": ("Wheel-Version: 1.0\nGenerator: test\n"
                          "Root-Is-Purelib: true\nTag: py3-none-any\n"),
    }
    record = "".join(f"{p},,\n" for p in files) + f"{dist}/RECORD,,\n"
    whl = tmp_path / f"{name}-{version}-py3-none-any.whl"
    with zipfile.ZipFile(whl, "w") as z:
        for path, content in files.items():
            z.writestr(path, content)
        z.writestr(f"{dist}/RECORD", record)
    return str(whl)


def test_pip_env_installs_wheel(rtpu_init, tmp_path):
    """A task with a pip runtime_env runs inside a venv where the
    requested package is importable; the default pool is unaffected."""
    whl = _make_wheel(tmp_path)

    @ray_tpu_torch.remote(runtime_env={"pip": {
        "packages": [whl], "pip_install_options": ["--no-index"]}})
    def use_pkg():
        import rtpu_test_pkg
        import sys
        return rtpu_test_pkg.VALUE, sys.prefix

    @ray_tpu_torch.remote
    def no_pkg():
        try:
            import rtpu_test_pkg  # noqa: F401
            return "leaked"
        except ImportError:
            return "isolated"

    value, prefix = ray_tpu_torch.get(use_pkg.remote(), timeout=120)
    assert value == 42
    assert "venv-" in prefix          # ran under the built venv
    assert ray_tpu_torch.get(no_pkg.remote(), timeout=60) == "isolated"


def test_pip_env_cached_across_tasks(rtpu_init, tmp_path):
    """Two tasks sharing one pip env reuse one venv (same sys.prefix)."""
    whl = _make_wheel(tmp_path)
    env = {"pip": {"packages": [whl],
                   "pip_install_options": ["--no-index"]}}

    @ray_tpu_torch.remote(runtime_env=env)
    def prefix():
        import sys
        return sys.prefix

    p1, p2 = ray_tpu_torch.get([prefix.remote(), prefix.remote()], timeout=120)
    assert p1 == p2


def test_pip_env_build_failure_raises(tmp_path):
    """An uninstallable pip spec surfaces RuntimeEnvSetupError instead of
    hanging the task."""
    ray_tpu_torch.init(num_cpus=2,
                       _system_config={"worker_startup_max_failures": 1})
    try:
        @ray_tpu_torch.remote(runtime_env={"pip": {
            "packages": ["definitely-not-a-real-package-xyz"],
            "pip_install_options": ["--no-index"]}})
        def f():
            return 1

        with pytest.raises(Exception) as ei:
            ray_tpu_torch.get(f.remote(), timeout=120)
        assert "RuntimeEnv" in type(ei.value).__name__ or \
            "runtime" in str(ei.value).lower()
    finally:
        ray_tpu_torch.shutdown()


def test_pip_env_rejects_bad_shapes(rtpu_init):
    def one():
        return 1

    # validation fires at submission, matching where the reference's
    # runtime-env parsing raises
    with pytest.raises(ValueError):
        ray_tpu_torch.remote(runtime_env={"pip": 42})(one).remote()
    with pytest.raises(ValueError):
        ray_tpu_torch.remote(runtime_env={"conda": ["x"]})(one).remote()


def test_pip_env_strict_validation(rtpu_init):
    from ray_tpu_torch._private import runtime_env as renv

    # a bare string would be char-split into bogus package names
    with pytest.raises(ValueError):
        renv.validate({"pip": {"packages": "numpy"}})
    # unknown dict keys (typos) must not silently produce an empty env
    with pytest.raises(ValueError):
        renv.validate({"pip": {"packges": ["numpy"]}})
    # canonical shapes pass
    assert renv.validate({"pip": ["numpy"]})["pip"]["packages"] == ["numpy"]


def test_pip_env_key_tracks_local_wheel(tmp_path):
    """Rebuilding a wheel at the same path must produce a different venv
    cache key (stale-venv guard)."""
    import time as _time

    from ray_tpu_torch._private import runtime_env as renv

    whl = _make_wheel(tmp_path)
    env = renv.validate({"pip": [whl]})
    k1 = renv.pip_spec(env)["key"]
    _time.sleep(0.01)
    import os as _os
    _os.utime(whl)                      # simulate a rebuild
    k2 = renv.pip_spec(env)["key"]
    assert k1 != k2
