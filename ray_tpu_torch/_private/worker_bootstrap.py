"""Worker bootstrap for ``pip`` runtime environments.

Spawned instead of the worker module when a task's runtime_env asks for
pip packages: builds (or reuses) a cached virtualenv, then ``exec``s the
real worker under the venv's interpreter. Runs in the worker process so
an environment build never blocks the node's dispatcher; a failed build
exits nonzero, which the node's startup-failure reaper turns into
``RuntimeEnvSetupError`` for the pending tasks (the same path a broken
``working_dir`` takes).

Reference analogue: the per-node runtime-env agent building pip/conda
envs (``python/ray/_private/runtime_env/agent/runtime_env_agent.py:281``
and ``runtime_env/pip.py``) keyed and cached by URI. The venv is created
with ``--system-site-packages`` so the image's baked-in stack (jax,
numpy, ...) stays importable — the reference's pip env inherits the base
environment the same way.
"""

from __future__ import annotations

import fcntl
import glob
import json
import os
import shutil
import site
import subprocess
import sys


def _build_venv(venv_dir: str, packages: list, options: list) -> None:
    subprocess.run(
        [sys.executable, "-m", "venv", "--system-site-packages", venv_dir],
        check=True)
    # When THIS interpreter is itself a venv (common for hermetic
    # images), the child venv's --system-site-packages exposes the BASE
    # python's site-packages, not this venv's — so the image's baked-in
    # stack (jax, cloudpickle, ...) would vanish. A .pth file appends the
    # parent's site dirs after the child's own, so pip-installed packages
    # still shadow inherited ones.
    parent_sites = [p for p in site.getsitepackages() if os.path.isdir(p)]
    for child_site in glob.glob(
            os.path.join(venv_dir, "lib", "python*", "site-packages")):
        with open(os.path.join(child_site, "_rtpu_parent_env.pth"),
                  "w") as f:
            f.write("\n".join(parent_sites) + "\n")
    venv_py = os.path.join(venv_dir, "bin", "python")
    if packages:
        subprocess.run(
            [venv_py, "-m", "pip", "install",
             "--no-warn-script-location", *options, *packages],
            check=True)


def ensure_venv(cache_dir: str, key: str, packages: list,
                options: list) -> str:
    """Build-or-reuse the venv for ``key``; returns its python path.

    Concurrent spawns of the same env serialize on a file lock; only the
    first builds. A crash mid-build leaves no ready marker, so the next
    holder wipes the partial tree and rebuilds.
    """
    os.makedirs(cache_dir, exist_ok=True)
    venv_dir = os.path.join(cache_dir, f"venv-{key}")
    marker = os.path.join(venv_dir, ".rtpu_ready")
    venv_py = os.path.join(venv_dir, "bin", "python")
    with open(os.path.join(cache_dir, f"venv-{key}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(marker):
            if os.path.isdir(venv_dir):
                shutil.rmtree(venv_dir)
            _build_venv(venv_dir, packages, options)
            with open(marker, "w") as f:
                f.write(json.dumps({"packages": packages}))
    return venv_py


def main() -> None:
    spec = json.loads(os.environ.pop("RTPU_PIP_SPEC"))
    cache_dir = os.environ.pop("RTPU_ENV_CACHE_DIR")
    try:
        venv_py = ensure_venv(cache_dir, spec["key"], spec["packages"],
                              spec.get("options", []))
    except subprocess.CalledProcessError as e:
        print(f"[rtpu] pip runtime_env build failed: {e}", file=sys.stderr)
        sys.exit(1)
    os.execv(venv_py, [venv_py, "-m", "ray_tpu_torch._private.worker",
                       *sys.argv[1:]])


if __name__ == "__main__":
    main()
