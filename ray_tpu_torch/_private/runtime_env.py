"""Runtime environments: per-task/actor worker environments.

Reference: ``python/ray/_private/runtime_env/`` — envs are built by a
per-node agent, URI-cached, and the raylet's WorkerPool keys workers by
(language, runtime env) so tasks only run on workers built for their
env (``worker_pool.h:152``). Same design here, minus the network-bound
builders: ``env_vars``, ``working_dir`` and ``py_modules`` are staged
locally and baked into the worker at spawn; ``pip`` builds a cached
virtualenv the worker is exec'd into (``worker_bootstrap.py``);
``conda``/``container`` are rejected up-front (building those needs
infrastructure a hermetic image doesn't carry).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

_SUPPORTED = {"env_vars", "working_dir", "py_modules", "pip"}
_REJECTED = {"conda", "container", "uv"}


def validate(runtime_env: Optional[Dict[str, Any]]) -> Optional[dict]:
    if not runtime_env:
        return None
    unknown = set(runtime_env) - _SUPPORTED - _REJECTED
    if unknown:
        raise ValueError(f"unknown runtime_env keys: {sorted(unknown)}")
    bad = set(runtime_env) & _REJECTED
    if bad:
        raise ValueError(
            f"runtime_env keys {sorted(bad)} need network-built "
            "environments, which this runtime does not support; ship a "
            "hermetic image and use env_vars/working_dir/py_modules/pip")
    env = dict(runtime_env)
    if "pip" in env:
        env["pip"] = _normalize_pip(env["pip"])
    if "env_vars" in env:
        env["env_vars"] = {str(k): str(v)
                           for k, v in env["env_vars"].items()}
    if "working_dir" in env:
        wd = os.path.abspath(env["working_dir"])
        if not os.path.isdir(wd):
            raise ValueError(f"working_dir {wd} is not a directory")
        env["working_dir"] = wd
    if "py_modules" in env:
        env["py_modules"] = [os.path.abspath(p)
                             for p in env["py_modules"]]
    return env


def _normalize_pip(pip: Any) -> dict:
    """Canonical form: {"packages": [...], "options": [...]}.

    Accepts the reference's shapes — a plain list of requirement
    specifiers, or a dict with ``packages`` (+ optional
    ``pip_install_options``, e.g. ``["--no-index"]`` for offline
    wheel-path installs).
    """
    if isinstance(pip, (list, tuple)):
        pip = {"packages": list(pip)}
    elif isinstance(pip, dict):
        unknown = set(pip) - {"packages", "pip_install_options", "options"}
        if unknown:
            raise ValueError(
                f"unknown pip keys: {sorted(unknown)} (supported: "
                f"packages, pip_install_options)")
        pkgs = pip.get("packages", [])
        opts = pip.get("pip_install_options", ()) or pip.get("options", ())
        if isinstance(pkgs, str) or isinstance(opts, str):
            raise ValueError(
                "pip packages/options must be lists of strings, not a "
                "bare string (a string would be split per character)")
        pip = {"packages": list(pkgs), "options": list(opts)}
    else:
        raise ValueError(f"pip must be a list or dict, got {type(pip)}")
    pip.setdefault("options", [])
    for item in pip["packages"] + pip["options"]:
        if not isinstance(item, str):
            raise ValueError(f"pip entries must be strings, got {item!r}")
    return pip


def pip_spec(runtime_env: Optional[dict]) -> Optional[dict]:
    """The bootstrap payload for a pip env: packages, options, and the
    cache key the venv directory is named by.

    Packages that are local paths (wheels/sdists) contribute their
    mtime+size to the key, so rebuilding a wheel at the same path gets a
    fresh venv — the same reason working_dir staging keys on tree mtime.
    """
    if not runtime_env or "pip" not in runtime_env:
        return None
    pip = runtime_env["pip"]
    local_state = []
    for pkg in pip["packages"]:
        path = pkg.split("#", 1)[0].removeprefix("file://")
        if os.path.exists(path):
            st = os.stat(path)
            local_state.append((pkg, st.st_mtime, st.st_size))
    return {"key": env_key({"pip": pip, "local": local_state}),
            "packages": pip["packages"], "options": pip["options"]}


def env_key(runtime_env: Optional[dict]) -> str:
    """Stable hash keying the worker pool (reference: runtime-env URI)."""
    if not runtime_env:
        return ""
    return hashlib.sha256(
        json.dumps(runtime_env, sort_keys=True).encode()).hexdigest()[:16]


def stage(runtime_env: Optional[dict], session_dir: str
          ) -> Tuple[Dict[str, str], Optional[str]]:
    """Prepare a worker spawn environment: returns (env_overrides, cwd).

    working_dir is snapshotted into the session dir (so later edits to
    the source tree don't leak into running workers — the reference
    zips to GCS for the same reason) and cached by content key.
    """
    if not runtime_env:
        return {}, None
    overrides: Dict[str, str] = dict(runtime_env.get("env_vars", {}))
    cwd = None
    py_paths = []
    wd = runtime_env.get("working_dir")
    if wd:
        key = env_key({"working_dir": wd,
                       "mtime": _tree_mtime(wd)})
        target = os.path.join(session_dir, "runtime_envs", key)
        if not os.path.isdir(target):
            os.makedirs(os.path.dirname(target), exist_ok=True)
            tmp = target + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            shutil.copytree(wd, tmp)
            os.replace(tmp, target)
        cwd = target
        py_paths.append(target)
    for mod in runtime_env.get("py_modules", ()):
        py_paths.append(mod if os.path.isdir(mod)
                        else os.path.dirname(mod))
    if py_paths:
        existing = overrides.get("PYTHONPATH",
                                 os.environ.get("PYTHONPATH", ""))
        overrides["PYTHONPATH"] = os.pathsep.join(
            py_paths + ([existing] if existing else []))
    return overrides, cwd


def _tree_mtime(path: str) -> float:
    latest = os.path.getmtime(path)
    for root, _, files in os.walk(path):
        for f in files:
            try:
                latest = max(latest,
                             os.path.getmtime(os.path.join(root, f)))
            except OSError:
                pass
    return latest
