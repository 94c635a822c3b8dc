"""Checkpoint — directory-backed, with torch state dicts and sharded
(FSDP2 DTensor) state.

Counterpart of ``ray_tpu/train/checkpoint.py``; `from_directory`,
`from_dict`, `to_dict`, `to_directory` and the metrics file are copies.
JAX's `from_pytree`/`to_pytree` save through orbax; here
`from_state_dict`/`to_state_dict` save a (nested) dict of tensors, or a
`TrainState`, with ``torch.save`` when every tensor is a plain one, and
with ``torch.distributed.checkpoint`` (DCP) when any is a DTensor: then
each rank writes its own shards into one directory that every rank shares,
and a restore reads each rank's shards back into its own tensors in place.

A `TrainState` is saved as its parameters, its Adam moments mu and nu
(the step keeps them as local tensors; they are saved as DTensors with
their parameters' placements, so they shard like them), its step and the
optimizer's count. It is restored into a `TrainState` of the same model on
the same mesh.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
from typing import Any, Dict, Optional

_METRICS_FILE = ".rtpu_metrics.json"
_DICT_FILE = "data.pkl"
_STATE_FILE = "state.pt"      # torch.save of plain tensors
_SHARDED_DIR = "state"         # DCP: every rank's shards and the metadata


class Checkpoint:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    # ------------------------------------------------------------- creation
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any],
                  dir: Optional[str] = None) -> "Checkpoint":
        path = dir or tempfile.mkdtemp(prefix="rtpu_ckpt_")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _DICT_FILE), "wb") as f:
            pickle.dump(data, f)
        return cls(path)

    @classmethod
    def from_state_dict(cls, state: Any, dir: Optional[str] = None,
                        extra: Optional[Dict[str, Any]] = None
                        ) -> "Checkpoint":
        """Save `state`: a (nested) dict of tensors and plain values, or a
        `TrainState`. Plain tensors go through ``torch.save`` (call it on
        the rank whose state it is); DTensors through DCP, which every
        rank calls with the same `dir` (inside a train session the default
        is the session's shared directory for this report)."""
        from torch.distributed.tensor import DTensor

        sd = _as_state_dict(state)
        sharded = any(isinstance(t, DTensor) for t in _leaves(sd))
        if dir is None and sharded:
            from .session import _current
            ctx = _current()
            if ctx is None:
                raise ValueError("a sharded checkpoint outside a train "
                                 "session needs dir=, the same on every "
                                 "rank")
            dir = ctx.shared_checkpoint_dir()
        path = dir or tempfile.mkdtemp(prefix="rtpu_ckpt_")
        os.makedirs(path, exist_ok=True)
        if sharded:
            import torch.distributed.checkpoint as dcp
            dcp.save(sd, checkpoint_id=os.path.join(path, _SHARDED_DIR))
        else:
            import torch
            target = os.path.join(path, _STATE_FILE)
            torch.save(sd, target + ".tmp")
            os.replace(target + ".tmp", target)
        if extra:
            with open(os.path.join(path, _DICT_FILE), "wb") as f:
                pickle.dump(extra, f)
        return cls(path)

    # ------------------------------------------------------------- reading
    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None or os.path.abspath(path) == self.path:
            return self.path
        if os.path.exists(path):
            shutil.rmtree(path)
        shutil.copytree(self.path, path)
        return path

    def to_dict(self) -> Dict[str, Any]:
        with open(os.path.join(self.path, _DICT_FILE), "rb") as f:
            return pickle.load(f)

    @property
    def sharded(self) -> bool:
        return os.path.isdir(os.path.join(self.path, _SHARDED_DIR))

    def to_state_dict(self, template: Any = None) -> Any:
        """Restore. With no `template`, a plain checkpoint comes back as a
        dict of CPU tensors. With one (a dict of the saved structure, or a
        `TrainState`), the values are read into the template's own tensors
        in place and the template is returned: a sharded checkpoint needs
        one (every rank passes its own, on the mesh it was saved from)."""
        import torch

        if self.sharded:
            if template is None:
                raise ValueError("a sharded checkpoint restores into a "
                                 "template: pass the state to fill")
            import torch.distributed.checkpoint as dcp
            sd = _as_state_dict(template)
            with torch.no_grad():
                dcp.load(sd, checkpoint_id=os.path.join(self.path,
                                                        _SHARDED_DIR))
        else:
            saved = torch.load(os.path.join(self.path, _STATE_FILE),
                               map_location="cpu", weights_only=False)
            if template is None:
                return saved
            sd = _as_state_dict(template)
            with torch.no_grad():
                _copy_into(sd, saved)
        _fill_train_state(template, sd)
        return template

    # ------------------------------------------------------------ metadata
    def set_metrics(self, metrics: Dict[str, Any]) -> None:
        with open(os.path.join(self.path, _METRICS_FILE), "w") as f:
            json.dump(metrics, f, default=str)

    def get_metrics(self) -> Dict[str, Any]:
        p = os.path.join(self.path, _METRICS_FILE)
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    def __repr__(self):
        return f"Checkpoint({self.path})"


def _is_train_state(x: Any) -> bool:
    return all(hasattr(x, a) for a in ("params", "opt_state", "step"))


def _as_state_dict(state: Any) -> Dict[str, Any]:
    """A dict as it is; a `TrainState` as {params, mu, nu, step, count},
    whose tensors share storage with the state's (so a restore into it
    writes the state). mu and nu, local tensors beside DTensor parameters,
    become DTensors with their parameters' mesh and placements."""
    if not _is_train_state(state):
        return state
    from torch.distributed.tensor import DTensor

    def like_param(name, t):
        p = state.params[name]
        if isinstance(p, DTensor):
            return DTensor.from_local(t, p.device_mesh, p.placements,
                                      run_check=False, shape=p.shape,
                                      stride=p.stride())
        return t

    opt = state.opt_state
    return {"params": {n: p.detach() for n, p in state.params.items()},
            "mu": {n: like_param(n, t) for n, t in opt["mu"].items()},
            "nu": {n: like_param(n, t) for n, t in opt["nu"].items()},
            "step": int(state.step), "count": int(opt["count"])}


def _fill_train_state(template: Any, sd: Dict[str, Any]) -> None:
    """The plain values of a restore back into a `TrainState` (its tensors
    were written in place)."""
    if _is_train_state(template):
        template.step = int(sd["step"])
        template.opt_state["count"] = int(sd["count"])


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _copy_into(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Copy a loaded dict into `dst` in place: tensors by `copy_`, plain
    values by assignment; the structures must match."""
    import torch

    if set(dst) != set(src):
        raise KeyError(f"checkpoint keys {sorted(src)} do not match the "
                       f"template's {sorted(dst)}")
    for k, v in src.items():
        if isinstance(dst[k], dict):
            _copy_into(dst[k], v)
        elif isinstance(dst[k], torch.Tensor):
            dst[k].copy_(v)
        else:
            dst[k] = v
