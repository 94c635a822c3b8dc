"""A dry run of the port's parallel train step on CPU processes.

Counterpart of ``__graft_entry__.dryrun_multichip``: one train step of
llama_tiny on `n` gloo ranks of this machine's CPU at three meshes that
between them take every parallelism axis: tp/sp/fsdp (dp the rest), then
pp/tp (the GPipe schedule), then ep/tp with 4 experts. Each mesh prints one
line with its shape and loss, and the loss must lie in (0, 20).

    python -c "from ray_tpu_torch.parallel.dryrun import dryrun_multichip; \\
               dryrun_multichip(8)"
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time
import traceback
from typing import List

import numpy as np


def _factor_axes(n: int, axes) -> "MeshSpec":
    """2 on each of `axes` while `n` divides, dp the rest (JAX's rule)."""
    from .mesh import MeshSpec

    sizes = {a: 1 for a in ("dp", "fsdp", "tp", "sp", "pp", "ep")}
    rem = n
    for axis in axes:
        if rem % 2 == 0:
            sizes[axis] = 2
            rem //= 2
    sizes["dp"] = rem
    return MeshSpec(**sizes).resolve(n)


def _one_step(cfg, spec, batch_size: int) -> float:
    import torch

    from ..models import GPT, init_train_state, make_optimizer, make_train_step
    from .mesh import build_mesh

    mesh = build_mesh(spec, device_type="cpu")
    model = GPT(cfg, device="cpu", seed=0, mesh=mesh)
    opt = make_optimizer(total_steps=10)
    state = init_train_state(model, opt, device="cpu", mesh=mesh)
    step = make_train_step(model, opt, device="cpu", mesh=mesh)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (batch_size, 64))
    state, metrics = step(state, {"tokens": torch.from_numpy(tokens)})
    return float(metrics["loss"])


def run_meshes(n: int) -> List[str]:
    """The three meshes' steps on this rank of an initialised process group
    of `n` ranks; returns the lines it would print."""
    from ..models import llama_tiny

    batch_size = max(4, n)
    runs = [("tp/sp/fsdp", llama_tiny(), ("tp", "sp", "fsdp"))]
    if n % 2 == 0:
        runs += [("pp/tp", llama_tiny(), ("pp", "tp")),
                 ("ep/tp", llama_tiny(n_experts=4), ("ep", "tp"))]
    lines = []
    for name, cfg, axes in runs:
        spec = _factor_axes(n, axes)
        loss = _one_step(cfg, spec, batch_size)
        if not 0.0 < loss < 20.0:
            raise AssertionError(f"implausible loss {loss} at {spec}")
        shape = {a: getattr(spec, a) for a in
                 ("pp", "dp", "fsdp", "ep", "sp", "tp")}
        lines.append(f"dryrun {name}: mesh={shape} loss={loss:.4f} ok")
    return lines


def _rank_main(rank: int, n: int, workdir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(workdir, "store"), n),
            rank=rank, world_size=n)
        try:
            lines = run_meshes(n)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(workdir, f"rank{rank}.txt"), "w") as f:
            f.write("\n".join(lines))
    except BaseException:
        traceback.print_exc()
        raise SystemExit(1)


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> None:
    """One train step at each of the three meshes on `n_devices` spawned
    gloo ranks (CPU); prints rank 0's line per mesh, and raises if a rank
    fails or the run outlives `timeout` seconds."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as workdir:
        procs = [ctx.Process(target=_rank_main, args=(r, n_devices, workdir))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in procs]
        if hung or any(codes):
            raise RuntimeError(f"dryrun_multichip({n_devices}): hung ranks "
                               f"{hung}, exit codes {codes}")
        with open(os.path.join(workdir, "rank0.txt")) as f:
            for line in f.read().splitlines():
                print(line, flush=True)
