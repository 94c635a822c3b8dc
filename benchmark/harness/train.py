"""A train cell's work in the process that holds the card: through
`TorchTrainer` (entry "trainer": this is the gang worker's loop) or called
directly (entry "step").

Set-up builds one train step, with the port's model holding the seed's
weights and its optimizer state, and drives it through the check steps
on rows that all differ: those steps are the warm-up, and the reference
follows them once the window has closed. The same step object then runs
the window: as many steps as fit in `seconds`, each on new rows, each
ending in the host's read of its loss (and, through the trainer, a
`train.report`). The rate is all the window's tokens over the host-clock
time from the first window step's start to the `synchronize` after the
last. A traced run then profiles `trace_seconds` more steps. Then the peak
memory is read, the program's state freed, and the reference run.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Callable, Optional

from ..families import dims
from . import check, faults, program, trace, weights
from .device import forbidden_modules


def run(cell: dict, seed: int, seconds: float, traced: bool,
        device: str = "cuda", fault: Optional[str] = None,
        report: Optional[Callable[[dict], None]] = None) -> dict:
    """`cell` holds "config" and "traffic"; returns the window's
    readings, the check's numbers (program and reference side) and, when
    `traced`, the trace's summary."""
    import torch

    d = dims(cell["config"])
    traffic = cell["traffic"]
    batch = cell["config"]["assumed"]["train_batch"]
    opt = traffic["optimizer"]
    mesh = program.mesh_for(traffic["entry"], torch.device(device).type)
    model = program.build_model(d, seed, device, mesh)
    from ray_tpu_torch.models import init_train_state, make_train_step
    optim = program.optimizer(opt)
    state = init_train_state(model, optim, device=device, mesh=mesh)
    step = faults.wrap_step(make_train_step(model, optim, device=device,
                                            mesh=mesh), model, fault)
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)

    def one(t: int) -> float:
        nonlocal state
        with trace.span("train.batch"):
            tokens = weights.train_rows(d, seed, t, batch, device)
        with trace.span("train.step"):
            state, m = step(state, {"tokens": tokens})
            loss = float(m["loss"])
        if report is not None:
            with trace.span("train.report"):
                report({"step": t, "loss": loss})
        return loss

    prog = {"losses": []}
    first_step_wall = time.time()
    for t in range(traffic["check_steps"]):
        prog["losses"].append(one(t))
        if t == 0:
            prog["grad_norms"] = program.first_grad_norms(state, opt["b1"])
    prog["change_norms"] = program.change_norms(model, d, seed, device)
    gc.collect()
    sync()

    t = traffic["check_steps"]
    n, window_losses = 0, []
    window_start_wall = time.time()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        window_losses.append(one(t))
        t, n = t + 1, n + 1
    sync()
    window_s = time.perf_counter() - t0
    tokens = n * batch * d.seq_len
    out = {"steps": n, "tokens": tokens, "window_s": window_s,
           "tokens_per_s": tokens / window_s, "batch": batch,
           "seq": d.seq_len, "window_losses": window_losses[-3:],
           "finite": all(map(math.isfinite, window_losses + prog["losses"])),
           "first_step_wall": first_step_wall,
           "window_start_wall": window_start_wall}

    if traced:
        with trace.Tracer("train.loop", cuda=device != "cpu") as tracer:
            t1, k = time.perf_counter(), 0
            while k == 0 or (time.perf_counter() - t1
                             < traffic["trace_seconds"]):
                one(t)
                t, k = t + 1, k + 1
        out["trace"] = tracer.summary()
        out["trace"]["steps"] = k
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if device != "cpu" else 0)
    out["kind"] = (torch.cuda.get_device_name(0) if device != "cpu"
                   else "cpu")

    del model, state, step
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = check.reference_train(d, seed, batch, traffic["check_steps"], opt,
                                device)
    out["reference_s"] = time.perf_counter() - t_ref
    out["numbers"] = check.train_numbers(prog, ref)
    out["losses"] = {"program": prog["losses"], "reference": ref["losses"]}
    out["forbidden_modules"] = forbidden_modules(sys.modules)
    return out


def trainer_loop(config: dict) -> None:
    """``train_loop_per_worker`` of the trainer's entry: `run` in the gang
    worker, each step reported through `train.report`, the result last."""
    from ray_tpu_torch import train

    out = run(config["cell"], config["seed"], config["seconds"],
              config["traced"], device=config["device"],
              fault=config.get("fault"), report=train.report)
    train.report({"result": out})
