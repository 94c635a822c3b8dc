#!/usr/bin/env python3
"""The program's own spans in a traced run of a train cell.

    python3 benchmark/tools/spans.py --workload <cell> --seed <n> \
        --seconds <s> [--out chiprun_out/spans.jsonl]

Runs the cell as ``benchmark/run.py --trace 1`` does, with the port's
tracing on (``RTPU_TRACING_ENABLED=1``), and prints its result line with
one more section, ``program``, read from the port's ``train::``,
``runtime::`` and ``model::`` spans (``ray_tpu_torch.util.tracing``):

- ``spans``: each program span on the loop's thread in the traced slice,
  its count and its self time (less the program spans nested in it) a
  step, in ms;
- ``idle_gaps``: the slice's largest idle gaps of the card, each named
  ``bench span>program span>op`` at its middle;
- ``runtime_ms``: the loop thread's time inside outermost ``runtime::``
  spans, a step;
- ``update_idle``, ``backward_idle``: the card's idle time while the loop
  thread is inside ``model::update`` (``model::backward``), in percent of
  the slice, as ``device_idle`` divides;
- ``trainer_setup_s`` (``train::fit``'s start to rank 0's ``train::loop``
  start), ``rendezvous_s`` (rank 0's ``train::rendezvous``),
  ``model_init_s`` (``model::init``), from the finished spans;
- ``unflagged_annotations``: program spans' ranges on the card's timeline
  that the profiler does not mark as user annotations (the harness's
  summary would count those as device work).

Not part of a benchmark run: no metric of ``BENCHMARK.json`` reads it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as bench  # noqa: E402
from benchmark.harness import device as dev  # noqa: E402
from benchmark.harness import spec, trace  # noqa: E402

PROGRAM = ("train::", "runtime::", "model::")
STEP_SPAN = trace.SPAN_PREFIX + "train.step"


def is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


def loop_thread(ops: Sequence[dict]) -> Optional[int]:
    """The thread that runs the benchmark's steps."""
    for o in ops:
        if o["name"] == STEP_SPAN:
            return o["thread"]
    return None


def self_times(spans: Sequence[dict]) -> Dict[str, List[float]]:
    """name -> [count, self seconds] of program spans of one thread: each
    span's length less that of the spans directly inside it."""
    out: Dict[str, List[float]] = {}
    open_: List[list] = []          # [end, name, self seconds so far]

    def close() -> None:
        _, name, own = open_.pop()
        out[name][1] += own

    for s in sorted(spans, key=lambda s: (s["start"], -s["end"])):
        while open_ and s["start"] >= open_[-1][0]:
            close()
        length = s["end"] - s["start"]
        if open_:
            open_[-1][2] -= length
        open_.append([s["end"], s["name"], length])
        out.setdefault(s["name"], [0, 0.0])[0] += 1
    while open_:
        close()
    return out


def outermost(spans: Sequence[dict], prefix: str) -> List[List[float]]:
    """The union of the intervals of the spans named `prefix`*."""
    return trace.union([(s["start"], s["end"]) for s in spans
                        if s["name"].startswith(prefix)])


def overlap(a: Sequence[Sequence[float]], b: Sequence[Sequence[float]]
            ) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def name_gap(ops: Sequence[dict], a: float, b: float, outside: str) -> str:
    """`bench span>program span>op` at the gap's middle (each part where
    the host was inside one)."""
    mid = (a + b) / 2
    bench_span = trace._innermost(ops, mid, True)
    program = trace._innermost([o for o in ops if is_program(o["name"])],
                               mid, False)
    op = trace._innermost([o for o in ops if not is_program(o["name"])],
                          mid, False)
    parts = [bench_span[len(trace.SPAN_PREFIX):] if bench_span else outside]
    parts += [p for p in (program, op) if p]
    return ">".join(parts)


def program_summary(kernels: Sequence[dict], ops: Sequence[dict],
                    window_s: float, steps: int, outside: str) -> dict:
    """The program spans' part of a traced slice's summary (the same
    events `trace.summarize` reads; the program spans' own ranges left out
    of `kernels`)."""
    thread = loop_thread(ops)
    mine = [o for o in ops if is_program(o["name"]) and o["thread"] == thread]
    per_step = max(steps, 1)
    merged = trace.union([(k["start"], k["end"]) for k in kernels])
    idle = (trace.gaps(merged, merged[0][0], merged[-1][1]) if merged
            else [])
    idle_merged = [list(g) for g in idle]
    top = sorted(idle, key=lambda g: g[0] - g[1])[:trace.TOP]
    out = {
        "spans": {n: [c / per_step, 1e3 * s / per_step]
                  for n, (c, s) in sorted(self_times(mine).items())},
        "idle_gaps": [[name_gap(ops, a, b, outside), b - a] for a, b in top],
        "runtime_ms": 1e3 * sum(b - a for a, b in outermost(
            mine, "runtime::")) / per_step,
    }
    if merged and window_s > 0:
        for key, name in (("update_idle", "model::update"),
                          ("backward_idle", "model::backward")):
            out[key] = 100.0 * overlap(idle_merged,
                                       outermost(mine, name)) / window_s
    return out


def setup_readings(spans: Sequence[dict]) -> dict:
    """Set-up seconds from the program's finished spans (wall clock):
    `train::fit`'s start to rank 0's `train::loop` start, rank 0's
    `train::rendezvous`, and the first `model::init`."""
    def first(name, rank=None):
        found = [s for s in spans if s["name"] == name
                 and s.get("end_time") is not None
                 and (rank is None
                      or s.get("attributes", {}).get("rank") == rank)]
        return min(found, key=lambda s: s["start_time"]) if found else None

    out = {}
    fit, loop = first("train::fit"), first("train::loop", 0)
    if fit and loop:
        out["trainer_setup_s"] = loop["start_time"] - fit["start_time"]
    rendezvous = first("train::rendezvous", 0)
    if rendezvous:
        out["rendezvous_s"] = rendezvous["end_time"] - rendezvous["start_time"]
    init = first("model::init")
    if init:
        out["model_init_s"] = init["end_time"] - init["start_time"]
    return out


def profiler_events(prof):
    """(kernels, ops, unflagged) of a profile, as `trace.Tracer.summary`
    reads them, with the program spans' ranges on the card's timeline
    also left out of the kernels; `unflagged` counts those the profiler
    did not mark as user annotations."""
    kernels, ops, unflagged = [], [], 0
    for e in prof.events():
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type.name == "CUDA":
            flagged = getattr(e, "is_user_annotation", False)
            if is_program(e.name) and not flagged:
                unflagged += 1
            if not (flagged or e.name.startswith(trace.SPAN_PREFIX)
                    or is_program(e.name)):
                kernels.append({"start": start, "end": end, "name": e.name})
        elif e.device_type.name == "CPU":
            ops.append({"start": start, "end": end, "name": e.name,
                        "thread": e.thread,
                        "kernel_s": sum(k.duration for k in e.kernels)
                        * 1e-6})
    return kernels, ops, unflagged


class SpanTracer(trace.Tracer):
    """The harness's tracer, its summary with a `program` section."""

    def summary(self) -> dict:
        out = super().summary()
        kernels, ops, unflagged = profiler_events(self.prof)
        steps = sum(1 for o in ops if o["name"] == STEP_SPAN)
        out["program"] = program_summary(kernels, ops, self.window_s, steps,
                                         self.outside)
        out["program"]["unflagged_annotations"] = unflagged
        return out


def trainer_loop(config: dict) -> None:
    """The harness's trainer loop, traced by `SpanTracer` (the gang worker
    imports this module by name)."""
    from benchmark.harness import train
    train.trace.Tracer = SpanTracer
    train.trainer_loop(config)


def _finished_spans(state_api, timeout: float = 10.0) -> List[dict]:
    """The control plane's spans once the gang worker's have arrived (a
    worker ships its spans when its task ends)."""
    deadline = time.monotonic() + timeout
    while True:
        spans = state_api.list_spans()
        if (any(s["name"] == "train::loop" for s in spans)
                or time.monotonic() > deadline):
            return spans
        time.sleep(0.2)


def run_traced(name: str, seed: int, seconds: float, device: str = "cuda",
               root: Path = ROOT, bench_dir=None) -> dict:
    """One traced run of cell `name`, the port's tracing on in this process
    and the workers it starts: its result line with `program`."""
    os.environ["RTPU_TRACING_ENABLED"] = "1"
    from benchmark.harness import train
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch.util import tracing
    CONFIG.reload()

    cell = spec.find_cell(name, root, bench_dir)
    body = {"config": cell.config, "traffic": cell.traffic}
    if cell.traffic["entry"] == "step":
        train.trace.Tracer = SpanTracer
        tracing.drain()
        out = train.run(body, seed, seconds, True, device=device)
        out["counters"] = {}
        spans = tracing.drain()
    else:
        import ray_tpu_torch as rt
        from ray_tpu_torch.parallel import MeshSpec
        from ray_tpu_torch.state import api as state_api
        from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

        use_gpu = device != "cpu"
        storage = tempfile.mkdtemp(prefix="bench_spans_")
        rt.init(num_cpus=2, num_gpus=cell.chips if use_gpu else 0)
        try:
            fit_wall = time.time()
            result = TorchTrainer(
                trainer_loop,
                train_loop_config={"cell": body, "seed": seed,
                                   "seconds": seconds, "traced": True,
                                   "device": device},
                scaling_config=ScalingConfig(num_workers=1, use_gpu=use_gpu,
                                             mesh=MeshSpec(dp=1, fsdp=1)),
                run_config=RunConfig(name="bench", storage_path=storage)
            ).fit()
            if result.error is not None:
                raise RuntimeError(f"the trainer failed: {result.error!r}")
            out = result.metrics_history[-1]["result"]
            spans = _finished_spans(state_api)
        finally:
            rt.shutdown()
            shutil.rmtree(storage, ignore_errors=True)
        out["counters"] = {"trainer_ready_s": out["first_step_wall"]
                           - fit_wall}
    line = bench.result_line(cell, out, True)
    program = dict(out["trace"].get("program", {}))
    program.update(setup_readings(spans))
    program["traced_steps"] = out["trace"]["steps"]
    program["traced_window_s"] = out["trace"]["window_s"]
    line["program"] = program
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="append the line to this file too")
    args = ap.parse_args(argv)
    dev.keep_jax_out()
    dev.cache_dirs(ROOT)
    cell = spec.find_cell(args.workload)
    dev.card_or_exit(cell.chips)
    print(f"{args.workload}: seed {args.seed}, {args.seconds} s, program "
          f"spans on; {dev.power_line()}", file=sys.stderr, flush=True)
    line = run_traced(args.workload, args.seed, args.seconds)
    line["power"] = dev.power_line()
    text = json.dumps(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
