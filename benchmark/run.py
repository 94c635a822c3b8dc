#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card(s) of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Cells, configurations, traffic mixes and per-layer metrics are read by name
from ``BENCHMARK.json`` and the files under ``benchmark/`` (README.md).
Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last: each number compared with its limit,
also printed as the last lines of standard error. Exits non-zero with no
result line when the machine lacks the cell's cards, or when JAX or the
JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import device as dev  # noqa: E402
from benchmark.harness import spec  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_train(cell: spec.Cell, seed: int, seconds: float, traced: bool,
              device: str, fault) -> dict:
    from benchmark.harness import train

    body = {"config": cell.config, "traffic": cell.traffic}
    if cell.traffic["entry"] == "step":
        out = train.run(body, seed, seconds, traced, device=device,
                        fault=fault)
        out["counters"] = {}
        return out
    import ray_tpu_torch as rt
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    use_gpu = device != "cpu"
    storage = tempfile.mkdtemp(prefix="bench_train_")
    rt.init(num_cpus=2, num_gpus=cell.chips if use_gpu else 0)
    try:
        fit_wall = time.time()
        trainer = TorchTrainer(
            train.trainer_loop,
            train_loop_config={"cell": body, "seed": seed,
                               "seconds": seconds, "traced": traced,
                               "device": device, "fault": fault},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=use_gpu,
                                         mesh=MeshSpec(dp=1, fsdp=1)),
            run_config=RunConfig(name="bench", storage_path=storage))
        result = trainer.fit()
        if result.error is not None:
            raise RuntimeError(f"the trainer failed: {result.error!r}")
        out = result.metrics_history[-1]["result"]
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    out["counters"] = {"trainer_ready_s": out["first_step_wall"] - fit_wall}
    return out


def result_line(cell: spec.Cell, out: dict, traced: bool) -> dict:
    from benchmark.harness import check

    setup_s = out["window_start_wall"] - PROCESS_START
    if traced:
        run = {"cell": cell.name, "config": cell.config,
               "traffic": cell.traffic, "kind": out["kind"],
               "window": out, "trace": out.get("trace"),
               "counters": out.get("counters", {})}
        metrics = spec.read_metrics(cell, run)
    else:
        # the set-up, and the window's rate under the name the cell reports
        # it by (train_tokens_per_s through the trainer, step_tokens_per_s
        # for the step called directly)
        metrics = {m["name"]: {"value": setup_s if m["name"] == "setup_s"
                               else out["tokens_per_s"], "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = check.judge(out["numbers"], cell.limits)
    line = {
        "correct": bool(out["finite"] and check.passes(checks)),
        "attempted": out["steps"],
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu", "kind": out["kind"],
                   "count": cell.chips,
                   "memory_peak_bytes": int(out["memory_peak_bytes"])},
    }
    if traced and out.get("trace"):
        tr = out["trace"]
        line["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["phases"] = {"setup_s": setup_s, "window_s": out["window_s"],
                      "reference_s": out["reference_s"]}
    line["readings"] = {"numbers": out["numbers"],
                        "losses": out.get("losses")}
    line["checks"] = checks
    return line


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", fault=None, root: Path = ROOT,
             bench_dir=None) -> dict:
    """One run of cell `name`; returns its result line. `device` "cpu" and
    `fault` are for the tests, which run a cell at a tiny size."""
    cell = spec.find_cell(name, root, bench_dir)
    out = run_train(cell, seed, seconds, traced, device, fault)
    found = sorted(set(dev.forbidden_modules(sys.modules))
                   | set(out.get("forbidden_modules", [])))
    if found:
        raise SystemExit(f"JAX or the JAX package was loaded: {found}")
    return result_line(cell, out, traced)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    dev.keep_jax_out()
    dev.cache_dirs(ROOT)
    cell = spec.find_cell(args.workload)
    dev.card_or_exit(cell.chips)
    log(f"{args.workload}: seed {args.seed}, {args.seconds} s, trace "
        f"{args.trace}; {dev.power_line()}")
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
