#!/usr/bin/env python3
"""The readings that a cell's limits are set from (PERF.md): the program's
compared numbers on many seeds, and the control's and the faults'.

    python3 benchmark/tools/readings.py --workload <cell> \
        --seeds 11,12,... --control-seeds 21,22,23 \
        [--out readings.<cell>.json]

Program: a run of the cell per seed, with no window: the readings come
from the check steps. Control: the reference in fp8 (each product's
operands rounded to float8 e4m3) in the program's place, against the
float32 reference, on the same inputs. Fault: the reference trained on
half of every batch. A state left unchanged reads 1 by the
change's measure and needs no run. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as bench  # noqa: E402
from benchmark.families import dims  # noqa: E402
from benchmark.harness import check, spec  # noqa: E402
from benchmark.reference.common import Precision  # noqa: E402


def control_train(cell: spec.Cell, seed: int, device: str) -> dict:
    d = dims(cell.config)
    batch = cell.assumed["train_batch"]
    steps = cell.traffic["check_steps"]
    opt = cell.traffic["optimizer"]
    ref = check.reference_train(d, seed, batch, steps, opt, device)
    fp8 = check.reference_train(d, seed, batch, steps, opt, device,
                                prec=Precision("fp8"))
    half = check.reference_train(d, seed, batch, steps, opt, device,
                                 rows=slice(0, batch // 2))
    return {"control": check.train_numbers(fp8, ref),
            "half_batch": check.train_numbers(half, ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = Path(args.root)
    cell = spec.find_cell(args.workload, root, root / "benchmark")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = {"workload": args.workload, "program": {}, "control": {}}
    for seed in seeds:
        t0 = time.perf_counter()
        line = bench.run_cell(args.workload, seed, 0.0, False,
                              device=args.device, root=root,
                              bench_dir=root / "benchmark")
        out["program"][seed] = line["readings"]["numbers"]
        print(f"program seed {seed}: {out['program'][seed]} "
              f"({time.perf_counter() - t0:.1f} s; memory "
              f"{line['device']['memory_peak_bytes']})", flush=True)
    for seed in controls:
        t0 = time.perf_counter()
        out["control"][seed] = control_train(cell, seed, args.device)
        print(f"control seed {seed}: {out['control'][seed]} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    text = json.dumps(out, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
