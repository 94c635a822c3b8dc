#!/usr/bin/env python3
"""The train batch a configuration's cells run at, found once on the card:
the largest of `--batches`, tried in order, whose train step leaves
FREE_AT_PEAK_GB of the card free at its peak (reserved memory), on the
trainer's path (a one-rank NCCL mesh, FSDP2) or without a mesh.

    python3 benchmark/tools/find_batch.py --config mistral_7b_d8 \
        --batches 4,6,8,10 [--mesh 1]

The chosen batch is written by hand into the configuration's
``assumed.train_batch``. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.families import dims  # noqa: E402
from benchmark.harness import program, spec, weights  # noqa: E402

FREE_AT_PEAK_GB = 8


def main(argv=None) -> int:
    import torch
    import torch.distributed as dist

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--batches", required=True)
    ap.add_argument("--mesh", type=int, default=1)
    args = ap.parse_args(argv)
    config = spec.load_json(spec.HERE / "configs" / f"{args.config}.json")
    d = dims(config)
    opt = spec.load_json(spec.HERE / "traffic" / "train_fill.json")[
        "optimizer"]
    mesh = None
    if args.mesh:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1,
                                device_id=torch.device("cuda", 0))
        mesh = program.mesh_for("trainer", "cuda")
    from ray_tpu_torch.models import init_train_state, make_train_step
    model = program.build_model(d, 1, "cuda", mesh)
    optim = program.optimizer(opt)
    state = init_train_state(model, optim, mesh=mesh)
    step = make_train_step(model, optim, mesh=mesh)
    total = torch.cuda.mem_get_info()[1]
    chosen, tried = None, []
    for b in (int(x) for x in args.batches.split(",")):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            for t in range(2):
                t0 = time.perf_counter()
                state, m = step(state, {"tokens": weights.train_rows(
                    d, 1, t, b, "cuda")})
                loss = float(m["loss"])
                ms = (time.perf_counter() - t0) * 1e3
        except torch.cuda.OutOfMemoryError:
            tried.append({"batch": b, "oom": True})
            break
        free = (total - torch.cuda.max_memory_reserved()) / 1e9
        tried.append({"batch": b, "free_at_peak_gb": free,
                      "peak_allocated_gb":
                          torch.cuda.max_memory_allocated() / 1e9,
                      "second_step_ms": ms, "loss": loss,
                      "tokens_per_s": b * d.seq_len / ms * 1e3})
        print(json.dumps(tried[-1]), flush=True)
        if free < FREE_AT_PEAK_GB:
            break
        chosen = b
    print(json.dumps({"config": args.config, "mesh": bool(args.mesh),
                      "chosen": chosen, "tried": tried}), flush=True)
    if mesh is not None:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
