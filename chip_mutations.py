#!/usr/bin/env python3
"""Mutation check of the flash kernels on one NVIDIA GPU.

    python3 chip_mutations.py [--out results.json]

For each mutation below: copy the repository into a temporary directory,
put one deliberate fault into one kernel source there, run
``chip_smoke.py --skip-main`` in the copy and read its phase-2 lines. A
mutation is caught when the copy fails (exit 1) and the faulted kernel's
outputs break the limits. Prints, per mutation, the exit code, the failing
readings and the smallest and largest normwise relative error of the
faulted outputs over the failing cases; exits 1 if any mutation went
uncaught. The repository itself is never edited.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# name -> (source, text, replacement, outputs of the faulted kernel)
MUTATIONS = {
    # the forward drops P.V of every K/V tile that lands in ring slot 1
    "fwd_skip_pv_of_ring_slot_1": (
        "ray_tpu_torch/csrc/flash_fwd.cu",
        "wgmma_rs<COLS>(o + c * COLS / 2, pa[kc],",
        "if (s == 0) wgmma_rs<COLS>(o + c * COLS / 2, pa[kc],",
        ("out", "lse")),
    # dK/dV drops the last q-head of each GQA group (no change without GQA)
    "dkv_drop_last_head_of_group": (
        "ray_tpu_torch/csrc/flash_bwd_dkv.cu",
        "it.n_iter = p.H / p.Hk * it.n_live;",
        "it.n_iter = (p.H / p.Hk - (p.H > p.Hk)) * it.n_live;",
        ("dk", "dv")),
    # dQ drops dS K of every K/V tile that lands in ring slot 1
    "dq_skip_dsk_of_ring_slot_1": (
        "ray_tpu_torch/csrc/flash_bwd_dq.cu",
        "wgmma_rs<COLS>(dq + c * COLS / 2, sa[kc],",
        "if (s != 1) wgmma_rs<COLS>(dq + c * COLS / 2, sa[kc],",
        ("dq",)),
    # dQ keeps the scores above the causal diagonal on every tile
    "dq_causal_mask_off": (
        "ray_tpu_torch/csrc/flash_bwd_dq.cu",
        "(!p.causal || col <= row + off)",
        "(true || col <= row + off)",
        ("dq",)),
}

READING = re.compile(
    r"(\w+) max ([-\d.e+]+) of \|plain\| [-\d.e+]+, norm ([-\d.e+]+) "
    r"\(<= ([-\d.e+]+)\), atol needed ([-\d.e+]+) \(<= ([-\d.e+]+)\)")
CASE = re.compile(r"^kernels \[(.*?)\]: (.*)$")


def run_mutation(name, src, text, repl, outputs, workdir):
    copy = workdir / name
    shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
        ".git", "_build", "__pycache__"))
    path = copy / src
    code = path.read_text()
    if code.count(text) != 1:
        raise SystemExit(f"{name}: the text to mutate is not in {src} once")
    path.write_text(code.replace(text, repl))
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--skip-main"],
                          cwd=copy, capture_output=True, text=True,
                          timeout=900)
    failing = []
    for line in proc.stdout.splitlines():
        m = CASE.match(line)
        if not m:
            continue
        for r in READING.finditer(m.group(2)):
            label, norm, norm_lim = r.group(1), float(r.group(3)), \
                float(r.group(4))
            atol, atol_lim = float(r.group(5)), float(r.group(6))
            if label in outputs and (norm > norm_lim or atol > atol_lim):
                failing.append({"case": m.group(1), "output": label,
                                "norm_rel": norm, "atol_needed": atol})
    norms = [f["norm_rel"] for f in failing]
    return {"exit": proc.returncode, "caught": proc.returncode == 1
            and bool(failing), "failing": failing,
            "min_norm_rel": min(norms) if norms else None,
            "max_norm_rel": max(norms) if norms else None,
            "stderr_tail": proc.stderr.strip().splitlines()[-1:]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, spec in MUTATIONS.items():
            res = run_mutation(name, *spec, Path(tmp))
            results[name] = res
            print(f"{name}: exit {res['exit']}, caught {res['caught']}, "
                  f"{len(res['failing'])} failing readings, norm-relative "
                  f"err {res['min_norm_rel']} .. {res['max_norm_rel']}",
                  flush=True)
            for f in res["failing"]:
                print(f"  {f['output']} [{f['case']}]: norm {f['norm_rel']:.3e}"
                      f", atol needed {f['atol_needed']:.3e}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({name: {k: r[k] for k in ("exit", "caught",
                                              "min_norm_rel")}
                      for name, r in results.items()}))
    return 0 if all(r["caught"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
