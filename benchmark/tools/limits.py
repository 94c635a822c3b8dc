#!/usr/bin/env python3
"""A cell's limits from its readings (`readings.py`'s output files, and
runs files of `summarize.py`'s form for more program seeds).

    python3 benchmark/tools/limits.py --workload <cell> readings.json \
        [runs.jsonl ...] [--cells other,cells] [--write]

For each number: the lower reading is the largest over the program's
sound seeds; the upper is the smallest the control gives where that is
three times the lower or more, or the smallest of a fault's readings that is ten times the lower or more (a state left
unchanged reads 1 on the change and counts at three times). The limit lies
between, nearer the upper: lower^0.4 x upper^0.6. A number with no upper
reading, or read on fewer than a dozen seeds, gets no limit and is not
compared. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MIN_SEEDS = 12


def limits(program, controls, faults, min_seeds=MIN_SEEDS):
    """`program`: (seed, numbers) of each sound run; `controls`: the
    control's numbers; `faults`: each fault's numbers, by name."""
    keys = sorted({k for _, r in program for k in r})
    lower = {k: max(r[k] for _, r in program if k in r) for k in keys}
    seeds = {k: len({s for s, r in program if k in r}) for k in keys}
    out = {"limits": {}, "lower": lower, "upper": {},
           "readings": {k: sum(k in r for _, r in program) for k in keys},
           "seeds": seeds}
    for k, low in lower.items():
        if seeds[k] < min_seeds:
            continue
        got = [c[k] for c in controls if k in c]
        cands = [(min(got), "control")] if got and min(got) >= 3 * low \
            else []
        for name, rows in faults.items():
            got = [r[k] for r in rows if k in r]
            if got and min(got) >= 10 * low:
                cands.append((min(got), name))
        if k == "update_gap" and 1.0 >= 3 * low:
            cands.append((1.0, "state_unchanged"))
        if not cands:
            continue
        up, by = min(cands)
        out["upper"][k] = [up, by]
        out["limits"][k] = float(f"{low ** 0.4 * up ** 0.6:.2g}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("files", nargs="+")
    ap.add_argument("--cells", default="",
                    help="more cells whose runs' program readings count "
                    "(the same configuration and numerics)")
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args(argv)
    cells = {args.workload, *filter(None, args.cells.split(","))}
    program, controls, faults = [], [], {}
    for f in args.files:
        text = Path(f).read_text()
        if f.endswith(".jsonl"):
            for line in text.splitlines():
                r = json.loads(line)
                if r["cell"] in cells and r["line"]:
                    program.append((r["seed"],
                                    r["line"]["readings"]["numbers"]))
            continue
        d = json.loads(text)
        program += [(int(s), r) for s, r in d["program"].items()]
        for got in d["control"].values():
            controls.append(got["control"])
            for name, v in got.items():
                if name != "control":
                    faults.setdefault(name, []).append(v)
    out = limits(program, controls, faults)
    text = json.dumps(out, indent=1)
    print(text)
    if args.write:
        (ROOT / "benchmark" / "limits" / f"{args.workload}.json").write_text(
            text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
