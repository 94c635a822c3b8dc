#!/usr/bin/env python3
"""Spreads of a cell's runs, as the bounds are set from them.

    python3 benchmark/tools/summarize.py runs.jsonl [...]

Each line of a runs file is one run: {"cell", "set", "seed", "trace",
"rc", "wall", "line"} with "line" the run's result line. For each cell and
end-to-end metric: each set's median and spread (interquartile range of
`statistics.quantiles(n=4)` over the median), the wider spread, and five
times it; the compared numbers' largest reading; the traced runs'
per-layer metrics. Not part of a benchmark run.
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(paths) -> int:
    runs = [json.loads(l) for p in paths for l in open(p) if l.strip()]
    by_cell = defaultdict(list)
    for r in runs:
        by_cell[r["cell"]].append(r)
    for cell, rs in by_cell.items():
        bad = [(r["set"], r["seed"], r["rc"]) for r in rs
               if r["rc"] != 0 or not r["line"] or not r["line"]["correct"]]
        print(f"== {cell}: {len(rs)} runs, not ok: {bad}")
        sets = defaultdict(lambda: defaultdict(list))
        for r in rs:
            if r["trace"] == 0 and r["line"]:
                for k, m in r["line"]["metrics"].items():
                    sets[k][r["set"]].append(m["value"])
        for k, per in sets.items():
            parts = []
            widest = 0.0
            for s, v in sorted(per.items()):
                sp = spread(v) if len(v) >= 2 else float("nan")
                widest = max(widest, sp)
                parts.append(f"{s}: median {statistics.median(v):.6g} "
                             f"spread {sp:.4f} {['%.6g' % x for x in v]}")
            print(f"  {k}: widest {widest:.4f}, x5 {5 * widest:.4f}; "
                  + "; ".join(parts))
        nums = defaultdict(list)
        for r in rs:
            if r["line"]:
                for k, c in r["line"]["checks"].items():
                    nums[k].append(c["value"])
                for k, v in (r["line"].get("readings", {}).get("numbers")
                             or {}).items():
                    nums["reading:" + k].append(v)
        for k, v in nums.items():
            print(f"  {k}: max {max(v):.4g} over {len(v)}")
        for r in rs:
            if r["trace"] == 1 and r["line"]:
                print(f"  traced seed {r['seed']}: "
                      + json.dumps({k: round(m["value"], 4) for k, m in
                                    r["line"]["metrics"].items()})
                      + f" device {r['line']['device']}")
        for r in rs:
            if r["line"]:
                print(f"  {r['set']} {r['seed']}: wall {r['wall']:.1f} "
                      f"phases {json.dumps(r['line'].get('phases'))}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
