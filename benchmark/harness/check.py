"""How `correct` is decided: the numbers that the program's outputs give
against the plain reference, each held to its limit (``limits/<cell>.json``,
set in PERF.md from the readings of sound runs and of the control).

Training: the reference follows the first `check_steps` steps of the same
weights and rows. The numbers: the relative gap of each step's loss (the
widest, and the first step's alone); by the
worst leaf, the gap between the program's and the reference's norm of the
first gradient the optimizer took in, and of each leaf's change after the
check steps, each against the reference's norm of that leaf or of the
median leaf, whichever is larger. Leaves whose reference gradient is under
a thousandth of the median leaf's move by round-off alone under Adam and
are left out of the change.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

import torch

from ..reference import family
from ..reference.common import (F32, AdamW, Dims, Precision, exact_f32,
                                train_steps)
from . import weights

TRAIN_NUMBERS = ("loss_gap", "loss1_gap", "grad_gap", "update_gap")
QUIET_LEAF = 1e-3       # of the median leaf's gradient norm


def rows_per_block(d: Dims) -> int:
    """Rows the reference runs together: about 4096 positions."""
    return max(1, 4096 // d.seq_len)


def reference_train(d: Dims, seed: int, batch: int, steps: int, opt: dict,
                    device, prec: Precision = F32, rows: slice = slice(None)
                    ) -> dict:
    """The reference's losses, first clipped gradient norms and changes
    over the check steps; `rows` keeps part of every batch (a fault)."""
    with exact_f32():
        params = weights.draw_all(d, seed, device)
        batches = [weights.train_rows(d, seed, t, batch, device)[rows]
                   for t in range(steps)]
        out = train_steps(family(d.family), d, params, batches,
                          AdamW.from_traffic(opt), prec, rows_per_block(d))
        change = {}
        with torch.no_grad():
            for group in weights.draw_groups(d, seed, device):
                for name, w in group.items():
                    change[name] = float((params[name] - w).norm())
        out["change_norms"] = change
        del params
    return out


def _gap(a: float, b: float, scale: float) -> float:
    return abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """`prog` and `ref` each hold "losses", "grad_norms" and
    "change_norms" (leaf -> norm)."""
    gaps = [_gap(p, r, abs(r)) for p, r in zip(prog["losses"],
                                                ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        gaps = [math.inf]
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad_gap = max(_gap(prog["grad_norms"][n], g, max(g, g_med))
                   for n, g in g_ref.items())
    moving = [n for n, g in g_ref.items() if g >= QUIET_LEAF * g_med]
    c_ref = ref["change_norms"]
    c_med = statistics.median(c_ref[n] for n in moving)
    update_gap = max(_gap(prog["change_norms"][n], c_ref[n],
                          max(c_ref[n], c_med)) for n in moving)
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0],
            "grad_gap": grad_gap, "update_gap": update_gap}


def judge(numbers: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for every number the cell compares (those
    its limits file gives a limit)."""
    lim = limits.get("limits", {})
    return {n: {"value": numbers.get(n, math.inf), "limit": v}
            for n, v in lim.items()}


def passes(checks: Dict[str, dict]) -> bool:
    return bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
