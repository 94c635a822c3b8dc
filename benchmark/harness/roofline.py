"""What the per-layer metrics of the train cells share: the step's share
of the card's peak, attention's share of its roofline and the device's
idle share (the last two from a traced slice's summary). Each gives None
for a run that is not a train cell's, or where it finds nothing to read.
A cell's metrics carry its entry's suffix (".train" through the trainer,
".step" for the step called directly), each reader a file of its own."""

from __future__ import annotations

from typing import Optional

from .. import families
from . import flops


def share(run: dict, kind: str) -> Optional[float]:
    """Attention's least time (operations and bytes of the train step's
    batch, `flops.attention_work`, in bf16) over its device time, in
    percent, for the calls of `kind` ("fwd" or "bwd") in the trace; None
    where it has none."""
    tr = run.get("trace")
    if not tr or run["traffic"]["kind"] != "train":
        return None
    calls = [c for c in tr["attention"] if c["kind"] == kind]
    w = run["window"]
    if not calls or "batch" not in w:
        return None
    d = families.dims(run["config"])
    bound = len(calls) * flops.bound_s(*flops.attention_work(
        w["batch"], d.n_heads, d.n_kv_heads, w["seq"], w["seq"], d.head_dim,
        elem=2, causal=True, backward=kind == "bwd"))[0]
    device = sum(c["device_s"] for c in calls)
    return 100.0 * bound / device if device > 0 else None


def idle(run: dict) -> Optional[float]:
    """1 - (union of the device's operation intervals / the traced
    window), in percent."""
    tr = run.get("trace")
    if (not tr or run["traffic"]["kind"] != "train" or tr["window_s"] <= 0
            or tr["busy_s"] <= 0):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(run: dict) -> Optional[float]:
    """The window's tokens/s times the family's operations per token (by
    default 6 N + 12 L d S + 6 d V, S the cell's sequence length) over the
    card's dense bf16 peak, in percent."""
    if run["traffic"]["kind"] != "train":
        return None
    peak = flops.peak_flops(run["kind"])
    if peak is None:
        return None
    w = run["window"]
    d = families.dims(run["config"])
    per_token = getattr(families.module(d), "train_flops_per_token",
                        flops.train_flops_per_token)(d, w["seq"])
    return 100.0 * w["tokens_per_s"] * per_token / peak
