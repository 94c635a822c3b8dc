"""Faults planted under the timed path, for the tests that show `correct`
coming out false (``tests/test_bench_faults.py``). A run of the benchmark
never plants one: only the tests pass a fault to the harness."""

from __future__ import annotations

from typing import Callable, Optional

TRAIN_FAULTS = ("state_unchanged", "half_batch")


def wrap_step(step: Callable, model, fault: Optional[str]) -> Callable:
    """The train step with `fault` planted: "state_unchanged" computes the
    loss and leaves the parameters and the optimizer's state as they were;
    "half_batch" trains on the first half of the rows (the mean over
    them)."""
    if fault is None:
        return step
    if fault == "state_unchanged":
        import torch

        def unchanged(state, batch):
            with torch.no_grad():
                _, metrics = model.loss(batch)
            metrics = dict(metrics)
            metrics["grad_norm"] = torch.zeros(())
            return state, metrics
        return unchanged
    if fault == "half_batch":
        def half(state, batch):
            rows = batch["tokens"].shape[0] // 2
            return step(state, {"tokens": batch["tokens"][:rows]})
        return half
    raise ValueError(f"unknown train fault {fault!r}")

