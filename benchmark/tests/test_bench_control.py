"""The control: the reference in fp8 (the precision below the bf16 the
configurations state) put in the program's place. At a tiny size on the
CPU, the control's readings have to separate from the program's: limits
set by `tools/limits.py`'s rule from both pass the program and fail the
control. At the cells' own sizes on the card (the test marked cuda, three
seeds; `tools/readings.py` runs the same), the control has to fail each
cell's committed limits."""

import json

import pytest

from benchmark import run as bench
from benchmark.harness import check, spec
from benchmark.tools import limits as limits_tool
from benchmark.tools import readings

from .conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_separates_from_the_program_at_a_tiny_size(name, tiny_root):
    cell = spec.find_cell(name, tiny_root, tiny_root / "benchmark")
    program = [(seed, bench.run_cell(name, seed, 0.0, False, device="cpu",
                                     root=tiny_root,
                                     bench_dir=tiny_root / "benchmark")
                ["readings"]["numbers"]) for seed in (2**31 + 1, 2**31 + 2)]
    got = [readings.control_train(cell, seed, "cpu")
           for seed in (2**32 + 1, 2**32 + 2)]
    controls = [g["control"] for g in got]
    faults = {k: [g[k] for g in got] for k in got[0] if k != "control"}
    lim = limits_tool.limits(program, controls, faults, min_seeds=2)
    assert "control" in [by for _, by in lim["upper"].values()], lim
    for _, numbers in program:
        assert check.passes(check.judge(numbers, lim)), (numbers, lim)
    for numbers in controls:
        assert not check.passes(check.judge(numbers, lim)), (numbers, lim)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits_at_the_cells_size(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells' sizes run on the card")
    cell = spec.find_cell(name)
    for seed in (2**32 + 11, 2**32 + 12, 2**32 + 13):
        got = readings.control_train(cell, seed, "cuda")
        assert not check.passes(check.judge(got["control"], cell.limits)), got
