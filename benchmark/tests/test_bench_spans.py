"""The program spans' readings (`tools/spans.py`) on made-up events, the
PR 20 readings unmoved by the program's spans, and each cell's traced run
with the port's tracing on, at a tiny size on the CPU."""

import json
import math
import subprocess
import sys
from types import SimpleNamespace

import pytest

from benchmark.harness import trace
from benchmark.tools import spans as tool

from .conftest import ROOT
from .test_bench_cells import CELLS, SEED


def op(name, start, end, thread=1, kernel_s=0.0):
    return {"name": name, "start": start, "end": end, "thread": thread,
            "kernel_s": kernel_s}


# one step on thread 1 (its train loop), 0-10 s: forward 0-3, backward
# 3-7, update 7-9 with a get of 8-8.5 inside, then the report 9-10 whose
# submit and get leave the card idle; thread 2 (the autograd engine's)
# runs the backward's ops
KERNELS = [{"start": 0.0, "end": 6.0, "name": "k1"},
           {"start": 6.5, "end": 7.5, "name": "k2"},
           {"start": 8.0, "end": 9.2, "name": "k3"},
           {"start": 10.0, "end": 10.5, "name": "k4"}]
OPS = [op("bench.train.step", 0.0, 9.0),
       op("model::forward", 0.0, 3.0),
       op("model::backward", 3.0, 7.0),
       op("aten::mm", 6.0, 6.9, thread=2),
       op("model::update", 7.0, 9.0),
       op("runtime::get", 8.0, 8.5),
       op("bench.train.report", 9.0, 10.0),
       op("train::report", 9.0, 10.0),
       op("runtime::submit", 9.1, 9.3),
       op("runtime::get", 9.3, 9.9),
       op("cudaStreamSynchronize", 9.4, 9.9)]


def test_self_times_take_out_the_nested_spans():
    mine = [o for o in OPS if tool.is_program(o["name"])]
    st = tool.self_times(mine)
    assert st["model::update"] == [1, pytest.approx(1.5)]
    assert st["runtime::get"] == [2, pytest.approx(1.1)]
    assert st["train::report"] == [1, pytest.approx(0.2)]
    assert st["model::backward"] == [1, pytest.approx(4.0)]


def test_program_summary_reads_its_defined_values():
    s = tool.program_summary(KERNELS, OPS, window_s=10.0, steps=1,
                             outside="train.loop")
    # idle: 6.0-6.5 (backward), 7.5-8.0 (update), 9.2-10.0 (report)
    assert s["backward_idle"] == pytest.approx(100 * 0.5 / 10)
    assert s["update_idle"] == pytest.approx(100 * 0.5 / 10)
    assert s["runtime_ms"] == pytest.approx(1e3 * (0.5 + 0.2 + 0.6))
    assert s["spans"]["model::forward"] == [1, pytest.approx(3e3)]
    names = dict(s["idle_gaps"])
    assert names == {
        "train.report>runtime::get>cudaStreamSynchronize": pytest.approx(0.8),
        "train.step>model::backward>aten::mm": pytest.approx(0.5),
        "train.step>model::update": pytest.approx(0.5)}
    # idle inside the update and the backward is part of the idle share
    idle = 100 * (1 - sum(b - a for a, b in trace.union(
        [(k["start"], k["end"]) for k in KERNELS])) / 10.0)
    assert s["update_idle"] + s["backward_idle"] <= idle


def test_pr20_summary_is_the_same_with_program_spans():
    """The host's program spans change no reading of `trace.summarize`
    but the names of the gaps they hold."""
    bare = [o for o in OPS if not tool.is_program(o["name"])]
    a = trace.summarize(KERNELS, bare, 10.0, "train.loop")
    b = trace.summarize(KERNELS, OPS, 10.0, "train.loop")
    for key in ("busy_s", "window_s", "device_ops", "attention"):
        assert a[key] == b[key], key
    assert [w for _, w in a["idle_gaps"]] == [w for _, w in b["idle_gaps"]]


def _event(name, start_us, end_us, device, thread=1, flagged=None):
    e = SimpleNamespace(name=name, thread=thread, kernels=[],
                        time_range=SimpleNamespace(start=start_us,
                                                   end=end_us),
                        device_type=SimpleNamespace(name=device))
    if flagged is not None:
        e.is_user_annotation = flagged
    return e


def _tracer(events):
    t = trace.Tracer("train.loop", cuda=False)
    t.prof = SimpleNamespace(events=lambda: events)
    t.window_s = 1.0
    return t


DEVICE = [_event("k1", 0, 400_000, "CUDA"),
          _event("k2", 600_000, 900_000, "CUDA"),
          _event("bench.train.step", 0, 900_000, "CUDA", flagged=True),
          _event("bench.train.step", 0, 950_000, "CPU")]


def test_pr20_readings_ignore_flagged_program_annotations():
    program = [_event("model::update", 350_000, 950_000, "CUDA",
                      flagged=True),
               _event("model::update", 300_000, 950_000, "CPU")]
    a, b = _tracer(DEVICE).summary(), _tracer(DEVICE + program).summary()
    for key in ("busy_s", "device_ops", "attention"):
        assert a[key] == b[key], key


def test_tool_leaves_out_every_program_annotation():
    """Also one the profiler does not mark as a user annotation, which it
    counts."""
    unflagged = _event("model::update", 350_000, 950_000, "CUDA")
    kernels, _, n = tool.profiler_events(
        SimpleNamespace(events=lambda: DEVICE + [unflagged]))
    assert [k["name"] for k in kernels] == ["k1", "k2"]
    assert n == 1


def test_setup_readings_from_finished_spans():
    def span(name, t0, t1, **attributes):
        return {"name": name, "start_time": t0, "end_time": t1,
                "attributes": attributes}

    spans = [span("train::fit", 100.0, 200.0),
             span("train::rendezvous", 110.0, 112.5, rank=0),
             span("train::loop", 113.0, 190.0, rank=0),
             span("model::init", 114.0, 115.25),
             span("model::init", 150.0, 160.0)]
    assert tool.setup_readings(spans) == {
        "trainer_setup_s": 13.0, "rendezvous_s": 2.5, "model_init_s": 1.25}
    assert tool.setup_readings([]) == {}


RUN = """
import json, sys
sys.path.insert(0, {root!r})
from pathlib import Path
from benchmark.tools import spans
line = spans.run_traced({cell!r}, {seed}, 1.0, device="cpu",
                        root=Path({tiny!r}),
                        bench_dir=Path({tiny!r}) / "benchmark")
print(json.dumps(line))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_program_readings(cell, tiny_root):
    code = RUN.format(root=str(ROOT), cell=cell, seed=SEED,
                      tiny=str(tiny_root))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    program = line["program"]
    assert math.isfinite(program["model_init_s"]) \
        and program["model_init_s"] > 0
    per_step = program["spans"]
    for name in ("model::forward", "model::backward", "model::update"):
        assert per_step[name][0] == pytest.approx(1.0), per_step
    if cell.endswith(".train"):
        ready = line["metrics"]["trainer_ready_s"]["value"]
        assert 0 < program["rendezvous_s"] <= program["trainer_setup_s"] \
            <= ready
        assert per_step["train::report"][0] == pytest.approx(1.0)
        assert program["runtime_ms"] > 0
