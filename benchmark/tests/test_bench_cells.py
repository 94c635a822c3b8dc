"""Each cell rehearsed on the CPU at a tiny size: a sound run comes out
correct and loads no module of JAX or of the JAX package (compared by whole
top-level names: ray_tpu_torch begins with ray_tpu); a run with a fault
planted under the timed path comes out not correct, once for each fault
the cell can have. One-chip cells exchange nothing between chips, so that
fault does not apply."""

import json
import subprocess
import sys

import pytest

from benchmark import run as bench
from benchmark.harness import faults, spec

from .conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 977

REHEARSE = """
import json, sys
sys.path.insert(0, {root!r})
from pathlib import Path
from benchmark import run
from benchmark.harness.device import forbidden_modules
line = run.run_cell({cell!r}, {seed}, 1.0, {traced}, device="cpu",
                    root=Path({tiny!r}), bench_dir=Path({tiny!r}) / "benchmark")
print(json.dumps({{"line": line, "forbidden": forbidden_modules(sys.modules),
                  "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_sound_rehearsal_is_correct_and_loads_no_jax(cell, tiny_root):
    code = REHEARSE.format(root=str(ROOT), cell=cell, seed=SEED,
                           traced=True,
                           tiny=str(tiny_root))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert "ray_tpu_torch" in out["modules"]
    assert not {"jax", "jaxlib", "flax", "ray_tpu"} & set(out["modules"])
    line = out["line"]
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["window_s"] > 0 and "breakdown" in line


@pytest.mark.parametrize("fault", faults.TRAIN_FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_under_the_timed_path_is_not_correct(cell, fault, tiny_root):
    line = bench.run_cell(cell, SEED, 1.0, False, device="cpu", fault=fault,
                          root=tiny_root, bench_dir=tiny_root / "benchmark")
    assert not line["correct"], line["checks"]
    reported = spec.find_cell(cell, tiny_root, tiny_root / "benchmark")
    assert set(line["metrics"]) == {m["name"] for m in reported.end_to_end}
