"""The benchmark's CPU tests: each cell at a tiny size (`tiny_root`), its
files copied from the benchmark with the configurations' sizes cut."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.families import module  # noqa: E402

BENCH = ROOT / "benchmark"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips itself without one)")


def tiny_config(c: dict) -> dict:
    """Configuration `c` cut to its family's CPU size (the family module's
    ``TINY`` and ``TINY_ASSUMED``)."""
    family = module(c)
    c = {**c, **family.TINY}
    c["assumed"] = {**c["assumed"], **family.TINY_ASSUMED}
    return c


def make_tiny(dst: Path) -> Path:
    """A checkout-like directory holding BENCHMARK.json and the benchmark's
    data files, every configuration cut to a CPU-sized model."""
    bd = dst / "benchmark"
    for sub in ("traffic", "metrics", "limits"):
        shutil.copytree(BENCH / sub, bd / sub)
    (bd / "configs").mkdir(parents=True)
    for path in (BENCH / "configs").glob("*.json"):
        c = tiny_config(json.loads(path.read_text()))
        (bd / "configs" / path.name).write_text(json.dumps(c))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("tiny"))
