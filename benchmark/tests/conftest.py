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

BENCH = ROOT / "benchmark"
TINY = {
    "mistral": dict(hidden_size=64, intermediate_size=160,
                    num_attention_heads=4, num_key_value_heads=2,
                    num_hidden_layers=2, vocab_size=256, sliding_window=64),
    "gpt2": dict(n_embd=64, n_head=2, n_layer=2, n_positions=128,
                 vocab_size=320),
}
TINY_ASSUMED = {"mistral": dict(seq_len=64, train_batch=4,
                                token_ids_below=256),
                "gpt2": dict(seq_len=64, train_batch=4,
                             token_ids_below=300)}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips itself without one)")


def make_tiny(dst: Path) -> Path:
    """A checkout-like directory holding BENCHMARK.json and the benchmark's
    data files, every configuration cut to a CPU-sized model."""
    bd = dst / "benchmark"
    for sub in ("traffic", "metrics", "limits"):
        shutil.copytree(BENCH / sub, bd / sub)
    (bd / "configs").mkdir(parents=True)
    for path in (BENCH / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c.update(TINY[c["model_type"]])
        c["assumed"].update(TINY_ASSUMED[c["model_type"]])
        (bd / "configs" / path.name).write_text(json.dumps(c))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("tiny"))
