"""A model family supplies what the dense layout cannot describe: its
parameter layout, the port's settings and its operations per token, each
found through `benchmark.families` with the dense default where the family
has none.

The two families of the benchmark take every default. The test-only MoE
family (`moe_family`, Mixtral's block) supplies all three, and a cell of it,
added to a temporary checkout as new files, runs through `run.run_cell` on
the CPU: correct when sound, not correct under each planted fault, its MFU
counted from its own active experts, and no file of the benchmark edited.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import families
from benchmark import run as bench
from benchmark.harness import faults, flops, program, spec
from benchmark.reference import common

from . import moe_family
from .conftest import ROOT, tiny_config
from .test_bench_cells import CELLS, SEED

CELL = "moe_tiny.step"

# The fixture cell's limits, from its readings at the tiny size on the CPU
# (20 sound seeds; the half-batch fault and the fp8 control on 4, the
# control read in the reference put in the program's place). The port
# routes from its bf16 norm output, the reference from float32, so a token
# whose 2nd and 3rd router probabilities lie within bf16 rounding goes to
# another expert: 0 to 5 of each step's 512 choices (2 layers x 256 tokens)
# did, and the largest readings came with 0 or 5 alike.
LIMITS = {
    "limits": {"loss_gap": 2e-4, "grad_gap": 5e-3, "update_gap": 1e-2},
    "why": {
        "loss_gap": "sound 4.3e-6 to 2.2e-5; half batch 1.6e-3 or more; "
                    "the control 2.6e-5 or more, too near to separate",
        "grad_gap": "sound 1.0e-3 to 2.6e-3, routing changes included; the "
                    "control 7.4e-3 or more, half batch 0.29 or more",
        "update_gap": "sound 9.0e-4 to 3.8e-3; half batch 0.17 or more, a "
                      "state left unchanged 1; the control 3.7e-3 or more, "
                      "too near to separate",
    },
}


@pytest.fixture
def moe_registered(monkeypatch):
    """The MoE family, as a family and as a reference, for this test alone."""
    monkeypatch.setitem(sys.modules,
                        f"benchmark.families.{moe_family.NAME}", moe_family)
    monkeypatch.setitem(sys.modules,
                        f"benchmark.reference.{moe_family.NAME}", moe_family)


@pytest.fixture
def moe_root(tmp_path, tiny_root, moe_registered):
    """A checkout holding the tiny cells and `CELL`; returns (root, the
    benchmark's files and their bytes before the cell was added)."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    bd = root / "benchmark"
    before = {p: p.read_bytes() for p in bd.rglob("*") if p.is_file()}
    (bd / "configs" / "moe_tiny.json").write_text(
        json.dumps(tiny_config(moe_family.CONFIG)))
    (bd / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    spec_ = json.loads((root / "BENCHMARK.json").read_text())
    spec_["configs"].append({"name": "moe_tiny",
                             "source": moe_family.CONFIG["source"],
                             "file": "benchmark/configs/moe_tiny.json",
                             "reduced": moe_family.CONFIG["reduced"],
                             "why": "test"})
    spec_["workloads"].append({"name": CELL, "config": "moe_tiny",
                               "traffic": "train_fill_step", "chips": 1,
                               "why": "test"})
    for m in spec_["end_to_end"] + spec_["per_layer"]:
        if "gpt2_medium.step" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec_))
    return root, before


@pytest.mark.parametrize("name", CELLS)
def test_benchmark_families_take_the_dense_defaults(name):
    d = families.dims(spec.find_cell(name).config)
    assert families.leaves(d) == common.leaves(d)
    assert families.port_kwargs(d) == {}
    assert not hasattr(families.module(d), "train_flops_per_token")


def test_moe_family_supplies_its_layout_and_port_settings(moe_registered):
    d = families.dims(tiny_config(moe_family.CONFIG))
    assert families.module(d) is moe_family
    block = [(n[len("blocks.1."):], shape) for n, shape, _ in
             families.groups(d)[2]]
    assert block == [("norm1", (64,)), ("norm2", (64,)),
                     ("wq", (64, 4, 16)), ("wk", (64, 2, 16)),
                     ("wv", (64, 2, 16)), ("wo", (4, 16, 64)),
                     ("router", (64, 4)), ("w_up", (4, 64, 96)),
                     ("w_gate", (4, 64, 96)), ("w_down", (4, 96, 64))]
    config = program.gpt_config(d)
    assert (config.n_experts, config.moe_top_k, config.moe_capacity_factor,
            config.moe_aux_coeff) == (4, 2, 2.0, 0.0)
    # every parameter of the port is drawn, at the port's shape
    model = program.build_model(d, SEED, "cpu")
    assert model.blocks["1"].w_up.shape == (4, 64, 96)


@pytest.mark.parametrize("key", ["dtype", "param_dtype", "remat", "z_loss",
                                 "n_layers"])
def test_port_kwargs_may_not_replace_what_the_configuration_fixes(
        moe_registered, monkeypatch, key):
    d = families.dims(tiny_config(moe_family.CONFIG))
    base = moe_family.port_kwargs
    monkeypatch.setattr(moe_family, "port_kwargs",
                        lambda d: dict(base(d), **{key: None}))
    with pytest.raises(ValueError, match=f"'{key}'.*configuration fixes"):
        program.gpt_config(d)


def test_moe_cell_is_correct_and_edits_no_file(moe_root):
    root, before = moe_root
    line = bench.run_cell(CELL, SEED, 1.0, True, device="cpu", root=root,
                          bench_dir=root / "benchmark")
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == set(LIMITS["limits"])
    assert line["attempted"] > 0 and list(line)[-1] == "checks"
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("fault", faults.TRAIN_FAULTS)
def test_moe_cell_fault_is_not_correct(moe_root, fault):
    root, _ = moe_root
    line = bench.run_cell(CELL, SEED, 0.0, False, device="cpu", fault=fault,
                          root=root, bench_dir=root / "benchmark")
    assert not line["correct"], line["checks"]


def test_moe_cell_mfu_counts_the_active_experts(moe_root):
    root, _ = moe_root
    cell = spec.find_cell(CELL, root, root / "benchmark")
    assert "mfu.step" in [m["name"] for m in cell.per_layer]
    d = families.dims(cell.config)
    # 6 x 2 layers x (attention 12,288 + router 256 + 2 of 4 experts
    # 2 x 18,432) + 12 x 2 x 64 x 64 + 6 x 64 x 256
    per_token = moe_family.train_flops_per_token(d, 64)
    assert per_token == 789504.0
    assert per_token != flops.train_flops_per_token(d, 64)
    run = {"config": cell.config, "traffic": cell.traffic,
           "kind": "NVIDIA H100 80GB HBM3",
           "window": {"tokens_per_s": 989e12 / per_token / 4, "seq": 64}}
    assert cell.reader("mfu.step")(run) == pytest.approx(25.0)


CROSS_CHECK = """
import sys
sys.path.insert(0, {root!r})
import torch
from transformers import MixtralConfig
from transformers.models.mixtral.modeling_mixtral import MixtralSparseMoeBlock
from benchmark.reference.common import F32
from benchmark.tests import moe_family

c = dict(moe_family.CONFIG, **moe_family.TINY)
c["assumed"] = dict(c["assumed"], **moe_family.TINY_ASSUMED)
d = moe_family.dims(c)
torch.manual_seed(0)
E, D, F = d.n_experts, d.d_model, d.d_ff
p = {{"router": torch.randn(D, E), "w_up": torch.randn(E, D, F) / 8,
      "w_gate": torch.randn(E, D, F) / 8, "w_down": torch.randn(E, F, D) / 8}}
h = torch.randn(2, 16, D)
hf = MixtralSparseMoeBlock(MixtralConfig(
    hidden_size=D, intermediate_size=F, num_local_experts=E,
    num_experts_per_tok=d.top_k, router_jitter_noise=0.0)).eval()
with torch.no_grad():
    hf.gate.weight.copy_(p["router"].t())
    for e, ex in enumerate(hf.experts):
        ex.w1.weight.copy_(p["w_gate"][e].t())
        ex.w3.weight.copy_(p["w_up"][e].t())
        ex.w2.weight.copy_(p["w_down"][e].t())
    want = hf(h)[0]
    got = moe_family.moe(d, p, h, F32)
print(float((got - want).norm() / want.norm()))
"""


def test_moe_reference_is_mixtrals_sparse_block():
    """The fixture's experts against transformers' MixtralSparseMoeBlock,
    in a process of its own (transformers loads TensorFlow or JAX where it
    finds them unless told not to)."""
    env = dict(os.environ, USE_TF="0", USE_FLAX="0", USE_JAX="0",
               USE_TORCH="1")
    proc = subprocess.run([sys.executable, "-c",
                           CROSS_CHECK.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    if "No module named 'transformers'" in proc.stderr:
        pytest.skip("transformers is not installed")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert float(proc.stdout.strip().splitlines()[-1]) < 1e-6
