"""A configuration, a traffic mix, a cell and a per-layer metric are added
as new files and entries, with no edit of a file the benchmark has."""

import json
import shutil

from benchmark.harness import spec


def test_new_cell_config_traffic_and_metric_found_by_name(tmp_path,
                                                          tiny_root):
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    bd = root / "benchmark"
    before = {p: p.read_bytes() for p in bd.rglob("*") if p.is_file()}
    config = json.loads((bd / "configs" / "gpt2_medium.json").read_text())
    config["n_layer"] = 1
    (bd / "configs" / "gpt2_one_layer.json").write_text(json.dumps(config))
    traffic = json.loads((bd / "traffic" / "train_fill.json").read_text())
    traffic["check_steps"] = 1
    (bd / "traffic" / "train_one_step.json").write_text(json.dumps(traffic))
    (bd / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return run['window'].get('steps')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gpt2_one_layer", "source": "x",
                             "file": "benchmark/configs/gpt2_one_layer.json",
                             "reduced": ["n_layer"], "why": "test"})
    bench["workloads"].append({"name": "gpt2_one_layer.step",
                               "config": "gpt2_one_layer",
                               "traffic": "train_one_step", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("train_tokens_per_s", "mfu.train"):
            m["workloads"].append("gpt2_one_layer.step")
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "train", "moves": "setup_s",
                               "workloads": ["gpt2_one_layer.step"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.find_cell("gpt2_one_layer.step", root, bd)
    assert cell.config["n_layer"] == 1
    assert cell.traffic["check_steps"] == 1
    assert [m["name"] for m in cell.end_to_end] == ["train_tokens_per_s",
                                                    "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["mfu.train",
                                                   "steps_in_window"]
    run = {"config": cell.config, "traffic": cell.traffic, "kind": "cpu",
           "window": {"steps": 7, "tokens_per_s": 1.0, "seq": 64},
           "trace": None, "counters": {}}
    assert spec.read_metrics(cell, run) == {
        "steps_in_window": {"value": 7.0, "unit": "steps"}}
    # the cells that were there read as before, and no file was edited
    old = spec.find_cell("gpt2_medium.step", root, bd)
    assert "steps_in_window" not in [m["name"] for m in old.per_layer]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_every_cell_of_the_benchmark_has_its_files():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.limits.get("limits"), w["name"]
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).exists()
        config = json.loads((spec.ROOT / c["file"]).read_text())
        assert sorted(config["reduced"]) == sorted(c["reduced"])
        assert sorted(config["published"]) == sorted(c["reduced"])
