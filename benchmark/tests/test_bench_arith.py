"""The yardstick's arithmetic on made-up events: union of intervals, idle
gaps and their names, attention's calls, rooflines and MFU."""

import math

import pytest

from benchmark.families import dims
from benchmark.harness import flops, roofline, spec, trace


def test_union_counts_overlap_once():
    merged = trace.union([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)])
    assert merged == [[0.0, 2.0], [3.0, 4.0]]
    assert trace.gaps(merged, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                             (4.0, 5.0)]


def op(name, start, end, thread=1, kernel_s=0.0, shapes=None):
    return {"name": name, "start": start, "end": end, "thread": thread,
            "kernel_s": kernel_s, "shapes": shapes}


def test_summary_busy_idle_and_gap_names():
    kernels = [{"start": 0.0, "end": 1.0, "name": "k1"},
               {"start": 0.5, "end": 1.5, "name": "k2"},   # another stream
               {"start": 3.0, "end": 4.0, "name": "k1"}]
    ops = [op("bench.train.step", 0.0, 2.5),
           op("aten::item", 1.6, 2.4),
           op("bench.train.report", 2.5, 3.0)]
    s = trace.summarize(kernels, ops, window_s=4.0, outside="train.loop")
    assert s["busy_s"] == pytest.approx(2.5)
    assert s["device_ops"][0] == ["k1", pytest.approx(2.0)]
    (name, width), = s["idle_gaps"]     # none before 0.0 or after 4.0
    assert width == pytest.approx(1.5)
    # the gap 1.5-3.0 has its middle (2.25) in the step, inside aten::item
    assert name == "train.step>aten::item"
    assert trace.name_gap(ops, 3.5, 3.6, "train.loop") == "train.loop"


def test_attention_calls_take_kernels_of_nested_ops_and_outer_only():
    ops = [op("FlashAttention", 0.0, 1.0, kernel_s=0.25),
           op("aten::clone", 0.1, 0.2, kernel_s=0.05),
           op("autograd::engine::evaluate_function: FlashAttentionBackward",
              2.0, 3.0, thread=2),
           op("FlashAttentionBackward", 2.1, 2.9, thread=2, kernel_s=0.5),
           op("aten::mul", 2.2, 2.3, thread=2, kernel_s=0.125),
           op("aten::mm", 5.0, 6.0, kernel_s=9.0)]
    calls = trace.attention_calls(ops)
    assert [c["kind"] for c in calls] == ["fwd", "bwd"]
    assert calls[0]["device_s"] == pytest.approx(0.3)
    assert calls[1]["device_s"] == pytest.approx(0.625)


def test_roofline_share_and_idle(tiny_root):
    cell = spec.find_cell("mistral_7b_d8.train", tiny_root,
                          tiny_root / "benchmark")
    d = dims(cell.config)
    B, H, Hk, S, D = 2, d.n_heads, d.n_kv_heads, 64, d.head_dim
    ops_f, bytes_f = flops.attention_work(B, H, Hk, S, S, D, 2)
    assert ops_f == 4 * D * B * H * S * (S + 1) // 2
    assert bytes_f == 2 * 2 * B * H * S * D + 2 * 2 * B * Hk * S * D \
        + 4 * B * H * S
    bound_f = flops.bound_s(ops_f, bytes_f)[0]
    ops_b, bytes_b = flops.attention_work(B, H, Hk, S, S, D, 2,
                                          backward=True)
    assert ops_b == pytest.approx(2.5 * ops_f)     # S, dV, dP, dQ, dK
    bound_b = flops.bound_s(ops_b, bytes_b)[0]
    run = {"config": cell.config, "traffic": cell.traffic,
           "window": {"batch": B, "seq": S},
           "trace": {"busy_s": 3.0, "window_s": 4.0, "attention": [
               {"kind": "fwd", "device_s": 4 * bound_f},
               {"kind": "fwd", "device_s": 4 * bound_f},
               {"kind": "bwd", "device_s": 2 * bound_b}]}}
    assert roofline.share(run, "fwd") == pytest.approx(25.0)
    assert roofline.share(run, "bwd") == pytest.approx(50.0)
    assert roofline.idle(run) == pytest.approx(25.0)
    run["trace"]["attention"] = []
    assert roofline.share(run, "fwd") is None


def test_live_scores_and_bound():
    assert flops.live_scores(4, 4, True) == 10
    assert flops.live_scores(2, 4, True) == 3 + 4
    assert flops.live_scores(3, 5, False) == 15
    t, by = flops.bound_s(989e12, 1.0)
    assert (t, by) == (pytest.approx(1.0), "operations")
    assert flops.bound_s(1.0, 3.35e12) == (pytest.approx(1.0), "bytes")


def test_mfu_readers(tiny_root):
    cell = spec.find_cell("gpt2_medium.step", tiny_root,
                          tiny_root / "benchmark")
    d = dims(cell.config)
    per_token = flops.train_flops_per_token(d, 64)
    n = flops.non_embedding_params(d)
    assert per_token == 6 * n + 12 * d.n_layers * d.d_model * 64 \
        + 6 * d.d_model * d.vocab
    run = {"config": cell.config, "traffic": cell.traffic,
           "kind": "NVIDIA H100 80GB HBM3",
           "window": {"tokens_per_s": 989e12 / per_token / 2, "seq": 64}}
    assert cell.reader("mfu.train")(run) == pytest.approx(50.0)
    assert cell.reader("mfu.step")(run) == pytest.approx(50.0)
    run["kind"] = "cpu"
    assert cell.reader("mfu.train")(run) is None
    assert math.isclose(flops.peak_flops("NVIDIA H100 PCIe"), 756e12)
