"""The plain reference against the port at a tiny size on the CPU, for
every cell of the benchmark."""

import pytest
import torch

from benchmark.families import dims
from benchmark.harness import check, program, spec, weights
from benchmark.reference import family
from benchmark.reference.common import F32, AdamW, exact_f32

from .test_bench_cells import CELLS


@pytest.mark.parametrize("name", CELLS)
def test_reference_forward_and_loss_match_the_port(tiny_root, name):
    cell = spec.find_cell(name, tiny_root, tiny_root / "benchmark")
    d = dims(cell.config)
    seed = 2**35 + 3
    model = program.build_model(d, seed, "cpu")
    tokens = weights.train_rows(d, seed, 0, 2, "cpu")
    with torch.no_grad():
        loss, _ = model.loss({"tokens": tokens})
        logits = model.apply(tokens)[:, -1]
    ref = family(d.family)
    params = weights.draw_all(d, seed, "cpu")
    with exact_f32(), torch.no_grad():
        ref_loss = ref.loss_sum(d, params, tokens, F32) / (2 * (d.seq_len - 1))
        ref_logits = ref.head(d, params, ref.hidden(d, params, tokens, F32),
                              F32)[:, -1]
    # the port computes in bf16: a few bf16 ulps of the loss, about 1% of
    # the logits' norm
    assert abs(float(loss) - float(ref_loss)) < 1e-3 * float(ref_loss)
    err = (logits - ref_logits).norm() / ref_logits.norm()
    assert float(err) < 3e-2


def test_reference_adamw_is_the_ports_update():
    torch.manual_seed(0)
    params = {"a": torch.randn(5, 7), "b": torch.randn(3)}
    grads = [{n: torch.randn_like(p) * 3 for n, p in params.items()}
             for _ in range(3)]
    traffic = spec.find_cell("gpt2_medium.step").traffic
    port = program.optimizer(traffic["optimizer"])
    ref = AdamW.from_traffic(traffic["optimizer"])
    p_port = {n: p.clone() for n, p in params.items()}
    p_ref = {n: p.clone() for n, p in params.items()}
    state = port.init(p_port)
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    for count, g in enumerate(grads, start=1):
        port.update_(p_port, [g[n].clone() for n in p_port], state)
        ref.update(p_ref, ref.clip({n: t.clone() for n, t in g.items()}),
                   mu, nu, count)
    for n in params:
        assert torch.allclose(p_port[n], p_ref[n], rtol=1e-6, atol=1e-7)


def test_the_reference_repeats_itself_exactly(tiny_root):
    cell = spec.find_cell("gpt2_medium.step", tiny_root,
                          tiny_root / "benchmark")
    d = dims(cell.config)
    t = cell.traffic
    ref = check.reference_train(d, 5, 4, t["check_steps"], t["optimizer"],
                                "cpu")
    again = check.reference_train(d, 5, 4, t["check_steps"], t["optimizer"],
                                  "cpu")
    nums = check.train_numbers(again, ref)
    assert nums == {n: 0.0 for n in check.TRAIN_NUMBERS}
