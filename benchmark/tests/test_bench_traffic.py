"""The traffic generator: what the seed fixes and what it does not."""

import torch

from benchmark.families import dims
from benchmark.harness import spec, weights


def test_train_rows_fixed_by_seed_and_new_every_step(tiny_root):
    cell = spec.find_cell("gpt2_medium.step", tiny_root,
                          tiny_root / "benchmark")
    d = dims(cell.config)
    one = weights.train_rows(d, 2**33 + 5, 0, 4, "cpu")
    assert one.shape == (4, d.seq_len)
    assert torch.equal(one, weights.train_rows(d, 2**33 + 5, 0, 4, "cpu"))
    assert not torch.equal(one, weights.train_rows(d, 2**33 + 5, 1, 4,
                                                   "cpu"))
    assert not torch.equal(one, weights.train_rows(d, 2**33 + 6, 0, 4,
                                                   "cpu"))
    assert int(one.max()) < d.token_ids_below
    rows = {tuple(r.tolist()) for t in range(3)
            for r in weights.train_rows(d, 9, t, 4, "cpu")}
    assert len(rows) == 12


def test_weights_fixed_by_seed_group_by_group(tiny_root):
    cell = spec.find_cell("mistral_7b_d8.train", tiny_root,
                          tiny_root / "benchmark")
    d = dims(cell.config)
    a = weights.draw_all(d, 2**40 + 1, "cpu")
    again = weights.draw_group(d, 2**40 + 1, 2, "cpu")
    for name, w in again.items():
        assert torch.equal(a[name], w)
    assert not torch.equal(a["tok_embed"],
                           weights.draw_all(d, 2**40 + 2, "cpu")["tok_embed"])
    assert abs(float(a["blocks.0.wq"].std()) - d.init_std) < 0.1 * d.init_std
