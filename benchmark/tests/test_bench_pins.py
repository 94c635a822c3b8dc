"""The two configurations of the benchmark pinned: what the harness lists,
configures and counts for `mistral_7b_d8` and `gpt2_medium`, and what it
draws for them at the CPU tests' size, as exact literals. A change to how
the harness finds a family's layout, port settings or operations per token
passes only if both configurations read exactly as these literals say."""

import dataclasses
import hashlib

import pytest
import torch

from benchmark.families import dims
from benchmark.harness import flops, program, spec, weights
from benchmark.reference import common

MISTRAL_OUTSIDE = [("tok_embed", (32000, 4096), "normal"),
                   ("norm_f", (4096,), "one"),
                   ("lm_head", (4096, 32000), "normal")]
MISTRAL_BLOCK = [("norm1", (4096,), "one"), ("norm2", (4096,), "one"),
                 ("wq", (4096, 32, 128), "normal"),
                 ("wk", (4096, 8, 128), "normal"),
                 ("wv", (4096, 8, 128), "normal"),
                 ("wo", (32, 128, 4096), "resid"),
                 ("w_up", (4096, 14336), "normal"),
                 ("w_down", (14336, 4096), "resid"),
                 ("w_gate", (4096, 14336), "normal")]
GPT2_OUTSIDE = [("tok_embed", (50257, 1024), "normal"),
                ("norm_f", (1024,), "one"),
                ("pos_embed", (1024, 1024), "normal"),
                ("bias_f", (1024,), "zero")]
GPT2_BLOCK = [("norm1", (1024,), "one"), ("norm2", (1024,), "one"),
              ("wq", (1024, 16, 64), "normal"),
              ("wk", (1024, 16, 64), "normal"),
              ("wv", (1024, 16, 64), "normal"),
              ("wo", (16, 64, 1024), "resid"),
              ("w_up", (1024, 4096), "normal"),
              ("w_down", (4096, 1024), "resid"),
              ("bias1", (1024,), "zero"), ("bias2", (1024,), "zero")]

# the port's GPTConfig of each, field by field (dataclasses.asdict)
PORT_COMMON = dict(pp_microbatches=0, n_experts=0, moe_top_k=2,
                   moe_capacity_factor=1.25, moe_aux_coeff=0.01,
                   dtype=torch.bfloat16, param_dtype=torch.float32,
                   remat=True, remat_policy="dots", z_loss=0.0,
                   attention_impl="auto", attn_block_q=512, attn_block_k=512)
MISTRAL_PORT = dict(vocab_size=32000, n_layers=8, d_model=4096, n_heads=32,
                    n_kv_heads=8, d_ff=14336, max_seq_len=4096,
                    activation="swiglu", norm="rmsnorm", positions="rope",
                    rope_theta=10000.0, tie_embeddings=False, **PORT_COMMON)
GPT2_PORT = dict(vocab_size=50257, n_layers=24, d_model=1024, n_heads=16,
                 n_kv_heads=16, d_ff=4096, max_seq_len=1024,
                 activation="gelu", norm="layernorm", positions="learned",
                 rope_theta=10000.0, tie_embeddings=True, **PORT_COMMON)

PUBLISHED = {
    # cell: (leaves outside the blocks, one block's, layers, port config,
    #        train operations per token at the cell's sequence length)
    "mistral_7b_d8.train": (MISTRAL_OUTSIDE, MISTRAL_BLOCK, 8, MISTRAL_PORT,
                            12866027520.0),
    "gpt2_medium.step": (GPT2_OUTSIDE, GPT2_BLOCK, 24, GPT2_PORT,
                         2422708224.0),
}

# sha256 of the tiny draws at seed 2**40 + 7: groups 0 and 1 (each leaf's
# name and float32 bytes in draw order) and the token rows of step 0
# (int64 bytes), on the CPU
TINY_SEED = 2**40 + 7
TINY_SHA = {
    "mistral_7b_d8.train": (
        "22f5534498330b12e495e67153ed8812b7a580bd22d1810c4a2315d944cad78c",
        "45a2aa693b30efacd1f8ae355a247b9cde323501aec88029519ccae87ba1f146",
        "448ee6f0cdd96993ad239b98f2aa280c08368931a136fd39ee776c1c32b731e7"),
    "gpt2_medium.step": (
        "e777d9479af8554353b90ee9024397f9e4c35d911a7cd1bdba60fd9878b795ba",
        "1925f00437b7798452dabed029b4774d7b336ee76d11ab3b0bddb821058fc6a9",
        "f0bf9d8df54fd11b66c656b8f1fc8b81a7ec0e71e5383bcad1949c4272ac6817"),
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_published_sizes_read_as_pinned(name):
    outside, block, n_layers, port, per_token = PUBLISHED[name]
    d = dims(spec.find_cell(name).config)
    expected = list(outside)
    for i in range(n_layers):
        expected += [(f"blocks.{i}.{n}", shape, init)
                     for n, shape, init in block]
    assert common.leaves(d) == expected
    assert dataclasses.asdict(program.gpt_config(d)) == port
    assert flops.train_flops_per_token(d, d.seq_len) == per_token


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for name, t in tensors:
        h.update(name.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(TINY_SHA))
def test_tiny_draws_read_as_pinned(name, tiny_root):
    d = dims(spec.find_cell(name, tiny_root, tiny_root / "benchmark").config)
    got = tuple(_sha(weights.draw_group(d, TINY_SEED, g, "cpu").items())
                for g in (0, 1))
    rows = weights.train_rows(d, TINY_SEED, 0, 4, "cpu")
    got += (_sha([("rows", rows)]),)
    assert got == TINY_SHA[name]
