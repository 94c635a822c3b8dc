"""ray_tpu_torch's CUDA kernels on the card, against their plain versions,
and the model's head at GPT-2's unaligned vocabulary (the products cuBLAS
picks for it).

Every test here needs an NVIDIA GPU (marker `cuda`) and skips elsewhere.
The file imports neither JAX nor ray_tpu, so it also runs on a GPU machine
without them: ``python -m pytest --noconftest tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as tattn

# bf16 kernels vs f32 plain math on the same bf16 inputs, held as in
# chip_smoke.py: normwise ||err||_F <= NORM_RTOL * ||plain||_F, and per
# element |err| <= ATOL + ELEM_RTOL * |plain| (ELEM_RTOL is one bf16 ulp:
# bf16 outputs are rounded on both sides; ATOL covers the rounding of P and
# dS to bf16 before their products).
NORM_RTOL = 5e-3
ELEM_RTOL = 2 ** -7
ATOL = 1.6e-2
LSE_ATOL = 1e-4   # lse is f32 from the same bf16 products

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernels have no CPU "
                    "mode; their plain versions are tested on the CPU in "
                    "test_torch_attention.py)")
    return torch.device("cuda")


def _qkv(device, b, h, hk, s, sk, d, dtype=torch.bfloat16, seed=0):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=device).to(dtype)

    return rnd(b, h, s, d), rnd(b, hk, sk, d), rnd(b, hk, sk, d), \
        rnd(b, h, s, d)


def _close(got, ref, atol=None, norm_rtol=NORM_RTOL, elem_atol=ATOL):
    """With `atol`, an absolute limit on max |err| (lse); otherwise the
    normwise and per-element rule above."""
    ref = ref.float()
    err = (got.float() - ref).abs()
    if atol is not None:
        assert err.max().item() <= atol, (err.max().item(), atol)
        return
    norm_rel = (err.norm() / ref.norm()).item()
    atol_needed = (err - ELEM_RTOL * ref.abs()).max().item()
    assert norm_rel <= norm_rtol, (norm_rel, norm_rtol)
    assert atol_needed <= elem_atol, (atol_needed, elem_atol)


SHAPES = {   # b, h, hk, s, sk, d, causal
    "causal_d64": (2, 4, 4, 512, 512, 64, True),
    "gqa_s300_d128": (1, 4, 2, 300, 300, 128, True),
    "q128_k256_d32": (2, 4, 2, 128, 256, 32, True),
    "non_causal": (2, 4, 4, 256, 256, 64, False),
    "fully_masked_rows": (1, 2, 2, 256, 128, 64, True),
    # the edges of the 128-row q/kv tiles and the 64-row q and K/V tiles
    "s1": (2, 4, 2, 1, 1, 64, True),
    "s65": (2, 4, 4, 65, 65, 64, True),
    "q256_k128_d128": (1, 4, 2, 256, 128, 128, True),
    "s127": (2, 4, 4, 127, 127, 64, True),
    "s129": (2, 4, 4, 129, 129, 64, True),
    "s1000_d128": (1, 4, 2, 1000, 1000, 128, True),
    "s1000_non_causal": (1, 4, 4, 1000, 1000, 64, False),
    "q64_k1024": (2, 4, 4, 64, 1024, 64, True),
    "gqa4_d128": (1, 8, 2, 384, 384, 128, True),
    "d32_s200": (2, 4, 4, 200, 200, 32, True),
    "f32_inputs": (1, 4, 2, 200, 200, 64, True, torch.float32),
}
# one key: P = 1 and dS = P (dP - delta) = 0, so dQ and dK are exactly 0
# and the plain version's are rounding noise, for which a relative rule
# means nothing
ZERO_DQ_DK = {"s1"}
# f32 inputs are rounded to bf16 for the products while the plain version
# keeps them f32 (chip_smoke.py's f32 limits)
F32_NORM_RTOL, F32_ATOL, F32_LSE_ATOL = 1e-2, 3.5e-2, 1e-2


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_kernels_match_plain(cuda_device, case):
    *shape, causal = SHAPES[case][:7]
    dtype = SHAPES[case][7] if len(SHAPES[case]) > 7 else torch.bfloat16
    q, k, v, do = _qkv(cuda_device, *shape, dtype=dtype)
    tol = {} if dtype == torch.bfloat16 else dict(norm_rtol=F32_NORM_RTOL,
                                                  elem_atol=F32_ATOL)
    lse_atol = LSE_ATOL if dtype == torch.bfloat16 else F32_LSE_ATOL
    out, lse = tattn.flash_fwd(q, k, v, causal)
    p_out, p_lse = tattn.flash_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    _close(out, p_out, **tol)
    _close(lse, p_lse, atol=lse_atol)
    delta = (do.float() * p_out.float()).sum(-1)
    dq, dk, dv = tattn.flash_bwd(q, k, v, p_out, p_lse, do, causal,
                                 delta=delta)
    p_dq = tattn.flash_bwd_dq_plain(q, k, v, do, p_lse, delta, causal)
    p_dk, p_dv = tattn.flash_bwd_dkv_plain(q, k, v, do, p_lse, delta, causal)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    if case in ZERO_DQ_DK:
        assert dq.abs().max().item() <= 1e-5
        assert dk.abs().max().item() <= 1e-5
    else:
        _close(dq, p_dq, **tol)
        _close(dk, tattn._group_sum(p_dk, k.shape[1]), **tol)
    _close(dv, tattn._group_sum(p_dv, k.shape[1]), **tol)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_keep_f32_matches_plain(cuda_device, d):
    """keep_f32 writes dK/dV (and dQ) in f32, without the bf16 rounding of
    the outputs, so they sit closer to the plain f32 sums."""
    q, k, v, do = _qkv(cuda_device, 1, 4, 2, 300, 300, d, seed=1)
    p_out, p_lse = tattn.flash_fwd_plain(q, k, v, True)
    delta = (do.float() * p_out.float()).sum(-1)
    dq, dk, dv = tattn.flash_bwd(q, k, v, p_out, p_lse, do, True,
                                 delta=delta, keep_f32=True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    p_dk, p_dv = tattn.flash_bwd_dkv_plain(q, k, v, do, p_lse, delta, True)
    _close(dq, tattn.flash_bwd_dq_plain(q, k, v, do, p_lse, delta, True,
                                        keep_f32=True))
    _close(dk, tattn._group_sum(p_dk, k.shape[1]))
    _close(dv, tattn._group_sum(p_dv, k.shape[1]))


def test_keep_f32_and_strided_views(cuda_device):
    """[B,S,H,D] memory viewed as [B,H,S,D] (the model's layout) reaches the
    kernels without a copy; keep_f32 returns f32 gradients."""
    b, s, h, d = 2, 192, 4, 64
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=cuda_device,
                               dtype=torch.bfloat16).transpose(1, 2)
                   for _ in range(4))
    out, lse = tattn.flash_fwd(q, k, v, True)
    assert out.stride() == q.stride()
    dq, dk, dv = tattn.flash_bwd(q, k, v, out, lse, do, True, keep_f32=True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
    ref = tattn.flash_bwd(qc, kc, vc, out.contiguous(), lse, doc, True,
                          keep_f32=True)
    for a, r in zip((dq, dk, dv), ref):
        torch.testing.assert_close(a, r, atol=0, rtol=0)


@pytest.mark.parametrize("d", [64, 128])
def test_backward_is_deterministic(cuda_device, d):
    """The GQA group sum of dK/dV runs in registers in a fixed order (and,
    at D=128, through a P^T hand-over between warpgroups): two runs on the
    same inputs agree bit for bit."""
    q, k, v, do = _qkv(cuda_device, 2, 8, 2, 640, 640, d, seed=2)
    out, lse = tattn.flash_fwd(q, k, v, True)
    first = tattn.flash_bwd(q, k, v, out, lse, do, True)
    for _ in range(3):
        again = tattn.flash_bwd(q, k, v, out, lse, do, True)
        for a, r in zip(again, first):
            torch.testing.assert_close(a, r, atol=0, rtol=0)


def test_autograd_counts_launches(cuda_device):
    q, k, v, do = _qkv(cuda_device, 1, 4, 2, 256, 256, 64)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    tattn.reset_launch_counts()
    tattn.flash_attention(qs, ks, vs, True).backward(do)
    assert tattn.launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                              "flash_bwd_dkv": 1}
    # the same upstream gradient on both paths, so the rule above applies
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    tattn.attention_reference(qr, kr, vr, True).backward(do)
    for a, r in ((qs, qr), (ks, kr), (vs, vr)):
        _close(a.grad, r.grad)


def test_unsupported_head_dim_raises(cuda_device):
    q, k, v, _ = _qkv(cuda_device, 1, 2, 2, 64, 64, 64)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_fwd(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(TypeError):
        tattn.flash_fwd(q.half(), k.half(), v.half())


# the loopback ring against full-sequence flash attention, both on the
# kernels, by the rule above: the ring rounds each partial's output to bf16
# before its f32 merge (as the JAX ring does). Limits about 2x the readings
# on an H100 (normwise 3.09e-3 on the non-causal output, atol needed
# 1.17e-3 on the causal dQ); chip_smoke.py's phase 7 holds the same rule at
# llama_1b's shape (RING_TOL there)
RING_NORM_RTOL = 6.5e-3
RING_ATOL = 2.4e-3


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "non_causal"])
def test_loopback_ring_matches_flash(cuda_device, causal):
    import importlib

    R = importlib.import_module("ray_tpu_torch.ops.ring_attention")
    sp = 4
    q, k, v, do = _qkv(cuda_device, 1, 8, 4, 1024, 1024, 128, seed=3)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tattn.flash_attention(*ts, causal)
    out.backward(do)
    want = [out.detach()] + [t.grad for t in ts]
    rs = [t.clone().requires_grad_() for t in (q, k, v)]
    tattn.reset_launch_counts()
    outs = R.ring_attention(*(list(t.chunk(sp, dim=2)) for t in rs),
                            R.LoopbackRing(sp), causal=causal, impl="cuda")
    torch.cat(outs, dim=2).backward(do)
    n = sp * (sp + 1) // 2 if causal else sp * sp
    assert tattn.launches == {"flash_fwd": n, "flash_bwd_dq": n,
                              "flash_bwd_dkv": n}
    got = [torch.cat(outs, dim=2).detach()] + [t.grad for t in rs]
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g, w, norm_rtol=RING_NORM_RTOL, elem_atol=RING_ATOL)


# --- the card paths of the MoE mesh and the pipeline --------------------------

# llama_tiny on the card (bf16, the kernels at head_dim 32): the first
# step's loss and grad norm of the mesh path against the no-mesh model's.
# A one-rank mesh only copies (chip_smoke.py phase 10 reads them bit-equal
# at llama_1b; the FSDP limits there are these); a pipeline runs the
# products on microbatches of the rows, where cuBLAS may sum in another
# order (chip_smoke.py phase 11's limits)
MESH1_LOSS_RTOL, MESH1_GRAD_NORM_RTOL = 1e-4, 2e-3
PIPE_LOSS_RTOL, PIPE_GRAD_NORM_RTOL = 1e-3, 1e-2


def _first_step(cfg, mesh, tokens):
    from ray_tpu_torch.models import gpt, training

    model = gpt.GPT(cfg, seed=0, mesh=mesh)
    opt = training.make_optimizer(total_steps=10)
    state = training.init_train_state(model, opt, mesh=mesh)
    step = training.make_train_step(model, opt, mesh=mesh)
    tattn.reset_launch_counts()
    _, m = step(state, {"tokens": tokens})
    torch.cuda.synchronize()
    return ({k: float(m[k]) for k in ("loss", "grad_norm")
             if k in m} | {"aux": float(m.get("moe_aux_loss", 0.0))},
            dict(tattn.launches))


def _tokens(cfg, b, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, 256))).cuda()


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_moe_on_one_rank_nccl_mesh_equals_no_mesh(cuda_device):
    """llama_tiny with 4 experts through the process-mesh path on a
    one-rank NCCL group (the routing gather, the batch-group sum, the ep
    and tp pairs, FSDP2) against no mesh: the first loss, load-balance loss
    and grad norm, and the same kernel launches."""
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    cfg = gpt.llama_tiny(n_experts=4, remat_policy="dots")
    tokens = _tokens(cfg, 4)
    want, want_launches = _first_step(cfg, None, tokens)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        got, launches = _first_step(
            cfg, build_mesh(MeshSpec(dp=1, ep=1, tp=1), device_type="cuda"),
            tokens)
    finally:
        dist.destroy_process_group()
    assert launches == want_launches
    assert _rel(got["loss"], want["loss"]) <= MESH1_LOSS_RTOL
    assert _rel(got["aux"], want["aux"]) <= MESH1_LOSS_RTOL
    assert _rel(got["grad_norm"], want["grad_norm"]) <= MESH1_GRAD_NORM_RTOL


def test_loopback_pipeline_equals_no_mesh_on_card(cuda_device):
    """llama_tiny with 4 layers through the GPipe schedule on 2 loopback
    stages and 4 microbatches, on the kernels, against no mesh: the first
    loss and grad norm, and 2·L·M forward, L·M dQ and L·M dK/dV launches."""
    import dataclasses

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import MeshSpec, loopback_mesh

    cfg = dataclasses.replace(gpt.llama_tiny(remat_policy="dots",
                                             pp_microbatches=4), n_layers=4)
    tokens = _tokens(cfg, 8)
    want, _ = _first_step(cfg, None, tokens)
    got, launches = _first_step(cfg, loopback_mesh(MeshSpec(pp=2)), tokens)
    L, M = cfg.n_layers, 4
    assert launches == {"flash_fwd": 2 * L * M, "flash_bwd_dq": L * M,
                        "flash_bwd_dkv": L * M}
    assert _rel(got["loss"], want["loss"]) <= PIPE_LOSS_RTOL
    assert _rel(got["grad_norm"], want["grad_norm"]) <= PIPE_GRAD_NORM_RTOL


def test_unaligned_head_leaves_cublas_sm75_kernels(cuda_device):
    """`GPT._head` at GPT-2's 50,257 rows (4,096 positions, d 1,024): its
    working copy takes 47 zero rows, so no product of its forward and
    backward runs cuBLAS's sm75 CUTLASS fallback; the logits and the
    table's gradient match an unpadded f32 computation within bf16
    tolerance, and the forward and backward hold no more memory than the
    unpadded head's under plain autograd (a cast and a product)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import gpt

    V, d, n = 50257, 1024, 4096
    model = gpt.GPT(gpt.GPTConfig(vocab_size=V, n_layers=1, d_model=d,
                                  n_heads=16, remat=False),
                    device=cuda_device)
    assert model.head_pad_rows == 47
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, n // 2, d, generator=g, device=cuda_device,
                    dtype=torch.bfloat16, requires_grad=True)
    dy = torch.randn(2, n // 2, V, generator=g, device=cuda_device) * 1e-2

    def unpadded(x):
        h = model._norm(x, model.norm_f, model.bias_f)
        return (h @ model.tok_embed.t().to(h.dtype)).to(torch.float32)

    def run(head):
        model.zero_grad(set_to_none=True)
        x.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        logits = head(x)
        logits.backward(dy)
        torch.cuda.synchronize()
        return logits.detach(), torch.cuda.max_memory_allocated() - base

    run(unpadded)
    run(model._head)                         # warm both
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        logits, peak = run(model._head)
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels, "the profiler recorded no kernel"
    assert not [k for k in kernels if "cutlass_75" in k], kernels
    grad = model.tok_embed.grad.clone()
    _, peak0 = run(unpadded)
    assert logits.dtype == torch.float32 and logits.shape == (2, n // 2, V)
    # a second bf16 [n, 50304] buffer would add 412 MB
    assert peak <= peak0 + n * (V + 47) * 2 // 8, (peak, peak0)

    with torch.no_grad():
        h = model._norm(x, model.norm_f, model.bias_f).float().reshape(n, d)
        ref_logits = h @ model.tok_embed.t()
        ref_grad = dy.reshape(n, V).t() @ h
    _close(logits.reshape(n, V), ref_logits)
    _close(grad, ref_grad)
