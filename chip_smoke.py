#!/usr/bin/env python3
"""Chip smoke test of ray_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--out results.json] [--profile table.txt]
                          [--skip-main]

Phases, each fatal on failure (non-zero exit, no result line):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA
   versions, then the build of the CUDA kernels from ``ray_tpu_torch/csrc``
   (one nvcc per source, in parallel), with its seconds and ptxas's
   register, spill and wgmma-serialisation report; fails if any of the
   warp-specialised kernels (forward, dQ, dK/dV) spills registers;
2. kernels: each flash kernel (forward, backward dQ, backward dK/dV) against
   its plain PyTorch version on the same bf16 inputs on the card, at the
   GPT-2 medium attention shape (strided [B,S,H,D] views, as the model
   passes them), llama_1b's GQA shape, non-causal, S=300, S=1000 at
   head_dim 128, S=129, q_len 128 against k_len 256, q_len 256 against
   k_len 128 at head_dim 128 (fully masked rows), head_dim 32 and f32
   inputs; then each kernel's time beside its bound, its plain version and
   the PyTorch library call, at the GPT-2 medium and the llama_1b shape;
3. model check: a small GPT on the card with attention through the kernels
   against the same weights with the reference attention (loss and grads);
4. main path: gpt2_medium, batch 12 x seq 1024, remat "dots", 2 warm-up + 5
   timed train steps through GPT -> init_train_state -> make_train_step on
   tokens from a seeded numpy generator; every loss finite, every kernel
   launched in that run; step time, tokens/s, MFU.

Prints the kernels as one JSON line, then the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Exits non-zero without a result
when CUDA is missing or the package is not beside this script.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import subprocess
import sys
import time

# H100 peaks (NVIDIA data sheet, dense, at the 700 W limit of the SXM part)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# dense bf16 peak by card, for MFU (the card's own variant, by its name)
MFU_PEAK = (("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("H100", 989e12),
            ("H200", 989e12))

# Each kernel output is held to its plain version on the same inputs twice:
#   normwise     ||kernel - plain||_F <= norm_rtol * ||plain||_F
#   per element  |kernel - plain|     <= atol + ELEM_RTOL * |plain|
# ELEM_RTOL is one bf16 ulp of |plain|: a bf16 output is rounded to bf16 on
# both sides. atol covers the rounding of P and dS to bf16 before their
# products; f32 inputs are also rounded to bf16 for the products, while the
# plain version keeps them f32. lse (f32 on both sides) is held to an
# absolute limit. The readings each limit was set from are in PERF.md.
ELEM_RTOL = 2 ** -7
KERNEL_TOL = {   # input dtype -> (norm_rtol, atol, lse_atol)
    "bf16": (5e-3, 1.6e-2, 1e-4),
    "f32": (1e-2, 3.5e-2, 1e-2),
}
# small model on the card, kernels against the reference attention
MODEL_LOSS_RTOL = 1e-4   # |loss_k - loss_r| <= MODEL_LOSS_RTOL * |loss_r|
MODEL_GRAD_RTOL = 2e-2   # per leaf ||g_k - g_r||_F <= this * ||g_r||_F

REPLACES = {
    "flash_fwd": "ray_tpu/ops/attention.py:89",
    "flash_bwd_dq": "ray_tpu/ops/attention.py:190",
    "flash_bwd_dkv": "ray_tpu/ops/attention.py:235",
}
# the warp-specialised wgmma/TMA kernels, held to zero register spills
HOPPER_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
SOURCES = {
    "flash_fwd": "ray_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dq": "ray_tpu_torch/csrc/flash_bwd_dq.cu",
    "flash_bwd_dkv": "ray_tpu_torch/csrc/flash_bwd_dkv.cu",
}


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def live_scores(q_len: int, k_len: int, causal: bool) -> int:
    """(query, key) pairs the mask leaves, per (batch, head)."""
    if not causal:
        return q_len * k_len
    off = k_len - q_len
    return sum(min(k_len, max(0, i + off + 1)) for i in range(q_len))


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def spilling_kernels(build_log, names):
    """The entry functions of kernels `names` for which ptxas reports spill
    stores or loads (a build log entry is "[name] <nvcc output>")."""
    bad = []
    for entry in build_log:
        name = entry[1:entry.index("]")]
        if name not in names:
            continue
        func = "?"
        for ln in entry.splitlines():
            if "Compiling entry function" in ln:
                func = ln.split("'")[1] if "'" in ln else ln.strip()
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and (int(m.group(1)) or int(m.group(2))):
                bad.append(f"{name}: {func} ({ln.strip()})")
    return bad


# --- phase 2: kernels against their plain versions -------------------------

def make_case(torch, b, h, hk, s, sk, d, dtype, bshd, seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def rnd(heads, length):
        if bshd:   # the model's layout: [B,S,H,D] viewed as [B,H,S,D]
            return torch.randn(b, length, heads, d, generator=g,
                               device="cuda").to(dtype).transpose(1, 2)
        return torch.randn(b, heads, length, d, generator=g,
                           device="cuda").to(dtype)

    q, k, v, do = rnd(h, s), rnd(hk, sk), rnd(hk, sk), rnd(h, s)
    return q, k, v, do


def compare(got, ref):
    """(max |err|, normwise relative err, least atol the per-element rule
    needs) of a kernel output `got` against its plain version `ref`."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    norm_rel = (err.norm() / ref.norm().clamp_min(1e-30)).item()
    atol_needed = (err - ELEM_RTOL * ref.abs()).max().clamp_min(0).item()
    return err.max().item(), norm_rel, atol_needed


def check_case(torch, A, name, causal, tensors, results):
    """Hold every output of the three kernels to its plain version; returns
    the failures (the caller raises once all cases have printed)."""
    q, k, v, do = tensors
    out, lse = A.flash_fwd(q, k, v, causal)
    p_out, p_lse = A.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * p_out.float()).sum(-1)
    dq, dk, dv = A.flash_bwd(q, k, v, p_out, p_lse, do, causal, delta=delta)
    torch.cuda.synchronize()
    p_dq = A.flash_bwd_dq_plain(q, k, v, do, p_lse, delta, causal)
    p_dk, p_dv = A.flash_bwd_dkv_plain(q, k, v, do, p_lse, delta, causal)
    p_dk = A._group_sum(p_dk, k.shape[1]).to(k.dtype)
    p_dv = A._group_sum(p_dv, k.shape[1]).to(v.dtype)
    checks = {"flash_fwd": [("out", out, p_out), ("lse", lse, p_lse)],
              "flash_bwd_dq": [("dq", dq, p_dq)],
              "flash_bwd_dkv": [("dk", dk, p_dk), ("dv", dv, p_dv)]}
    kind = "f32" if q.dtype == torch.float32 else "bf16"
    norm_tol, atol, lse_atol = KERNEL_TOL[kind]
    parts = []
    bad = []
    for kern, items in checks.items():
        for label, got, ref in items:
            if not torch.isfinite(got).all():
                bad.append(f"{label} not finite")
            err, norm_rel, atol_needed = compare(got, ref)
            if label == "lse":
                ok = err <= lse_atol
                parts.append(f"lse max {err:.3e} (<= {lse_atol:.0e})")
            else:
                ok = norm_rel <= norm_tol and atol_needed <= atol
                parts.append(
                    f"{label} max {err:.3e} of |plain| "
                    f"{ref.float().abs().max().item():.3f}, norm "
                    f"{norm_rel:.3e} (<= {norm_tol:.0e}), atol needed "
                    f"{atol_needed:.3e} (<= {atol:.0e})")
            if not ok:
                bad.append(f"{name}: {label}")
            r = results.setdefault(kern, {"max_abs_err": 0.0, "readings": {}})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["readings"][f"{label} {name}"] = {
                "max_abs": err, "norm_rel": norm_rel,
                "atol_needed": atol_needed}
    log(f"kernels [{name}]: " + "; ".join(parts))
    return bad


def time_kernels(torch, A, tensors, causal, results=None):
    """ms of each kernel (launched alone), of its plain version and of the
    PyTorch library call at one attention shape; returns them with the
    bound per kernel, and also writes them into `results` (the kernels
    line's, for the main path's GPT-2 medium shape) when it is given."""
    import torch.nn.functional as F

    q, k, v, do = tensors
    B, H, S, D = q.shape
    Hk, Sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    out, lse = A.flash_fwd(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    o2 = torch.empty_like(q)
    lse2 = torch.empty_like(lse)
    p_fwd = A._params(q, k, causal, scale, v=v, o=o2, lse=lse2)
    p_bwd = A._params(q, k, causal, scale, v=v, dout=do, lse=lse,
                      delta=delta, dq=dq, dk=dk, dv=dv)
    dev = q.device

    kern_ms = {
        "flash_fwd": cuda_ms(torch, lambda: A._launch("flash_fwd", p_fwd,
                                                      dev)),
        "flash_bwd_dq": cuda_ms(torch, lambda: A._launch("flash_bwd_dq",
                                                         p_bwd, dev)),
        "flash_bwd_dkv": cuda_ms(torch, lambda: A._launch("flash_bwd_dkv",
                                                          p_bwd, dev)),
    }
    plain_ms = {
        "flash_fwd": cuda_ms(torch, lambda: A.flash_fwd_plain(q, k, v,
                                                              causal),
                             iters=3, warmup=1),
        "flash_bwd_dq": cuda_ms(torch, lambda: A.flash_bwd_dq_plain(
            q, k, v, do, lse, delta, causal), iters=3, warmup=1),
        "flash_bwd_dkv": cuda_ms(torch, lambda: [A._group_sum(
            t, Hk) for t in A.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  causal)],
            iters=3, warmup=1),
    }
    # library yardstick, timed here only: SDPA forward, and SDPA's backward
    # (one call that computes dQ, dK and dV together)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    gqa = H != Hk
    sdpa_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=gqa))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                              enable_gqa=gqa)
    sdpa_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, (qs, ks, vs), do, retain_graph=True))
    lib_ms = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
              "flash_bwd_dkv": sdpa_bwd}

    live = B * H * live_scores(S, Sk, causal)
    el = q.element_size()
    qb, kb = B * H * S * D * el, B * Hk * Sk * D * el
    rows = B * H * S * 4
    work = {   # (flops, bytes): each input read once, each output written once
        "flash_fwd": (4 * D * live, 2 * qb + 2 * kb + rows),
        "flash_bwd_dq": (6 * D * live, 3 * qb + 2 * kb + 2 * rows),
        "flash_bwd_dkv": (8 * D * live, 2 * qb + 4 * kb + 2 * rows),
    }
    timings = {}
    for name in kern_ms:
        b_ms, b_by = bound_ms(*work[name])
        timings[name] = dict(ms=kern_ms[name], plain_ms=plain_ms[name],
                             bound_ms=b_ms, bound_by=b_by,
                             library_ms=lib_ms[name])
        if results is not None:
            results[name].update(timings[name])
        log(f"timing [{name}] B={B} H={H} Hk={Hk} S={S} D={D}: kernel "
            f"{kern_ms[name]:.4f} ms, bound {b_ms:.4f} ms ({b_by}), plain "
            f"{plain_ms[name]:.4f} ms, library {lib_ms[name]:.4f} ms, "
            f"achieved {work[name][0] / kern_ms[name] / 1e9:.1f} TFLOP/s")
    return timings


# --- phase 3: small model, kernels vs reference attention ------------------

def model_check(torch, models):
    from ray_tpu_torch.models.gpt import GPTConfig

    cfg = GPTConfig(vocab_size=512, n_layers=2, d_model=256, n_heads=4,
                    max_seq_len=256, remat=False)
    tokens = torch.from_numpy(_tokens(4, 200, cfg.vocab_size, seed=3)).cuda()
    out = {}
    for impl in ("cuda", "reference"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        m = models.GPT(c, seed=0)
        loss, _ = m.loss({"tokens": tokens})
        loss.backward()
        out[impl] = (loss.item(), {n: p.grad for n, p in
                                   m.named_parameters()})
    l_k, g_k = out["cuda"]
    l_r, g_r = out["reference"]
    loss_rel = abs(l_k - l_r) / abs(l_r)
    worst, leaf = max((compare(g_k[n], g_r[n])[1], n) for n in g_r)
    log(f"model check: loss kernels {l_k:.6f} reference {l_r:.6f}, relative "
        f"gap {loss_rel:.3e} (<= {MODEL_LOSS_RTOL:.0e}); worst leaf {leaf} "
        f"grad norm-relative err {worst:.3e} (<= {MODEL_GRAD_RTOL:.0e})")
    if not (math.isfinite(l_k) and loss_rel <= MODEL_LOSS_RTOL
            and worst <= MODEL_GRAD_RTOL):
        raise SmokeFailure("small model: kernels disagree with reference")
    return {"loss_rel": loss_rel, "worst_grad_norm_rel": worst,
            "worst_leaf": leaf}


def _tokens(b, s, vocab, seed):
    import numpy as np
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int64)


# --- phase 4: the main path --------------------------------------------------

def profile_steps(torch, step, state, batch_dict, path, step_ms, n=2):
    """Device time by kernel class over `n` more steps (torch.profiler),
    the full table written to `path`; returns the per-step summary. The
    idle share is taken against `step_ms`, the step time measured without
    the profiler (whose host overhead stretches the profiled steps)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = step(state, batch_dict)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    classes = {"flash kernels": 0.0, "matrix products": 0.0, "other": 0.0}
    for evt in prof.key_averages():
        if evt.device_type.name != "CUDA":
            continue
        us = evt.self_device_time_total
        name = evt.key.lower()
        if "flash_" in name:
            classes["flash kernels"] += us
        elif any(w in name for w in ("gemm", "xmma", "cutlass", "matmul",
                                     "nvjet", "sm90_")):
            classes["matrix products"] += us
        else:
            classes["other"] += us
    per_step = {k: v / 1e3 / n for k, v in classes.items()}
    busy = sum(per_step.values())
    with open(path, "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60))
    idle = max(0.0, 1 - busy / step_ms)
    log(f"profile ({n} steps): device busy {busy:.1f} ms/step, idle share "
        f"{idle:.3f} of the unprofiled {step_ms:.1f} ms step (profiled wall "
        f"{wall_ms:.1f} ms/step); by class " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in per_step.items()))
    return {"profiled_wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": idle, "by_class_ms": per_step}


def main_path(torch, A, models, smi_name, batch=12, seq=1024, warmup=2,
              steps=5, profile_path=None):
    from ray_tpu_torch.models.training import flops_per_token

    cfg = models.gpt2_medium(max_seq_len=seq, remat_policy="dots")
    t0 = time.perf_counter()
    model = models.GPT(cfg, seed=0)
    opt = models.make_optimizer(total_steps=steps + warmup)
    state = models.init_train_state(model, opt)
    step = models.make_train_step(model, opt)
    tokens = torch.from_numpy(_tokens(batch, seq, cfg.vocab_size,
                                      seed=1)).cuda()
    batch_dict = {"tokens": tokens}
    torch.cuda.synchronize()
    log(f"main path: gpt2_medium ({cfg.n_params / 1e6:.1f}M params) built "
        f"in {time.perf_counter() - t0:.1f}s")

    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    losses, grad_norms = [], []
    for _ in range(warmup):
        state, m = step(state, batch_dict)
        losses.append(m["loss"])
        grad_norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch_dict)
        losses.append(m["loss"])
        grad_norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(A.launches)
    losses = [float(x) for x in losses]
    grad_norms = [float(x) for x in grad_norms]
    n_steps = warmup + steps

    step_s = dt / steps
    tok_s = batch * seq / step_s
    peak = next((v for k, v in MFU_PEAK if k in smi_name), PEAK_BF16_FLOPS)
    mfu = tok_s * flops_per_token(cfg) / peak
    per_step = {k: v / n_steps for k, v in counts.items()}
    log(f"main path: losses {losses}; grad_norm {grad_norms}")
    log(f"main path: step {step_s * 1e3:.1f} ms, {tok_s:.0f} tokens/s, MFU "
        f"{mfu:.4f} (peak {peak / 1e12:.0f} TFLOP/s), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, kernel "
        f"launches per step {per_step}")
    if not all(math.isfinite(x) for x in losses + grad_norms):
        raise SmokeFailure(f"non-finite loss or grad norm: {losses}")
    # random init: the first loss is close to ln(vocab)
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise SmokeFailure(f"first loss {losses[0]} far from "
                           f"ln(V)={math.log(cfg.vocab_size):.3f}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise SmokeFailure(f"kernels never launched on the main path: "
                           f"{missing}")
    result = {"step_ms": step_s * 1e3, "tokens_per_s": tok_s, "mfu": mfu,
              "mfu_peak_flops": peak, "losses": losses,
              "grad_norms": grad_norms, "launches_per_step": per_step,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    if profile_path:
        result["profile"] = profile_steps(torch, step, state, batch_dict,
                                          profile_path, step_s * 1e3)
    return counts, result


def run(args) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from ray_tpu_torch import models
        from ray_tpu_torch.ops import _ext
        from ray_tpu_torch.ops import attention as A
    except ImportError as exc:
        print(f"chip_smoke: ray_tpu_torch is not importable ({exc}); run "
              "from the root of the repository", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: device and build
    smi = nvidia_smi()
    log(f"device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s), "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _ext.load_all(ptxas_verbose=True)
    build_s = time.perf_counter() - t0
    usage = [ln.strip() for entry in _ext.build_log
             for ln in entry.splitlines()
             if "Compiling entry" in ln or "registers" in ln
             or "spill" in ln or "warning" in ln.lower()
             or "Performance Loss" in ln]
    log(f"build: {len(_ext.KERNELS)} kernels in {build_s:.1f}s (nvcc, "
        f"parallel)")
    for ln in usage:
        log(f"  ptxas: {ln}")
    spills = spilling_kernels(_ext.build_log, HOPPER_KERNELS)
    if spills:
        raise SmokeFailure(f"registers spill in {spills}")

    # phase 2: kernels against their plain versions
    bf16 = torch.bfloat16
    cases = [
        ("gpt2_medium causal B12 H16 S1024 D64 [B,S,H,D] views", True,
         (12, 16, 16, 1024, 1024, 64, bf16, True)),
        ("llama_1b GQA B2 H16 Hk8 S2048 D128", True,
         (2, 16, 8, 2048, 2048, 128, bf16, True)),
        ("non-causal B2 H16 S1024 D64", False,
         (2, 16, 16, 1024, 1024, 64, bf16, False)),
        ("S=300 B2 H16 Hk4 D64", True, (2, 16, 4, 300, 300, 64, bf16, False)),
        ("S=1000 B2 H8 Hk2 D128", True,
         (2, 8, 2, 1000, 1000, 128, bf16, True)),
        ("S=129 B3 H4 D64", True, (3, 4, 4, 129, 129, 64, bf16, False)),
        ("q_len 128 k_len 256 B2 H16 D64", True,
         (2, 16, 16, 128, 256, 64, bf16, False)),
        ("q_len 256 k_len 128 B1 H4 Hk2 D128 (fully masked rows)", True,
         (1, 4, 2, 256, 128, 128, bf16, False)),
        ("D=32 llama_tiny B4 H4 Hk2 S256", True,
         (4, 4, 2, 256, 256, 32, bf16, True)),
        ("f32 inputs B2 H4 S256 D64", True,
         (2, 4, 4, 256, 256, 64, torch.float32, False)),
    ]
    results = {}
    failed = []
    timed = []   # the gpt2_medium and llama_1b cases are timed too
    for i, (name, causal, shape) in enumerate(cases):
        tensors = make_case(torch, *shape, seed=i)
        failed += check_case(torch, A, name, causal, tensors, results)
        if i < 2:
            timed.append(tensors)
        del tensors
    if failed:
        raise SmokeFailure("kernels disagree with their plain versions: "
                           + "; ".join(failed))
    timings = {"gpt2_medium": time_kernels(torch, A, timed[0], True,
                                           results),
               "llama_1b_gqa_d128": time_kernels(torch, A, timed[1], True)}
    del timed
    torch.cuda.empty_cache()

    # phase 3: small model against the reference attention
    model = model_check(torch, models)

    # phase 4: main path; with --skip-main no launch was counted (null)
    counts, main = ({k: None for k in A.launches}, None) if args.skip_main \
        else main_path(torch, A, models, smi, profile_path=args.profile)
    if args.skip_main:
        log("main path: skipped (--skip-main)")

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": counts[name],
                **{k: results[name][k] for k in
                   ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}}
               for name in A.launches]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "build_s": build_s,
                       "ptxas": usage, "kernels": kernels,
                       "timings": timings,
                       "readings": {k: r["readings"]
                                    for k, r in results.items()},
                       "model_check": model, "main": main},
                      f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    ap.add_argument("--profile", metavar="PATH",
                    help="after the main path, profile two more steps and "
                    "write torch.profiler's table to PATH")
    ap.add_argument("--skip-main", action="store_true",
                    help="skip the gpt2_medium train steps (debugging)")
    args = ap.parse_args()
    try:
        return run(args)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
