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
3. model check: a small GPT and a small llama_tiny with 4 experts (top-2)
   on the card with attention through the kernels against the same weights
   with the reference attention (loss and grads; the reference run takes
   the kernel run's expert choices); then ``moe_ffn`` on the
   card against ``moe_ffn`` on the CPU in f32 at llama_1b's widths (routing
   equal exactly, output within MOE_OUT_RTOL), overflow and tied-router
   cases included;
4. main path: gpt2_medium, batch 12 x seq 1024, remat "dots", 2 warm-up + 5
   timed train steps through GPT -> init_train_state -> make_train_step on
   tokens from a seeded numpy generator; every loss finite, each kernel
   launched its expected count (2 forward per layer: the forward and the
   remat recompute; 1 dQ, 1 dK/dV) in that run; step time, tokens/s, MFU;
5. llama_1b at full width and depth, seq 2048, remat "dots", GQA 16/8 at
   head_dim 128: the largest batch of LLAMA_BATCHES whose train step
   leaves FREE_AT_PEAK_GB free, then the same steps and checks;
6. llama_1b with 4 experts, top-2, at full width and depth, seq 2048, batch
   from MOE_BATCHES the same way; also the load-balance loss (0.5-2.0 at
   the first step), the overflow share and an MFU from the active work;
7. ring attention on the card at llama_1b's attention shape (B 2, H 16 /
   Hk 8, D 128, bf16) over a total sequence of 8192, every sp shard in this
   process (`LoopbackRing`): sp 2 and sp 4 causal, sp 2 non-causal; output,
   dQ, dK and dV against full-sequence `flash_attention` on the same inputs
   (RING_TOL), exact launch counts (sp(sp+1)/2 of each kernel causal, sp²
   non-causal), and the ring's forward and forward+backward ms beside the
   full-sequence kernels';
8. llama_1b at seq 8192 through the sp-4 ring on a loopback mesh, at full
   width and depth (batch from LONG_BATCHES as in phase 5; 10 forward
   partials a layer, twice with the remat recompute, 10 dQ and 10 dK/dV);
   then the same model without a mesh (full-sequence kernels) on the same
   weights and tokens, whose first loss and grad norm the ring's must match
   (LONG_LOSS_RTOL, LONG_GRAD_NORM_RTOL);
9. llama_1b through the process-mesh path on a one-rank NCCL group
   (`build_mesh(MeshSpec(dp=1, fsdp=1, tp=1))`): FSDP2 over (dp, fsdp), the
   tp autograd functions, the vocab-parallel loss and the global-norm clip
   over the mesh's groups, at phase 5's batch on the same weights and
   tokens; the same checks and launches as phase 5, the path's own calls
   counted exactly (FSDP2 holds every parameter as a DTensor), and its
   first loss and grad norm against phase 5's (FSDP_LOSS_RTOL,
   FSDP_GRAD_NORM_RTOL);
10. llama_1b with 4 experts (phase 6's model, batch, weights and tokens)
    through the process-mesh path on the same one-rank NCCL group
    (`MeshSpec(dp=1, fsdp=1, ep=1, tp=1)`): the routing gather over the
    batch group, the batch-group sum of the expert buffers, the ep and tp
    pairs of the expert FFN, FSDP2 over the experts and the clip's sums
    over ep; every parameter a DTensor, each of those calls its exact count
    a step, the launches equal to phase 6's, and the first loss, load-balance
    loss and grad norm against phase 6's (FSDP_LOSS_RTOL,
    FSDP_GRAD_NORM_RTOL);
11. llama_1b (phase 5's model, batch, weights and tokens) through the GPipe
    schedule on `loopback_mesh(MeshSpec(pp=4))`: 4 stages of 4 layers, 4
    microbatches of 4 rows, the flash kernels in every stage (2·L·M forward,
    L·M dQ and L·M dK/dV launches a step), the first loss and grad norm
    against phase 5's (LONG_LOSS_RTOL, LONG_GRAD_NORM_RTOL);
12. the RL learners (``ray_tpu_torch.rl``, CartPole widths, hidden 64 x 64)
    on the card against the same learners on the CPU, from the same seeded
    weights over the same seeded batches: PPO on a [256, 4] minibatch,
    V-trace on [2, 64] fragments with bootstrap_obs, DQN over 5 updates of
    64 rows at target_update_freq 2 (two target syncs); stats within
    RL_STATS_RTOL, parameters within RL_PARAM_RTOL, ms per update on each;
    then JAX's PPO learning test on the port's runtime
    (``PPOConfig().learners(1)``: the learner in an actor with
    ``num_gpus=1``, 2 env runner actors sampling on the CPU, 512 steps
    each, 10 epochs of 256-row minibatches), which fails unless the best
    episode_reward_mean reaches RL_REWARD_BAR within RL_MAX_ITERS
    iterations; prints the iterations, env steps/s and the learner actor's
    ms per update beside (a)'s on the card and on the CPU;
13. the port's runtime on the card: ``ray_tpu_torch.init(num_cpus=4)``
    counts the card as the node's "GPU" resource; a ``num_gpus=1`` task
    sees ``{"GPU": [0]}``, ``CUDA_VISIBLE_DEVICES=0`` and the card, a task
    without a slot sees ``CUDA_VISIBLE_DEVICES=""`` and no card; then an
    actor with ``num_gpus=1`` runs phase 4's steps (same seed-0 weights;
    the tokens sent through ``put`` as a CPU tensor) in its own worker
    process: launches equal to phase 4's, and the first loss and grad norm
    against phase 4's (FSDP_LOSS_RTOL, FSDP_GRAD_NORM_RTOL); the actor
    ``put``s its parameters (CPU f32), the driver ``get``s them and holds
    each tensor to its own phase-4 model's within RUNTIME_PARAM_RTOL
    normwise; put and get seconds and GB/s, the bytes spilled and
    ``/dev/shm``'s size. Under ``--skip-main`` the actor puts 64 MB of
    seeded data instead, and runs no step;
14. the gang trainer: ``TorchTrainer`` with ``ScalingConfig(num_workers=1,
    use_gpu=True, mesh=MeshSpec(dp=1, fsdp=1))`` on
    ``ray_tpu_torch.init(num_cpus=4)``: its worker joins a one-rank NCCL
    group (a FileStore in the experiment directory) and runs phase 4's
    gpt2_medium (same seed-0 weights and tokens, 2 + 5 steps) through the
    process-mesh path, with a sharded checkpoint
    (``torch.distributed.checkpoint``) after step 3; then a second run
    whose loop raises once after that checkpoint and whose restart resumes
    from it. Fails unless the launches per step equal phase 4's, the first
    loss and grad norm match phase 4's (FSDP_LOSS_RTOL,
    FSDP_GRAD_NORM_RTOL) and the resumed steps 4-7 equal the uninterrupted
    run's bit for bit; prints the losses beside phase 4's, the step ms
    (device busy under ``--profile``) and the checkpoint's save and restore
    seconds and bytes;
15. ingest: ``ray_tpu_torch.data.from_numpy`` of 7 batches of 12 rows of
    seq 1024 (``default_rng(1)``: the first batch is phase 4's tokens) in
    5 uneven blocks, through one ``map_batches`` stage of worker tasks, on
    ``ray_tpu_torch.init(num_cpus=4)``. (a) ``Dataset.iter_device_batches``
    feeds a fresh phase-4 model 2 + 5 steps in this process, one new batch
    a step: fails unless every batch is on the card and equals its rows bit
    for bit, the first loss and grad norm equal phase 4's bit for bit,
    every loss is finite and the launches per step equal phase 4's; prints
    the step ms, tokens/s, the host ms of each ``next()`` and (under
    ``--profile``) busy and idle beside phase 4's. (b) phase 14's gang
    (``TorchTrainer(datasets={"train": ...})``, one ``num_gpus=1`` worker,
    ``MeshSpec(dp=1, fsdp=1)``) takes its batches from
    ``get_dataset_shard("train").iter_device_batches``: fails unless its 7
    losses and grad norms equal (a)'s bit for bit and its launches phase
    4's; prints the step ms beside phase 14's and the fit's seconds.
16. the host collectives, MeshGroup, Tune and user metrics on
    ``ray_tpu_torch.init(num_cpus=4)``. (a) the driver, on the card, is
    rank 0 of a ``ray_tpu_torch.comm`` group with two CPU actor ranks:
    phase 4's seed-0 gpt2_medium parameters flattened into one CUDA f32
    tensor (1.419 GB), then a bf16 copy (0.71 GB), each broadcast from the
    driver, all-reduced (sum, each rank contributing what it holds),
    reduce-scattered and all-gathered (a 64 MB slice), sent to rank 1 and
    received back; fails unless every rank's bytes are equal (the actors
    return digests), each result equals its plain version on the card (3x
    the input rounded once) and the driver's results are CUDA tensors of
    the input's dtype; prints each op's seconds and GB/s beside phase 13's
    put and get. Then a ``mesh_group`` host with one CPU and one GPU in its
    bundle reports its slots and builds ``build_local_mesh()`` on one NCCL
    rank. (b) ``tune.Tuner`` over ``grid_search`` of two learning rates
    (make_optimizer's default and 10x), one trial at a time, each trial
    running phase 14's loop through a one-worker ``TorchTrainer`` on the
    card (no checkpoint, no failure): fails unless the trial at the
    default rate gives phase 14's 7 losses and grad norms bit for bit, both
    first losses are equal, ``get_best_result()`` has the lower final loss
    and the trial's gang launched phase 4's counts a step. (c) each trial
    records its step ms in a ``util.metrics.Histogram``; fails unless the
    driver reads a count of 7 for each trial through ``metrics_snapshot()``
    and 14 through ``export_prometheus()``. Prints the phase's seconds.
17. serving: a deployment written here (``GPT2Server``: the package has no
    model server) serves gpt2_medium from seed 0 in one replica with
    ``num_gpus=1`` and ``max_concurrent_queries=16``, batching concurrent
    requests with ``@serve.batch(max_batch_size=12,
    batch_wait_timeout_s=0.02)``: a batch right-pads its prompts to the
    longest rounded up to 128, runs ``model.apply`` under
    ``inference_mode`` and answers each prompt's f32 logits at its last
    position as a CPU tensor; on ``ray_tpu_torch.init(num_cpus=4)``. (a)
    one request carrying phase 4's first batch [12, 1024]: fails unless the
    replica's logits equal the driver's ``model.apply`` of the same tokens
    bit for bit, the driver's forward through the kernel is within
    SERVE_TOL of the same forward through the plain attention, and the
    replica's process launched the forward kernel 24 times (one a layer)
    and dQ and dK/dV none (read there through the replica's
    ``call_method``). (b) 96 single-prompt requests (lengths 128-1024 and
    tokens from ``default_rng(2)``) from 16 closed-loop client threads
    through the handle, each answer within SERVE_TOL of the driver's
    forward of its prompt alone (batch 1, unpadded), the argmax equal where
    the top-2 margin exceeds 2 x atol; prints requests/s, prompt tokens/s,
    p50 and p99 latency, the batches formed (the replica's forwards and the
    access log's rows) and, under ``--profile``, the replica's device busy
    a batch. (c) 8 of (b)'s prompts as JSON through ``serve.start_http``,
    answers as lists within SERVE_TOL. (d) ``serve.delete`` and
    ``serve.run`` again: the new replica gets the card's slot and answers
    (a) bit-equal. (e) ``@serve.multiplexed(max_num_models_per_replica=1)``
    over seeds 0 and 1: loading seed 1 evicts seed 0, the replica's
    ``torch.cuda.memory_allocated()`` after a gc falls back to one model's
    bytes within SERVE_MUX_SLACK, and each seed's answer equals a fresh
    driver model's bit for bit. (f) a two-step ``workflow.run`` (the first
    step a ``num_gpus=1`` task computing (a)'s logits, the second reducing
    them on the CPU) equal to (a)'s argmax and max, and its rerun reading
    the stored output (the step ran once); then a ``StandardAutoscaler``
    over ``FakeNodeProvider`` on a ``Cluster`` whose head has no GPU
    scales a ``{"CPU": 2, "GPU": 1}`` node type up for a queued
    ``num_gpus=1`` task, which sees slot 0 and the card and runs one flash
    forward within phase 2's limits of its plain version, and drains the
    node when it is idle. Prints the phase's seconds.
18. the node main and the head's services: a ``Cluster(process_isolated=
    True)`` whose head node process has no GPU and a second node process
    with one slot (``add_node(num_gpus=1)``), each node's seconds to its
    ready line; ``ray_tpu_torch.nodes()`` must show ``GPU`` 1.0 on the
    second node only. (b) a driver script submitted through
    ``ray_tpu_torch.job.JobSubmissionClient`` at the job address the head
    published attaches with ``init(address=os.environ["RTPU_ADDRESS"])``
    and runs phase 4's path (same weights, tokens and steps) in one
    ``num_gpus=1`` task from this module (``job_task``); fails unless the
    job ends SUCCEEDED, its logs (read through the client) hold the
    driver's result line, the task ran on the GPU node, its losses and
    grad norms equal phase 4's bit for bit and it launched 48 / 24 / 24 a
    step. (c) while the task holds the card the dashboard's snapshot
    (``/api/history``) shows ``gpu_used`` 1.0 and ``python -m
    ray_tpu_torch.scripts.cli status`` on the head's session "GPU: 0 / 1
    available", after the job 0.0 and "1 / 1"; the card is held by the
    task's worker and by neither node
    process nor the job's driver: on the card's machine nvidia-smi names
    every app by a pid of another namespace, so the holders are the
    processes with a /dev/nvidia<N> handle open, and nvidia-smi's count of
    apps must equal their count, before the job and after it (the new
    holder the task's worker). (d) ``Cluster.remove_node`` of the GPU
    node: within NODE_GONE_S its worker has let the card go (nvidia-smi's
    count back to before the job) and the head reports the node dead.
    Prints the job's seconds from submit and the phase's.
19. a GPU runtime's task kinds on ``ray_tpu_torch.init(num_cpus=4)``. (a)
    a ``num_gpus=1`` task with ``num_returns="streaming"`` runs phase 4's
    path (same weights, tokens and steps) in a thread and yields each
    step's loss, grad norm and ms as the step ends, stamped with the
    worker's clock, then the launch counts; fails unless the driver got
    the first item before the last step ended, the losses and grad norms
    equal phase 4's bit for bit and the task launched 48 / 24 / 24 a step.
    Then a ``num_gpus=1`` stream of STREAM_CLOSE_ITEMS sums on the card,
    held by the backpressure window after 2 items are read, is closed:
    its producer must run out and the next ``num_gpus=1`` task start on
    slot 0 within CLOSE_SLOT_S. (b) a CPU task makes phase 4's tokens from
    seed 1, a ``num_gpus=1`` task runs gpt2_medium's seed-0 forward on them
    and returns the f32 logits at the last position (a CPU tensor [12,
    50304]); both objects are freed from the store and the directory, and
    the driver's second get must rebuild them from lineage: each task run
    twice (files in the session directory), the forward's 24 / 0 / 0
    launches both times, the logits bit-equal. Prints the first item's
    seconds beside the stream's, the rebuild's beside the first get's,
    the close-to-slot seconds and the phase's.

``--profile PATH`` profiles two more steps of each train path and writes
one table per path (PATH with the path's name before its suffix), and
one forward of phase 17's replica; ``--skip-main`` skips the train paths,
phases 4-6, 8-11, 14 and 16(b)-(c), phase 13's steps and phase 15's (which
then checks only both iterators' batches, bit for bit on the card) and
phase 17(b)-(f), and phase 18's task trains a 2-layer cut of phase 4's
model at batch 2 x seq 256, as do phase 19's tasks; phase 16(a) then moves
64 MB of seeded f32 in place of the parameters. Prints the
kernels as one JSON line, then the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
CUDA is missing or the package is not beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

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
# moe_ffn in f32 on the card against the CPU (TF32 off): products summed in
# another order, ||out_gpu - out_cpu||_F <= this * ||out_cpu||_F
MOE_OUT_RTOL = 1e-5

# train paths: batches tried in order, each while the one before left at
# least FREE_AT_PEAK_GB of the card's memory free at the step's peak
FREE_AT_PEAK_GB = 8
LLAMA_BATCHES = (4, 8, 12, 16, 24)
MOE_BATCHES = (2, 4)
LONG_BATCHES = (1, 2, 4, 6)

# phase 7: the ring against full-sequence flash attention, both on the
# kernels, by the phase-2 rule (normwise, and per element past one bf16 ulp)
RING_TOL = (6e-3, 1.3e-3)   # (norm_rtol, atol): 2x the readings in PERF.md
RING_SHAPE = (2, 16, 8, 8192, 128)   # B, H, Hk, total S, D
# phase 8: the ring's first step against the no-mesh model's, same weights
LONG_LOSS_RTOL = 1e-3
LONG_GRAD_NORM_RTOL = 1e-2
# phase 9: the process-mesh path's first step against phase 5's
FSDP_LOSS_RTOL = 1e-4
FSDP_GRAD_NORM_RTOL = 2e-3
# phase 12: the RL learners (CartPole widths, hidden 64 x 64), f32 on the
# card against the CPU (TF32 off): every update's stats to RL_STATS_RTOL
# relative, the parameters normwise per tensor to RL_PARAM_RTOL (about 2x
# the largest reading of this comparison, 3.9e-7 for DQN, in PERF.md); the
# PPO loop's bar is JAX's learning test's (tests/test_rl.py:84-106)
RL_OBS, RL_ACTIONS, RL_HIDDEN = 4, 2, (64, 64)
DQN_UPDATES = 5
RL_STATS_RTOL = 1e-5
RL_PARAM_RTOL = 8e-7
RL_REWARD_BAR = 80
RL_MAX_ITERS = 40
# phase 13: the GPU actor's parameters after phase 4's steps against the
# driver's phase-4 model's, normwise per tensor
RUNTIME_PARAM_RTOL = 1e-5
RUNTIME_SKIP_MAIN_MB = 64
ACTOR_PATH = "gpt2_medium_gpu_actor"
# phase 14: the gang trainer, phase 4's 2 + 5 steps with a sharded
# checkpoint after step GANG_CKPT_AT and one injected failure after it
GANG_PATH = "gpt2_medium_gang"
GANG_STEPS = 7
GANG_CKPT_AT = 3
# phase 15: ingest, phase 4's 2 + 5 steps, one new batch from a Dataset each
INGEST_PATH = "gpt2_medium_ingest"
INGEST_GANG_PATH = "gpt2_medium_ingest_gang"
INGEST_BATCHES = 7
INGEST_BLOCKS = 5
# phase 16: the host collectives with the driver on the card as rank 0 of
# COMM_WORLD (the others CPU actors), the reducescatter/allgather slice, the
# ops' explicit timeout (1.4 GB is far over collective_timeout_s's 60 s
# budget at the host's rates); Tune's path and the trials' step histogram
COMM_GROUP = "chip_smoke_comm"
COMM_WORLD = 3
COMM_SLICE_MB = 64
COMM_TIMEOUT_S = 600.0
TUNE_PATH = "gpt2_medium_tune_trial"
TUNE_HIST = "chip_smoke_trial_step_ms"
# phase 17: serving gpt2_medium from one replica on the card. A batch is
# right-padded to its longest prompt rounded up to SERVE_PAD. Each answer
# (the f32 logits at a prompt's last position) is held to the driver's
# forward of the same prompt by SERVE_TOL = (atol, norm_rtol): every
# element within atol, the vector within norm_rtol normwise; the logits
# are bf16 values (the head's output), so atol is a few of their ulps. The
# readings the limits were set from are in PERF.md. The argmax must agree
# wherever the reference's top-2 margin exceeds 2 x atol.
SERVE_PATH = "gpt2_medium_serve"
SERVE_MAX_BATCH = 12
SERVE_WAIT_S = 0.02
SERVE_MAX_QUERIES = 16
SERVE_PAD = 128
SERVE_REQUESTS = 96
SERVE_CLIENTS = 16
SERVE_LENS = (128, 1024)
SERVE_HTTP = 8
SERVE_TOL = (0.125, 3e-2)
# (e): after an eviction the replica holds one model's bytes, within this
SERVE_MUX_SLACK = 64 << 20
SERVE_WORKFLOW = "chip_smoke_logits"

# phase 18: a job on a process-isolated cluster trains phase 4's path in a
# num_gpus=1 task on the GPU node; after remove_node the node's worker must
# leave nvidia-smi's compute apps, and the head report the node dead, within
# NODE_GONE_S seconds
JOB_PATH = "gpt2_medium_job"
JOB_RESULT = "JOB_RESULT "
NODE_GONE_S = 30.0

# phase 19: a streaming num_gpus=1 task trains phase 4's path, and a lost
# result of the card is rebuilt from lineage; a closed stream of
# STREAM_CLOSE_ITEMS items (past the backpressure window) must free the slot
# for the next num_gpus=1 task within CLOSE_SLOT_S seconds
STREAM_PATH = "gpt2_medium_stream"
LINEAGE_PATH = "gpt2_medium_lineage"
STREAM_CLOSE_ITEMS = 100
CLOSE_SLOT_S = 30.0

try:   # phase 17's deployments use the port's serve decorators
    from ray_tpu_torch import serve as _serve
except ImportError:   # run() says the package is missing, and exits
    _serve = None

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


# --- phase 3: small models, kernels vs reference attention; MoE -----------

def model_check(torch, models):
    from ray_tpu_torch.models.gpt import GPTConfig

    return {
        "dense": kernels_vs_reference(torch, models, "dense", GPTConfig(
            vocab_size=512, n_layers=2, d_model=256, n_heads=4,
            max_seq_len=256, remat=False)),
        "moe": kernels_vs_reference(
            torch, models, "llama_tiny 4 experts top-2",
            models.llama_tiny(n_experts=4, moe_top_k=2, remat=False)),
    }


def kernels_vs_reference(torch, models, name, cfg):
    """Loss and grads of `cfg` with attention through the kernels against
    the reference attention, same weights and tokens. With experts, the
    reference run takes the kernel run's expert choices: a token whose two
    best experts lie closer than the kernels' bf16 rounding may pick another
    expert, a step in the function that no tolerance on a continuous error
    covers. How many (token, k) choices would have differed is printed."""
    from ray_tpu_torch.models import moe as moe_mod

    tokens = torch.from_numpy(_tokens(4, 200, cfg.vocab_size, seed=3)).cuda()
    real_top_k = moe_mod.top_k_experts
    chosen, flips = [], [0, 0]

    def recording(probs, k):
        vals, idx = real_top_k(probs, k)
        chosen.append(idx)
        return vals, idx

    def replaying(probs, k):
        idx = chosen[flips[1]]
        flips[0] += int((real_top_k(probs, k)[1] != idx).sum())
        flips[1] += 1
        return probs.gather(-1, idx), idx

    out = {}
    for impl, top_k in (("cuda", recording), ("reference", replaying)):
        c = dataclasses.replace(cfg, attention_impl=impl)
        m = models.GPT(c, seed=0)
        moe_mod.top_k_experts = top_k
        try:
            loss, _ = m.loss({"tokens": tokens})
        finally:
            moe_mod.top_k_experts = real_top_k
        loss.backward()
        out[impl] = (loss.item(), {n: p.grad for n, p in
                                   m.named_parameters()})
    l_k, g_k = out["cuda"]
    l_r, g_r = out["reference"]
    loss_rel = abs(l_k - l_r) / abs(l_r)
    worst, leaf = max((compare(g_k[n], g_r[n])[1], n) for n in g_r)
    routing = (f"; {flips[0]} of {sum(t.numel() for t in chosen)} (token, "
               f"k) expert choices differ, the kernel run's taken"
               if chosen else "")
    log(f"model check [{name}]: loss kernels {l_k:.6f} reference "
        f"{l_r:.6f}, relative gap {loss_rel:.3e} (<= {MODEL_LOSS_RTOL:.0e}); "
        f"worst leaf {leaf} grad norm-relative err {worst:.3e} "
        f"(<= {MODEL_GRAD_RTOL:.0e}){routing}")
    if not (math.isfinite(l_k) and loss_rel <= MODEL_LOSS_RTOL
            and worst <= MODEL_GRAD_RTOL):
        raise SmokeFailure(f"small model [{name}]: kernels disagree with "
                           "reference")
    return {"loss_rel": loss_rel, "worst_grad_norm_rel": worst,
            "worst_leaf": leaf, "expert_choices_differing": flips[0]}


def moe_check(torch):
    """moe_ffn on the card against moe_ffn on the CPU, f32, same inputs:
    512 tokens at llama_1b's widths (d 2048, 4 experts of f 5632). Expert
    choice, slots and `fits` equal exactly; the output normwise within
    MOE_OUT_RTOL; aux loss and overflow printed beside each other."""
    import numpy as np
    from ray_tpu_torch.models.moe import capacity, moe_ffn, route

    b, s, d, e, f = 2, 256, 2048, 4, 5632
    rng = np.random.default_rng(4)
    std = 0.02
    x = rng.standard_normal((b, s, d), dtype=np.float32)
    router = rng.standard_normal((d, e), dtype=np.float32) * std
    w_up = rng.standard_normal((e, d, f), dtype=np.float32) * std
    w_gate = rng.standard_normal((e, d, f), dtype=np.float32) * std
    w_down = rng.standard_normal((e, f, d), dtype=np.float32) * (
        std / math.sqrt(32))
    cases = {"top-2 cf 1.25": (2, 1.25, router),
             "overflow top-2 cf 0.5": (2, 0.5, router),
             "top-1 cf 1.0": (1, 1.0, router),
             "zero router (ties) top-2 cf 1.25": (2, 1.25, 0 * router)}
    out, bad = {}, []
    for name, (k, cf, rw) in cases.items():
        res = {}
        for dev in ("cpu", "cuda"):
            t = [torch.from_numpy(a).to(dev)
                 for a in (x, rw, w_up, w_gate, w_down)]
            r = route(t[0].reshape(b * s, d), t[1], k,
                      capacity(b * s, e, k, cf))
            y, m = moe_ffn(*t, top_k=k, capacity_factor=cf,
                           dtype=torch.float32)
            res[dev] = ({n: r[n].cpu() for n in ("expert_idx", "slot",
                                                  "fits")},
                        y.cpu(), {n: v.item() for n, v in m.items()})
        (r_c, y_c, m_c), (r_g, y_g, m_g) = res["cpu"], res["cuda"]
        same = all(torch.equal(r_c[n], r_g[n]) for n in r_c)
        rel = ((y_g - y_c).norm() / y_c.norm()).item()
        log(f"moe check [{name}]: routing equal {same}; output "
            f"norm-relative err {rel:.3e} (<= {MOE_OUT_RTOL:.0e}); aux "
            f"{m_g['moe_aux_loss']:.7f} (cpu {m_c['moe_aux_loss']:.7f}); "
            f"overflow {m_g['moe_overflow']:.6f} (cpu "
            f"{m_c['moe_overflow']:.6f})")
        if not (same and rel <= MOE_OUT_RTOL and torch.isfinite(y_g).all()):
            bad.append(name)
        out[name] = {"routing_equal": same, "out_norm_rel": rel,
                     "overflow": m_g["moe_overflow"],
                     "aux": m_g["moe_aux_loss"]}
    if out["overflow top-2 cf 0.5"]["overflow"] <= 0:
        bad.append("the overflow case dropped nothing")
    if bad:
        raise SmokeFailure(f"moe_ffn on the card disagrees with the CPU: "
                           f"{bad}")
    return out


def _tokens(b, s, vocab, seed):
    import numpy as np
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int64)


# --- phase 7: ring attention against full-sequence flash attention --------

def ring_check(torch, A, by_path):
    """The loopback ring at llama_1b's attention shape over S 8192, against
    `flash_attention` over the whole sequence on the same inputs: readings,
    exact launch counts (set to 0 just before each ring's forward and
    backward, read just after) and times. Returns the readings."""
    import importlib

    R = importlib.import_module("ray_tpu_torch.ops.ring_attention")
    B, H, Hk, S, D = RING_SHAPE
    norm_tol, atol = RING_TOL
    out, bad = {}, []
    for causal in (True, False):
        q, k, v, do = make_case(torch, B, H, Hk, S, S, D, torch.bfloat16,
                                False, seed=20 + int(causal))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        full = A.flash_attention(*leaves, causal)
        full.backward(do)
        # copies: the timing below accumulates into the leaves' grads
        ref = [full.detach()] + [t.grad.clone() for t in leaves]

        def flash_fb():
            torch.autograd.backward(A.flash_attention(*leaves, causal), do)

        with torch.no_grad():
            flash_fwd_ms = cuda_ms(torch, lambda: A.flash_attention(
                q, k, v, causal))
        flash_fb_ms = cuda_ms(torch, flash_fb)
        for sp in ((2, 4) if causal else (2,)):
            name = f"ring_sp{sp}" + ("" if causal else "_non_causal")
            ring = R.LoopbackRing(sp)
            rleaves = [t.clone().requires_grad_() for t in (q, k, v)]
            shards = [list(t.chunk(sp, dim=2)) for t in rleaves]
            do_shards = list(do.chunk(sp, dim=2))
            torch.cuda.synchronize()
            A.reset_launch_counts()
            outs = R.ring_attention(*shards, ring, causal=causal, impl="cuda")
            torch.autograd.backward(outs, do_shards)
            torch.cuda.synchronize()
            counts = dict(A.launches)
            by_path[name] = counts
            got = [torch.cat(outs, dim=2).detach()] + [t.grad for t in
                                                       rleaves]
            n = sp * (sp + 1) // 2 if causal else sp * sp
            if counts != {k_: n for k_ in counts}:
                bad.append(f"{name}: launches {counts}, expected {n} each")
            readings, parts = {}, []
            for label, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
                err, norm_rel, atol_needed = compare(g, r)
                readings[label] = {"max_abs": err, "norm_rel": norm_rel,
                                   "atol_needed": atol_needed}
                parts.append(f"{label} max {err:.3e}, norm {norm_rel:.3e} "
                             f"(<= {norm_tol:.0e}), atol needed "
                             f"{atol_needed:.3e} (<= {atol:.1e})")
                if not (torch.isfinite(g).all() and norm_rel <= norm_tol
                        and atol_needed <= atol):
                    bad.append(f"{name}: {label}")

            def ring_fb():
                torch.autograd.backward(R.ring_attention(
                    *shards, ring, causal=causal, impl="cuda"), do_shards)

            with torch.no_grad():
                fwd_ms = cuda_ms(torch, lambda: R.ring_attention(
                    *[[t.detach() for t in sh] for sh in shards], ring,
                    causal=causal, impl="cuda"))
            fb_ms = cuda_ms(torch, ring_fb)
            log(f"ring [{name} B{B} H{H} Hk{Hk} S{S} D{D}]: launches "
                f"{counts}; " + "; ".join(parts))
            log(f"ring [{name}]: forward {fwd_ms:.4f} ms (full-sequence "
                f"flash {flash_fwd_ms:.4f} ms), forward+backward "
                f"{fb_ms:.4f} ms (flash {flash_fb_ms:.4f} ms)")
            out[name] = {"launches": counts, "readings": readings,
                         "ms": fwd_ms, "fwd_bwd_ms": fb_ms,
                         "flash_ms": flash_fwd_ms,
                         "flash_fwd_bwd_ms": flash_fb_ms}
        del q, k, v, do, leaves, full, ref
    torch.cuda.empty_cache()
    if bad:
        raise SmokeFailure("ring attention disagrees with flash attention: "
                           + "; ".join(bad))
    return out


# --- phases 4-6 and 8: train paths ------------------------------------------

def kernel_class(name: str) -> str:
    name = name.lower()
    if "flash_" in name:
        return "flash kernels"
    if any(w in name for w in ("gemm", "xmma", "cutlass", "matmul", "nvjet",
                               "sm90_")):
        return "matrix products"
    return "other"


def profile_steps(torch, fn, path, step_ms, n=2, moe_dims=None):
    """Device time by kernel class over `n` more calls of `fn`, one step each
    (torch.profiler), the full table written to `path` unless it is None;
    returns the per-step summary, the kernels launched per step included.
    The idle share is taken against `step_ms`, the step time measured
    without the profiler (whose host overhead stretches the profiled steps).

    `moe_dims` = (tokens T, capacity C, experts x capacity E*C) adds the
    class "MoE dispatch and combine": the kernels of every op that has an
    input with a dimension E*C, or of shape [T, ..., C] (building the
    [T, E, C] dispatch and combine tensors, and the products with them,
    forward and backward). The per-expert products ([E, C, *]) stay matrix
    products."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=moe_dims is not None) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    classes = {"flash kernels": 0.0, "matrix products": 0.0, "other": 0.0}
    kernels = 0
    for evt in prof.key_averages():
        if evt.device_type.name != "CUDA":
            continue
        classes[kernel_class(evt.key)] += evt.self_device_time_total
        kernels += evt.count
    if moe_dims is not None:
        n_tok, cap, ec = moe_dims
        moe = 0.0
        for evt in prof.events():
            if evt.device_type.name != "CPU" or not any(
                    ec in shape or (shape[0] == n_tok and shape[-1] == cap)
                    for shape in evt.input_shapes or () if shape):
                continue
            for kern in evt.kernels:
                cls = kernel_class(kern.name)
                if cls != "flash kernels":
                    classes[cls] -= kern.duration
                    moe += kern.duration
        classes["MoE dispatch and combine"] = moe
    per_step = {k: v / 1e3 / n for k, v in classes.items()}
    busy = sum(per_step.values())
    if path is not None:
        with open(path, "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=60))
    idle = max(0.0, 1 - busy / step_ms)
    log(f"profile ({n} steps, {path}): device busy {busy:.4f} ms/step, idle "
        f"share {idle:.3f} of the unprofiled {step_ms:.4f} ms step (profiled "
        f"wall {wall_ms:.4f} ms/step, {kernels / n:.0f} kernels); by class "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in per_step.items()))
    return {"profiled_wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": idle, "by_class_ms": per_step,
            "kernels": kernels / n}


def pick_batch(torch, step, state, cfg, batches, name):
    """The largest of `batches`, tried in order, whose train step leaves
    FREE_AT_PEAK_GB of the card free at its peak (reserved memory); stops
    at the first that does not, or that runs out of memory. A tried step
    runs at the schedule's count 0, where lr = 0, so the params do not
    move; the moments and counts go back to the start after it."""
    total = torch.cuda.mem_get_info()[1]
    chosen, tried = None, []
    for b in batches:
        tokens = torch.from_numpy(_tokens(b, cfg.max_seq_len, cfg.vocab_size,
                                          seed=1)).cuda()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        oom = False
        try:
            step(state, {"tokens": tokens})
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            oom = True
        for p in state.params.values():
            p.grad = None
        opt = state.opt_state
        torch._foreach_zero_(list(opt["mu"].values()))
        torch._foreach_zero_(list(opt["nu"].values()))
        opt["count"] = 0
        state.step = 0
        del tokens
        if oom:
            tried.append({"batch": b, "out_of_memory": True})
            log(f"{name}: batch {b} ran out of memory")
            break
        free = (total - torch.cuda.max_memory_reserved()) / 1e9
        tried.append({"batch": b, "out_of_memory": False,
                      "peak_allocated_gb":
                          torch.cuda.max_memory_allocated() / 1e9,
                      "peak_reserved_gb":
                          torch.cuda.max_memory_reserved() / 1e9,
                      "free_at_peak_gb": free})
        log(f"{name}: batch {b}: peak allocated "
            f"{tried[-1]['peak_allocated_gb']:.2f} GB, reserved "
            f"{tried[-1]['peak_reserved_gb']:.2f} GB, free at peak "
            f"{free:.2f} GB of {total / 1e9:.2f} GB")
        if free < FREE_AT_PEAK_GB:
            break
        chosen = b
    gc.collect()
    torch.cuda.empty_cache()
    if chosen is None:
        raise SmokeFailure(f"{name}: no batch of {batches} leaves "
                           f"{FREE_AT_PEAK_GB} GB free: {tried}")
    log(f"{name}: batches tried {[t['batch'] for t in tried]}, chose "
        f"{chosen}")
    return chosen, tried


def moe_overflow(torch, model, tokens):
    """Mean over layers of moe_ffn's overflow share on `tokens`, from one
    forward without gradients: the block drops it, as the JAX block does,
    so a wrapper around moe_ffn reads it."""
    from ray_tpu_torch.models import gpt as G

    real, seen = G.moe_ffn, []

    def reading(*args, **kw):
        out, m = real(*args, **kw)
        seen.append(m["moe_overflow"])
        return out, m

    G.moe_ffn = reading
    try:
        with torch.no_grad():
            model.forward_with_aux(tokens)
    finally:
        G.moe_ffn = real
    return float(torch.stack(seen).mean())


def moe_active_flops(cfg, n_tokens):
    """Train flops per token of the work the MoE model does for it, and
    the formula: 6 x the active params (attention, top_k of the experts,
    router), 12·L·d·S of attention scores, 6·d·V of the head, and 12·L·E·C·d
    of the dispatch and combine products (2·E·C·d each per token forward)."""
    from ray_tpu_torch.models.moe import capacity

    d, f, L, S, V = (cfg.d_model, cfg.ff_dim, cfg.n_layers, cfg.max_seq_len,
                     cfg.vocab_size)
    E, K = cfg.n_experts, cfg.moe_top_k
    C = capacity(n_tokens, E, K, cfg.moe_capacity_factor)
    hd, h, hk = cfg.head_dim, cfg.n_heads, cfg.kv_heads
    attn = d * h * hd + 2 * d * hk * hd + h * hd * d
    flops = (6.0 * L * (attn + K * 3 * d * f + d * E) + 12 * L * d * S
             + 6 * d * V + 12.0 * L * E * C * d)
    return flops, (f"6*L*(attn {attn} + k*3*d*f + d*E) + 12*L*d*S + 6*d*V "
                   f"+ 12*L*E*C*d with L={L} d={d} f={f} E={E} k={K} C={C} "
                   f"S={S} V={V}")


def train_path(torch, A, models, smi_name, name, cfg, batches, warmup=2,
               steps=5, profile_path=None, mesh=None, calls=None,
               tokens=None, params_out=None, on_step=None):
    """Train steps of `cfg` at seq cfg.max_seq_len through GPT ->
    init_train_state -> make_train_step (on `mesh` when given) on tokens
    from a seeded numpy generator: the batch from `batches` (pick_batch
    when there are several), then `warmup` + `steps` steps with the launch
    counts (and the call counts of `calls`, a `counting` dict) set to 0
    just before and read just after. `tokens` (a CPU tensor) replaces the
    generated ones; `params_out`, a dict, receives the parameters after
    the steps as CPU f32 tensors; `on_step(i, loss, grad_norm, ms)` is
    called as each step ends (which then waits for the card: the step's ms
    and the timed steps' include the wait). Returns (counts, result)."""
    from ray_tpu_torch.models.moe import capacity
    from ray_tpu_torch.models.training import flops_per_token

    seq = cfg.max_seq_len
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model = models.GPT(cfg, seed=0, mesh=mesh)
    torch.cuda.synchronize()
    build_peak_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
    param_gib = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 2**30
    opt = models.make_optimizer(total_steps=steps + warmup)
    state = models.init_train_state(model, opt, mesh=mesh)
    step = models.make_train_step(model, opt, mesh=mesh)
    torch.cuda.synchronize()
    log(f"{name}: {cfg.n_params / 1e6:.1f}M params built in "
        f"{time.perf_counter() - t0:.1f}s; peak memory while GPT() built "
        f"them {build_peak_gib:.2f} GiB, the parameters {param_gib:.2f} GiB")
    tried = None
    batch = batches[0]
    if len(batches) > 1:
        batch, tried = pick_batch(torch, step, state, cfg, batches, name)
    if tokens is None:
        tokens = torch.from_numpy(_tokens(batch, seq, cfg.vocab_size,
                                          seed=1))
    tokens = tokens.cuda()
    batch_dict = {"tokens": tokens}
    moe = cfg.n_experts > 0
    result = {"batch": batch, "seq": seq, "batches_tried": tried,
              "build_peak_gib": build_peak_gib, "param_gib": param_gib}
    if mesh is not None and not mesh.loopback:
        from torch.distributed.tensor import DTensor
        params = list(model.parameters())
        result["dtensor_params"] = (sum(isinstance(p, DTensor)
                                        for p in params), len(params))
    if moe:
        result["overflow_at_init"] = moe_overflow(torch, model, tokens)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    for k in calls or ():
        calls[k] = 0
    metrics = []

    def take_step():
        nonlocal state
        t = time.perf_counter()
        state, m = step(state, batch_dict)
        metrics.append(m)
        if on_step is not None:
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            on_step(len(metrics) - 1, loss, norm,
                    (time.perf_counter() - t) * 1e3)

    for _ in range(warmup):
        take_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        take_step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(A.launches)
    if calls is not None:
        result["calls"] = dict(calls)
    if params_out is not None:
        params_out.update({n: p.detach().float().cpu()
                           for n, p in model.named_parameters()})
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(m["loss"]) for m in metrics]
    grad_norms = [float(m["grad_norm"]) for m in metrics]
    n_steps = warmup + steps

    step_s = dt / steps
    tok_s = batch * seq / step_s
    peak = next((v for k, v in MFU_PEAK if k in smi_name), PEAK_BF16_FLOPS)
    mfu = tok_s * flops_per_token(cfg) / peak
    per_step = {k: v / n_steps for k, v in counts.items()}
    log(f"{name}: losses {losses}; grad_norm {grad_norms}")
    log(f"{name}: batch {batch} x seq {seq}, step {step_s * 1e3:.1f} ms, "
        f"{tok_s:.0f} tokens/s, MFU {mfu:.4f} by flops_per_token (peak "
        f"{peak / 1e12:.0f} TFLOP/s), peak memory {peak_gib:.2f} GiB, "
        f"kernel launches per step {per_step}")
    result.update({"step_ms": step_s * 1e3, "tokens_per_s": tok_s,
                   "mfu": mfu, "mfu_peak_flops": peak, "losses": losses,
                   "grad_norms": grad_norms, "launches_per_step": per_step,
                   "peak_mem_gib": peak_gib})
    if not all(math.isfinite(x) for x in losses + grad_norms):
        raise SmokeFailure(f"{name}: non-finite loss or grad norm: {losses}")
    # random init: the first loss is close to ln(vocab) (with experts, plus
    # 0.01 x a load-balance loss near 1)
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise SmokeFailure(f"{name}: first loss {losses[0]} far from "
                           f"ln(V)={math.log(cfg.vocab_size):.3f}")
    # per layer and step: the forward twice (forward and remat recompute),
    # dQ and dK/dV once; through a causal ring, sp(sp+1)/2 partials each;
    # through a pipeline, once per microbatch
    fwd = 2 if cfg.remat else 1
    sp = mesh.shape["sp"] if mesh is not None else 1
    pp = mesh.shape["pp"] if mesh is not None else 1
    micro = (cfg.pp_microbatches or pp) if pp > 1 else 1
    calls = cfg.n_layers * sp * (sp + 1) // 2 * micro
    expected = {"flash_fwd": fwd * calls, "flash_bwd_dq": calls,
                "flash_bwd_dkv": calls}
    wrong = {k: v for k, v in counts.items() if v != expected[k] * n_steps}
    if wrong:
        raise SmokeFailure(f"{name}: kernel launches {wrong} in {n_steps} "
                           f"steps, expected {expected} per step")
    if moe:
        aux = [float(m["moe_aux_loss"]) for m in metrics]
        active, formula = moe_active_flops(cfg, batch * seq)
        mfu_active = tok_s * active / peak
        result.update({"moe_aux_loss": aux, "mfu_active": mfu_active,
                       "active_flops_per_token": active,
                       "overflow_after": moe_overflow(torch, model, tokens)})
        log(f"{name}: moe_aux_loss {aux}; overflow share at init "
            f"{result['overflow_at_init']:.4f}, after {n_steps} steps "
            f"{result['overflow_after']:.4f}; MFU from the active work "
            f"{mfu_active:.4f} = tokens/s x {active / 1e9:.3f} GFLOP/token "
            f"/ peak, GFLOP/token = {formula}")
        if not 0.5 < aux[0] < 2.0:
            raise SmokeFailure(f"{name}: first load-balance loss {aux[0]} "
                               "outside (0.5, 2.0)")
    if profile_path:
        moe_dims = None
        if moe:
            n_tok = batch * seq
            cap = capacity(n_tok, cfg.n_experts, cfg.moe_top_k,
                           cfg.moe_capacity_factor)
            moe_dims = (n_tok, cap, cfg.n_experts * cap)
        path = Path(profile_path)

        def one_step():
            nonlocal state
            state, _ = step(state, batch_dict)

        result["profile"] = profile_steps(
            torch, one_step,
            path.with_name(f"{path.stem}.{name}{path.suffix}"),
            step_s * 1e3, moe_dims=moe_dims)
    return counts, result


def long_context(torch, A, models, smi, cfg, names, by_path, profile):
    """Phase 8: `cfg` through the sp-4 ring on a loopback mesh, then without
    a mesh at the batch the ring path chose; the first loss and grad norm
    of the two must agree."""
    from ray_tpu_torch.parallel import MeshSpec, loopback_mesh

    ring_name, flat_name = names
    out = {}
    by_path[ring_name], out[ring_name] = train_path(
        torch, A, models, smi, ring_name, cfg, LONG_BATCHES,
        profile_path=profile, mesh=loopback_mesh(MeshSpec(dp=1, sp=4)))
    gc.collect()
    torch.cuda.empty_cache()
    by_path[flat_name], out[flat_name] = train_path(
        torch, A, models, smi, flat_name, cfg, (out[ring_name]["batch"],),
        profile_path=profile)
    gc.collect()
    torch.cuda.empty_cache()
    r, f = out[ring_name], out[flat_name]
    loss_rel = abs(r["losses"][0] - f["losses"][0]) / abs(f["losses"][0])
    norm_rel = abs(r["grad_norms"][0] - f["grad_norms"][0]) / abs(
        f["grad_norms"][0])
    log(f"long context: first loss ring {r['losses'][0]:.6f} no mesh "
        f"{f['losses'][0]:.6f}, relative gap {loss_rel:.3e} (<= "
        f"{LONG_LOSS_RTOL:.0e}); first grad norm ring "
        f"{r['grad_norms'][0]:.6f} no mesh {f['grad_norms'][0]:.6f}, "
        f"relative gap {norm_rel:.3e} (<= {LONG_GRAD_NORM_RTOL:.0e})")
    out["first_loss_rel"], out["first_grad_norm_rel"] = loss_rel, norm_rel
    if not (loss_rel <= LONG_LOSS_RTOL and norm_rel <= LONG_GRAD_NORM_RTOL):
        raise SmokeFailure("long context: the ring's first step disagrees "
                           "with the no-mesh model's")
    return out


def counting(module, names, counts=None, prefix=""):
    """Wrap each function `names` of `module` so that its calls are counted
    (in the returned dict, or in `counts`, under `prefix` + name);
    `restore()` puts the originals back."""
    counts = {} if counts is None else counts
    counts.update({prefix + n: 0 for n in names})
    real = {n: getattr(module, n) for n in names}

    def wrap(n):
        def counted(*args, **kw):
            counts[prefix + n] += 1
            return real[n](*args, **kw)
        return counted

    for n in names:
        setattr(module, n, wrap(n))

    def restore():
        for n, f in real.items():
            setattr(module, n, f)
    return counts, restore


@contextlib.contextmanager
def one_rank_nccl(torch):
    """The default process group: NCCL over this one card, an in-memory
    store (no network); destroyed on the way out."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()


def fsdp_tp_path(torch, A, models, smi, cfg, base, name, by_path, profile):
    """Phase 9: `cfg` on a process mesh of one rank over NCCL (the caller's
    default group), through the same FSDP2 wrapping, tp autograd functions,
    vocab-parallel loss and global-norm clip as a mesh of many ranks, at
    phase 5's batch (`base`) on the same weights and tokens. Fails unless
    every parameter is an FSDP2 DTensor, each tp function and the clip's
    sums ran their exact count a step, and the first loss and grad norm
    match phase 5's."""
    from ray_tpu_torch.models import gpt as G
    from ray_tpu_torch.models import training as T
    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    tp_calls, restore_tp = counting(
        G, ("copy_to_tp", "reduce_from_tp", "gather_from_tp"))
    clip_calls, restore_clip = counting(T, ("_global_norms",))
    try:
        t0 = time.perf_counter()
        mesh = build_mesh(MeshSpec(dp=1, fsdp=1, tp=1), device_type="cuda")
        log(f"{name}: NCCL group of 1 rank and its mesh in "
            f"{time.perf_counter() - t0:.1f}s")
        by_path[name], out = train_path(
            torch, A, models, smi, name, cfg, (base["batch"],),
            profile_path=profile, mesh=mesh)
    finally:
        restore_tp()
        restore_clip()
    # per step: into each block half's column-parallel products and the head
    # (2L + 1), out of each row-parallel product and the embedding (2L + 1);
    # the recompute repeats the blocks' inputs (2L) and the attention
    # half's output (L: it stops early, before the MLP's output, which no
    # backward needs); one loss gather; one clip. Profiled steps count too.
    L = cfg.n_layers
    n_steps = len(out["losses"]) + (2 if profile else 0)
    remat = 1 if cfg.remat else 0
    want = {"copy_to_tp": 2 * L + 1 + 2 * L * remat,
            "reduce_from_tp": 2 * L + 1 + L * remat, "gather_from_tp": 1,
            "_global_norms": 1}
    got = {k: v / n_steps for k, v in {**tp_calls, **clip_calls}.items()}
    loss_rel = abs(out["losses"][0] - base["losses"][0]) / abs(
        base["losses"][0])
    norm_rel = abs(out["grad_norms"][0] - base["grad_norms"][0]) / abs(
        base["grad_norms"][0])
    out.update(calls_per_step=got, first_loss_rel=loss_rel,
               first_grad_norm_rel=norm_rel)
    log(f"{name}: FSDP2 DTensor parameters {out['dtensor_params']}; calls "
        f"per step {got} (expected {want})")
    log(f"{name}: peak memory while GPT() built the rank's shards "
        f"{out['build_peak_gib']:.2f} GiB for {out['param_gib']:.2f} GiB of "
        f"parameters (each tensor cut as it is drawn: its shards and one "
        f"full tensor); drawing every full tensor and then slicing, as the "
        f"build did before, holds both at once: "
        f"{2 * out['param_gib']:.2f} GiB, computed ({smi})")
    log(f"{name}: beside llama_1b (phase 5), batch {base['batch']}: step "
        f"{out['step_ms']:.1f} ms ({base['step_ms']:.1f}), "
        f"{out['tokens_per_s']:.0f} tokens/s ({base['tokens_per_s']:.0f}), "
        f"MFU {out['mfu']:.4f} ({base['mfu']:.4f}), peak "
        f"{out['peak_mem_gib']:.2f} GiB ({base['peak_mem_gib']:.2f})"
        + (f", idle share {out['profile']['idle_share']:.3f} "
           f"({base['profile']['idle_share']:.3f})" if profile else "")
        + f"; first loss {out['losses'][0]:.6f} ({base['losses'][0]:.6f}), "
        f"relative gap {loss_rel:.3e} (<= {FSDP_LOSS_RTOL:.0e}); first grad "
        f"norm {out['grad_norms'][0]:.6f} ({base['grad_norms'][0]:.6f}), "
        f"relative gap {norm_rel:.3e} (<= {FSDP_GRAD_NORM_RTOL:.0e}); losses "
        f"equal to phase 5's: {out['losses'] == base['losses']}")
    dt, n_params = out["dtensor_params"]
    if dt != n_params or dt == 0:
        raise SmokeFailure(f"{name}: {dt} of {n_params} parameters are "
                           "FSDP2 DTensors")
    if got != want:
        raise SmokeFailure(f"{name}: calls per step {got}, expected {want}")
    if not (loss_rel <= FSDP_LOSS_RTOL and norm_rel <= FSDP_GRAD_NORM_RTOL):
        raise SmokeFailure(f"{name}: the first step disagrees with phase 5's")
    return out


def moe_mesh_path(torch, A, models, smi, cfg, base, name, by_path, profile):
    """Phase 10: the MoE `cfg` on a process mesh of one rank over NCCL (the
    caller's default group) at phase 6's batch (`base`), on the same
    weights and tokens: the routing gather, the batch-group sum of the
    expert buffers, the ep and tp pairs, FSDP2 over the experts and the
    clip's sums over ep, each a copy at one rank. Fails unless every
    parameter is an FSDP2 DTensor, each of those calls ran its exact count
    a step, the launches equal phase 6's, and the first loss, load-balance
    loss and grad norm match phase 6's."""
    from ray_tpu_torch.models import gpt as G
    from ray_tpu_torch.models import moe as MOE
    from ray_tpu_torch.models import training as T
    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    calls, restores = {}, []
    for mod, prefix, fns in (
            (G, "gpt.", ("copy_to_tp", "reduce_from_tp", "gather_from_tp")),
            (MOE, "moe.", ("copy_to_tp", "reduce_from_tp", "copy_to_ep",
                           "reduce_from_ep", "sum_over_batch",
                           "gather_over_batch")),
            (T, "", ("_global_norms",))):
        restores.append(counting(mod, fns, calls, prefix)[1])
    try:
        t0 = time.perf_counter()
        mesh = build_mesh(MeshSpec(dp=1, fsdp=1, ep=1, tp=1),
                          device_type="cuda")
        log(f"{name}: mesh over the one-rank NCCL group in "
            f"{time.perf_counter() - t0:.1f}s")
        by_path[name], out = train_path(
            torch, A, models, smi, name, cfg, (base["batch"],),
            profile_path=profile, mesh=mesh, calls=calls)
    finally:
        for restore in restores:
            restore()
    # per step, the forward and the block checkpoint's recompute (passes):
    # gpt's tp pair in each attention half (L a pass) and the head and the
    # embedding (1); moe's tp pair, ep output sum, batch-group sum and
    # routing gather once a layer a pass, copy_to_ep twice (the tokens and
    # the gates); one loss gather, one clip
    L = cfg.n_layers
    passes = 2 if cfg.remat else 1
    want = {"gpt.copy_to_tp": L * passes + 1,
            "gpt.reduce_from_tp": L * passes + 1, "gpt.gather_from_tp": 1,
            "moe.copy_to_tp": L * passes, "moe.reduce_from_tp": L * passes,
            "moe.copy_to_ep": 2 * L * passes,
            "moe.reduce_from_ep": L * passes,
            "moe.sum_over_batch": L * passes,
            "moe.gather_over_batch": L * passes, "_global_norms": 1}
    n_steps = len(out["losses"])
    got = {k: v / n_steps for k, v in out["calls"].items()}
    keys = ("losses", "moe_aux_loss", "grad_norms")
    gaps = {k: abs(out[k][0] - base[k][0]) / abs(base[k][0]) for k in keys}
    equal = {k: out[k] == base[k] for k in keys}
    out.update(calls_per_step=got, first_gaps=gaps, equal_to_phase6=equal)
    log(f"{name}: FSDP2 DTensor parameters {out['dtensor_params']}; calls "
        f"per step {got} (expected {want}); launches {by_path[name]} "
        f"(phase 6: {by_path['llama_1b_moe']})")
    log(f"{name}: beside llama_1b MoE (phase 6), batch {base['batch']}: step "
        f"{out['step_ms']:.1f} ms ({base['step_ms']:.1f}), "
        f"{out['tokens_per_s']:.0f} tokens/s ({base['tokens_per_s']:.0f}), "
        f"MFU {out['mfu']:.4f} ({base['mfu']:.4f}), active-work MFU "
        f"{out['mfu_active']:.4f} ({base['mfu_active']:.4f}), peak "
        f"{out['peak_mem_gib']:.2f} GiB ({base['peak_mem_gib']:.2f}); first "
        f"loss {out['losses'][0]:.6f} ({base['losses'][0]:.6f}), aux "
        f"{out['moe_aux_loss'][0]:.7f} ({base['moe_aux_loss'][0]:.7f}), grad "
        f"norm {out['grad_norms'][0]:.6f} ({base['grad_norms'][0]:.6f}); "
        f"relative gaps {gaps} (loss and aux <= {FSDP_LOSS_RTOL:.0e}, grad "
        f"norm <= {FSDP_GRAD_NORM_RTOL:.0e}); all 7 equal to phase 6's bit "
        f"for bit: {equal}")
    dt, n_params = out["dtensor_params"]
    if dt != n_params or dt == 0:
        raise SmokeFailure(f"{name}: {dt} of {n_params} parameters are "
                           "FSDP2 DTensors")
    if got != want:
        raise SmokeFailure(f"{name}: calls per step {got}, expected {want}")
    if by_path[name] != by_path["llama_1b_moe"]:
        raise SmokeFailure(f"{name}: launches {by_path[name]}, phase 6 "
                           f"{by_path['llama_1b_moe']}")
    if not (gaps["losses"] <= FSDP_LOSS_RTOL
            and gaps["moe_aux_loss"] <= FSDP_LOSS_RTOL
            and gaps["grad_norms"] <= FSDP_GRAD_NORM_RTOL):
        raise SmokeFailure(f"{name}: the first step disagrees with phase 6's")
    return out


def pipeline_path(torch, A, models, smi, cfg, base, name, by_path, profile):
    """Phase 11: `cfg` (with pp_microbatches) through the GPipe schedule on
    a loopback mesh of 4 stages, every stage in this process, at phase 5's
    batch (`base`) on the same weights and tokens; train_path holds the
    launches to 2·L·M forward, L·M dQ and L·M dK/dV a step. Fails unless
    the first loss and grad norm match phase 5's (the products run on
    microbatches of batch / M rows, where cuBLAS may sum in another
    order)."""
    from ray_tpu_torch.parallel import MeshSpec, loopback_mesh

    P = 4
    M = cfg.pp_microbatches or P
    by_path[name], out = train_path(
        torch, A, models, smi, name, cfg, (base["batch"],),
        profile_path=profile, mesh=loopback_mesh(MeshSpec(pp=P)))
    loss_rel = abs(out["losses"][0] - base["losses"][0]) / abs(
        base["losses"][0])
    norm_rel = abs(out["grad_norms"][0] - base["grad_norms"][0]) / abs(
        base["grad_norms"][0])
    out.update(first_loss_rel=loss_rel, first_grad_norm_rel=norm_rel)
    log(f"{name}: beside llama_1b (phase 5), batch {base['batch']} as {M} "
        f"microbatches through {P} stages in one process (the bubble (M + P "
        f"- 1) / M = {(M + P - 1) / M:.2f} waits for several cards): step "
        f"{out['step_ms']:.1f} ms ({base['step_ms']:.1f}), "
        f"{out['tokens_per_s']:.0f} tokens/s ({base['tokens_per_s']:.0f}), "
        f"MFU {out['mfu']:.4f} ({base['mfu']:.4f}), peak "
        f"{out['peak_mem_gib']:.2f} GiB ({base['peak_mem_gib']:.2f}); first "
        f"loss {out['losses'][0]:.6f} ({base['losses'][0]:.6f}), relative "
        f"gap {loss_rel:.3e} (<= {LONG_LOSS_RTOL:.0e}); first grad norm "
        f"{out['grad_norms'][0]:.6f} ({base['grad_norms'][0]:.6f}), "
        f"relative gap {norm_rel:.3e} (<= {LONG_GRAD_NORM_RTOL:.0e})")
    if not (loss_rel <= LONG_LOSS_RTOL and norm_rel <= LONG_GRAD_NORM_RTOL):
        raise SmokeFailure(f"{name}: the first step disagrees with phase 5's")
    return out


# --- phase 12: the RL learners on the card ----------------------------------

def rl_weights(kind: str, seed: int):
    """Weights in the JAX modules' pytree layout (what `params_from_jax`
    takes), CartPole widths, hidden 64 x 64, drawn from `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def dense(n_in, n_out):
        return {"w": (rng.standard_normal((n_in, n_out))
                      / math.sqrt(n_in)).astype(np.float32),
                "b": (0.1 * rng.standard_normal(n_out)).astype(np.float32)}

    widths = (RL_OBS,) + RL_HIDDEN
    nested = {"torso": [dense(a, b) for a, b in zip(widths, widths[1:])]}
    heads = ({"pi": RL_ACTIONS, "vf": 1} if kind == "policy"
             else {"q": RL_ACTIONS})
    nested.update({h: dense(widths[-1], n) for h, n in heads.items()})
    return nested


def rl_batches(kind: str, seed: int):
    """Phase 12(a)'s batches from `numpy.random.default_rng(seed)`: a PPO
    minibatch [256, 4], V-trace fragments [2, 64] with bootstrap_obs, or
    DQN_UPDATES batches of 64 transitions."""
    import numpy as np
    from ray_tpu_torch.rl import NEXT_OBS
    from ray_tpu_torch.rl import sample_batch as SB

    rng = np.random.default_rng(seed)

    def logp(shape):
        return (np.log(0.5) + 0.3 * rng.standard_normal(shape)).astype(
            np.float32)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def actions(*shape):
        return rng.integers(0, RL_ACTIONS, shape).astype(np.int32)

    if kind == "ppo":
        n = 256
        return [{SB.OBS: normal(n, RL_OBS), SB.ACTIONS: actions(n),
                 SB.LOGP: logp(n), SB.ADVANTAGES: normal(n),
                 SB.VALUE_TARGETS: normal(n)}]
    if kind == "vtrace":
        b, t = 2, 64
        dones = rng.random((b, t)) < 0.05
        dones[0, 10] = dones[1, 40] = True
        return [{SB.OBS: normal(b, t, RL_OBS), SB.ACTIONS: actions(b, t),
                 SB.REWARDS: normal(b, t), SB.DONES: dones,
                 SB.LOGP: logp((b, t)),
                 "bootstrap_obs": normal(b, RL_OBS)}]
    n = 64
    return [{SB.OBS: normal(n, RL_OBS), SB.ACTIONS: actions(n),
             SB.REWARDS: normal(n), NEXT_OBS: normal(n, RL_OBS),
             SB.DONES: rng.random(n) < 0.1} for _ in range(DQN_UPDATES)]


def rl_learner(rl, kind: str, device: str):
    if kind == "dqn":
        learner = rl.DQNLearner(rl.QNetworkModule(RL_OBS, RL_ACTIONS),
                                lr=1e-2, gamma=0.9, target_update_freq=2,
                                huber_delta=0.5, device=device)
        state = rl.params_from_jax(rl_weights("q", 12))
        learner.module.load_state_dict(state)
        learner.target_module.load_state_dict(state)
        return learner
    learner = rl.Learner(rl.DiscretePolicyModule(RL_OBS, RL_ACTIONS),
                         loss=kind, lr=1e-3, entropy_coeff=0.01, gamma=0.9,
                         c_clip=0.9, device=device)
    learner.set_weights(rl_weights("policy", 12))
    return learner


def rl_learner_check(torch, rl, smi):
    """Phase 12(a): each learner on the card and on the CPU from the same
    weights over the same batches: every update's stats within
    RL_STATS_RTOL, the parameters (and DQN's target network) normwise within
    RL_PARAM_RTOL; then its ms per update on each, and on the card the
    device's busy time and kernels per update (torch.profiler)."""
    import numpy as np

    out, failed = {}, []
    for kind in ("ppo", "vtrace", "dqn"):
        batches = rl_batches(kind, 12)
        gpu, cpu = (rl_learner(rl, kind, d) for d in ("cuda", "cpu"))
        stats_err = 0.0
        for batch in batches:
            got, want = gpu.update(batch), cpu.update(batch)
            if not all(math.isfinite(v) for v in got.values()):
                failed.append(f"{kind}: stats not finite {got}")
            stats_err = max([stats_err] + [abs(got[k] - want[k])
                                           / (abs(want[k]) or 1.0)
                                           for k in want])
        modules = [("module", gpu.module, cpu.module)]
        if kind == "dqn":
            modules.append(("target", gpu.target_module, cpu.target_module))
        param_err = 0.0
        for _, g, c in modules:
            for (n, pg), pc in zip(g.state_dict().items(),
                                   c.state_dict().values()):
                pc = pc.double()
                param_err = max(param_err, float(
                    (pg.cpu().double() - pc).norm() / pc.norm()))
        # ms per update (after the comparison: these updates move on)
        tb = batches[-1]
        ms = cuda_ms(torch, lambda: gpu.update(tb), iters=50, warmup=5)
        prof = profile_steps(torch, lambda: gpu.update(tb), None, ms, n=20)
        busy, kernels = prof["busy_ms"], prof["kernels"]
        cpu.update(tb)
        t0 = time.perf_counter()
        for _ in range(20):
            cpu.update(tb)
        cpu_ms = (time.perf_counter() - t0) / 20 * 1e3
        out[kind] = {"updates": len(batches), "stats_max_rel": stats_err,
                     "param_max_norm_rel": param_err, "ms": ms,
                     "busy_ms": busy, "kernels": kernels,
                     "idle": max(0.0, 1 - busy / ms), "cpu_ms": cpu_ms}
        log(f"rl {kind}: card vs CPU over {len(batches)} update(s): stats "
            f"{stats_err:.3e} (<= {RL_STATS_RTOL:.0e}), params normwise "
            f"{param_err:.3e} (<= {RL_PARAM_RTOL:.0e}); ms per update "
            f"{ms:.4f} on the card (device busy {busy:.4f}, idle share "
            f"{max(0.0, 1 - busy / ms):.3f}, {kernels:.0f} kernels), "
            f"{cpu_ms:.4f} on the CPU ({smi})")
        if stats_err > RL_STATS_RTOL or param_err > RL_PARAM_RTOL:
            failed.append(f"{kind}: stats {stats_err:.3e}, params "
                          f"{param_err:.3e}")
    if failed:
        raise SmokeFailure("RL learners, card against CPU: "
                           + "; ".join(failed))
    return out


def rl_ppo_loop(torch, rl, smi, by_path, name, learner_ms):
    """Phase 12(b): JAX's PPO learning test (tests/test_rl.py:84-106) on the
    port's runtime: ``PPOConfig().learners(1)``, the learner in an actor
    with ``num_gpus=1`` (the card), 2 env runners as actors sampling on the
    CPU, until the best episode_reward_mean reaches RL_REWARD_BAR or
    RL_MAX_ITERS iterations pass. Prints the learner's ms per update
    (host clock around the iteration's updates, each a call of the actor)
    beside phase 12(a)'s on the card and the CPU (`learner_ms`)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import exceptions

    rt.init(num_cpus=4)
    try:
        algo = (rl.PPOConfig()
                .environment(rl.CartPoleEnv)
                .rollouts(num_rollout_workers=2,
                          rollout_fragment_length=512)
                .training(num_sgd_iter=10, sgd_minibatch_size=256,
                          lr=1e-3, entropy_coeff=0.01)
                .learners(1)
                .build())
        best, rewards_by_iter = -math.inf, []
        learner_s = steps = updates = 0
        # the learner's process launches whatever kernels the path takes:
        # its counts, set to 0 there just before the loop
        algo.learner.kernel_launches(reset=True)
        t_loop = time.perf_counter()
        for iteration in range(RL_MAX_ITERS):
            result = algo.train()
            learner_s += result["time_learner_s"]
            updates += result["num_learner_updates"]
            steps += result["num_env_steps_sampled"]
            r = result["episode_reward_mean"]
            rewards_by_iter.append(None if math.isnan(r) else r)
            if not math.isnan(r):
                best = max(best, r)
            if best >= RL_REWARD_BAR:
                break
        loop_s = time.perf_counter() - t_loop
        by_path[name] = algo.learner.kernel_launches()
        algo.stop()
    except exceptions.RayTpuError as exc:
        raise SmokeFailure(f"rl ppo: {type(exc).__name__}: {exc}") from exc
    finally:
        rt.shutdown()
    update_ms = learner_s / updates * 1e3
    out = {"iterations": iteration + 1, "best_reward": best,
           "rewards": rewards_by_iter, "env_steps": steps,
           "updates": updates, "update_ms": update_ms,
           "phase12a_update_ms": learner_ms, "loop_s": loop_s,
           "last_stats": {k: v for k, v in result.items()
                          if k.startswith("learner/")}}
    log(f"rl ppo (PPOConfig().learners(1): the learner in a num_gpus=1 "
        f"actor, 2 runner actors on the CPU x 512 steps): {iteration + 1} "
        f"iterations, best episode_reward_mean {best:.2f} (bar "
        f"{RL_REWARD_BAR}), rewards "
        f"{[None if r is None else round(r, 2) for r in rewards_by_iter]}")
    log(f"rl ppo: {updates} updates at {update_ms:.4f} ms each through the "
        f"learner actor (host clock, the call included) beside phase "
        f"12(a)'s {learner_ms['ms']:.4f} ms on the card and "
        f"{learner_ms['cpu_ms']:.4f} ms on the CPU in process; "
        f"{steps / loop_s:.1f} env steps/s over the loop of {loop_s:.1f} s "
        f"({smi}); flash launches in the learner actor {by_path[name]}")
    loss = out["last_stats"].get("learner/total_loss", math.nan)
    if not math.isfinite(loss):
        raise SmokeFailure(f"rl ppo: loss not finite {out['last_stats']}")
    if best < RL_REWARD_BAR:
        raise SmokeFailure(f"rl ppo: best episode_reward_mean {best} "
                           f"< {RL_REWARD_BAR} after {iteration + 1} "
                           "iterations")
    return out


# --- phase 13: the port's runtime on the card --------------------------------
# The driver makes these remote from the module imported by its name
# (`import chip_smoke`), never from __main__: a worker imports them by name,
# whether or not cloudpickle is there to send them by value.

def noop():
    return os.getpid()


def slot_report():
    """Phase 13(b), in a worker: its GPU slots, CUDA_VISIBLE_DEVICES and
    what torch sees there."""
    import torch

    import ray_tpu_torch as rt
    seen = torch.cuda.is_available()
    return (rt.get_runtime_context().get_accelerator_ids(),
            os.environ.get("CUDA_VISIBLE_DEVICES"), seen,
            torch.cuda.get_device_name(0) if seen else None)


class GpuTrainer:
    """Phase 13's actor (the driver asks for num_gpus=1): phase 4's train
    path in a worker process of the port's runtime, on the card its slot
    names; then its parameters back through the object store."""

    def __init__(self):
        self.params = {}

    def train(self, smi, tokens, profile_path=None):
        """Phase 4's 2 + 5 steps on `tokens` (a CPU tensor), then two
        profiled ones when `profile_path` is given. Returns the launch
        counts, train_path's result and what it printed."""
        import torch

        from ray_tpu_torch import models
        from ray_tpu_torch.ops import attention as A

        cfg = models.gpt2_medium(max_seq_len=1024, remat_policy="dots")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            counts, result = train_path(
                torch, A, models, smi, ACTOR_PATH, cfg, (tokens.shape[0],),
                tokens=tokens, params_out=self.params,
                profile_path=profile_path)
        return counts, result, printed.getvalue()

    def make_payload(self, mb, seed):
        """`mb` MB of seeded f32 in place of the parameters (--skip-main)."""
        import torch

        gen = torch.Generator().manual_seed(seed)
        self.params = {"payload": torch.randn(mb << 18, generator=gen)}

    def put_params(self):
        """`put` the parameters; returns [ref], the put's seconds and the
        tensors' bytes."""
        import ray_tpu_torch as rt

        nbytes = sum(t.numel() * t.element_size()
                     for t in self.params.values())
        t0 = time.perf_counter()
        ref = rt.put(self.params)
        return [ref], time.perf_counter() - t0, nbytes


def fresh_copy_gb_s(nbytes: int) -> dict:
    """The host's rates (GB/s) for copying `nbytes` into memory not touched
    yet, page faults included: into a new anonymous array ("anon"), into a
    new /dev/shm file ("to_shm", what a put into a new segment does), and
    from a new mapping of that file into a new array ("from_shm", what a
    get does). The yardsticks of phase 13's put and get."""
    import mmap

    import numpy as np

    src = np.ones(nbytes, np.uint8)
    t0 = time.perf_counter()
    dst = np.empty_like(src)
    dst[:] = src
    rates = {"anon": time.perf_counter() - t0}
    del dst
    path = f"/dev/shm/rtpt_yardstick_{os.getpid()}"
    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    try:
        os.ftruncate(fd, nbytes)
        with mmap.mmap(fd, nbytes) as m:
            view = np.frombuffer(m, np.uint8)
            t0 = time.perf_counter()
            view[:] = src
            rates["to_shm"] = time.perf_counter() - t0
            del view
        with mmap.mmap(fd, nbytes) as m:
            view = np.frombuffer(m, np.uint8)
            t0 = time.perf_counter()
            dst = np.empty_like(src)
            dst[:] = view
            rates["from_shm"] = time.perf_counter() - t0
            del view, dst
    finally:
        os.close(fd)
        os.unlink(path)
    return {k: nbytes / v / 1e9 for k, v in rates.items()}


def runtime_phase(torch, smi, by_path, base, driver_params, skip_main,
                  profile_path=None):
    """Phase 13: the port's runtime on the card (see the module docstring);
    `base` is phase 4's result and `driver_params` its parameters after
    its steps (CPU f32), both None under --skip-main; `profile_path` as
    train_path's, for the actor's steps."""
    import chip_smoke as me
    import ray_tpu_torch as rt
    from ray_tpu_torch import exceptions

    out = {}
    t0 = time.perf_counter()
    rt.init(num_cpus=4)
    try:
        out["init_s"] = time.perf_counter() - t0
        res = rt.cluster_resources()
        out["resources"] = res
        t0 = time.perf_counter()
        rt.get(rt.remote(me.noop).remote(), timeout=300)
        out["spawn_to_first_task_s"] = time.perf_counter() - t0
        log(f"runtime: init {out['init_s']:.3f} s, node resources {res}, "
            f"worker spawn to first task {out['spawn_to_first_task_s']:.3f}"
            f" s")
        if res.get("GPU") != torch.cuda.device_count():
            raise SmokeFailure(f"runtime: GPU resource {res.get('GPU')}, "
                               f"{torch.cuda.device_count()} device(s)")

        # (b) which tasks see the card
        report = rt.remote(me.slot_report)
        gpu = rt.get(report.options(num_gpus=1).remote(), timeout=300)
        cpu = rt.get(report.remote(), timeout=300)
        out["slots"] = {"gpu_task": gpu, "cpu_task": cpu}
        log(f"runtime: num_gpus=1 task {gpu}; task without a slot {cpu}")
        name = torch.cuda.get_device_name(0)
        if gpu != ({"GPU": [0]}, "0", True, name):
            raise SmokeFailure(f"runtime: num_gpus=1 task sees {gpu}")
        if cpu != ({"GPU": []}, "", False, None):
            raise SmokeFailure(f"runtime: a task without a slot sees {cpu}")

        trainer = rt.remote(num_gpus=1)(me.GpuTrainer).remote()
        if skip_main:
            by_path[ACTOR_PATH] = {k: None for k in by_path["gpt2_medium"]}
            rt.get(trainer.make_payload.remote(RUNTIME_SKIP_MAIN_MB, 0),
                   timeout=300)
            gen = torch.Generator().manual_seed(0)
            driver_params = {"payload": torch.randn(
                RUNTIME_SKIP_MAIN_MB << 18, generator=gen)}
        else:
            # (c) the main path inside the GPU actor, on phase 4's tokens
            from ray_tpu_torch import models
            cfg = models.gpt2_medium(max_seq_len=1024, remat_policy="dots")
            tokens = torch.from_numpy(_tokens(base["batch"], base["seq"],
                                              cfg.vocab_size, seed=1))
            t0 = time.perf_counter()
            counts, result, printed = rt.get(
                trainer.train.remote(smi, rt.put(tokens), profile_path),
                timeout=900)
            result["call_s"] = time.perf_counter() - t0
            for ln in printed.splitlines():
                log(f"  (actor) {ln}")
            by_path[ACTOR_PATH] = counts
            out["train"] = result
            loss_err = (abs(result["losses"][0] - base["losses"][0])
                        / abs(base["losses"][0]))
            gn_err = (abs(result["grad_norms"][0] - base["grad_norms"][0])
                      / abs(base["grad_norms"][0]))
            bit_equal = result["losses"] == base["losses"]
            out.update({"first_loss_rel_err": loss_err,
                        "first_grad_norm_rel_err": gn_err,
                        "losses_bit_equal": bit_equal})
            log(f"{ACTOR_PATH}: beside gpt2_medium (phase 4): step "
                f"{result['step_ms']:.1f} ms against {base['step_ms']:.1f} ms, "
                f"call {result['call_s']:.1f} s; first loss rel err "
                f"{loss_err:.2e} (<= {FSDP_LOSS_RTOL:.0e}), grad norm "
                f"{gn_err:.2e} (<= {FSDP_GRAD_NORM_RTOL:.0e}); all 7 losses "
                f"equal to phase 4's bit for bit: {bit_equal}; launches "
                f"{counts} (phase 4: {by_path['gpt2_medium']}) ({smi})")
            if counts != by_path["gpt2_medium"]:
                raise SmokeFailure(f"{ACTOR_PATH}: launches {counts}, phase "
                                   f"4 {by_path['gpt2_medium']}")
            if loss_err > FSDP_LOSS_RTOL or gn_err > FSDP_GRAD_NORM_RTOL:
                raise SmokeFailure(f"{ACTOR_PATH}: the first step disagrees "
                                   "with phase 4's")

        # (d) the parameters back through the store
        [ref], put_s, nbytes = rt.get(trainer.put_params.remote(),
                                      timeout=600)
        t0 = time.perf_counter()
        params = rt.get(ref, timeout=600)
        get_s = time.perf_counter() - t0
        errs = {n: float((params[n] - p).norm() / p.norm().clamp_min(1e-30))
                for n, p in driver_params.items()}
        worst = max(errs, key=errs.get)
        bit_equal = (params.keys() == driver_params.keys() and all(
            torch.equal(params[n], p) for n, p in driver_params.items()))
        shm = os.statvfs("/dev/shm")
        stats = rt._global_node.store.stats()
        host_gb_s = fresh_copy_gb_s(nbytes)
        out["params"] = {
            "bytes": nbytes, "tensors": len(params), "put_s": put_s,
            "get_s": get_s, "put_gb_s": nbytes / put_s / 1e9,
            "get_gb_s": nbytes / get_s / 1e9,
            "host_copy_gb_s": host_gb_s, "max_rel_err": errs[worst],
            "worst": worst, "bit_equal": bit_equal,
            "dev_shm_bytes": shm.f_frsize * shm.f_blocks,
            "spilled_bytes": stats["spilled_bytes_total"]}
        log(f"runtime: {len(params)} tensors, {nbytes / 1e9:.3f} GB (CPU "
            f"f32) put by the actor in {put_s:.3f} s "
            f"({nbytes / put_s / 1e9:.2f} GB/s), got by the driver in "
            f"{get_s:.3f} s ({nbytes / get_s / 1e9:.2f} GB/s); the host copies "
            f"the same bytes at {host_gb_s['anon']:.2f} GB/s into fresh "
            f"memory, {host_gb_s['to_shm']:.2f} into a fresh /dev/shm file, "
            f"{host_gb_s['from_shm']:.2f} from a fresh mapping of it; max "
            f"normwise "
            f"rel err {errs[worst]:.2e} ({worst}, <= {RUNTIME_PARAM_RTOL:.0e})"
            f", bit-equal: {bit_equal}; /dev/shm "
            f"{out['params']['dev_shm_bytes'] / 2**30:.1f} GiB, spilled "
            f"{stats['spilled_bytes_total']} bytes ({smi})")
        if params.keys() != driver_params.keys():
            raise SmokeFailure("runtime: the parameters' names differ")
        if errs[worst] > RUNTIME_PARAM_RTOL:
            raise SmokeFailure(f"runtime: parameters {worst} off by "
                               f"{errs[worst]:.2e}")
    except exceptions.RayTpuError as exc:
        raise SmokeFailure(f"runtime: {type(exc).__name__}: {exc}") from exc
    finally:
        rt.shutdown()     # (e)
    return out


# --- phase 14: the gang trainer on the card ----------------------------------

def gang_loop(config):
    """Phase 14's ``train_loop_per_worker``, in the gang's worker (one GPU
    slot, one NCCL rank): phase 4's gpt2_medium on phase 4's seed-0
    weights and tokens through the process-mesh path of
    ``build_mesh(MeshSpec(**config["mesh"]))``, resumed from the session's
    checkpoint when there is one; a sharded checkpoint after step
    ``ckpt_at``; on the first attempt of a run with ``fail`` an injected
    error after that checkpoint. With ``ingest`` (phase 15(b)) each step
    takes the next batch of the trainer's "train" dataset shard
    (``iter_device_batches``) in place of phase 4's tokens. Each step
    reports its loss, grad norm, host ms and the ms its batch took to come
    out of the iterator; the last also the launch counts of this attempt's
    steps (set to 0 just before them), and two profiled steps when
    asked."""
    import itertools

    import torch

    from ray_tpu_torch import models, train
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = train.get_context()
    cfg = models.gpt2_medium(max_seq_len=1024, remat_policy="dots")
    mesh = build_mesh(MeshSpec(**config["mesh"]), device_type="cuda")
    model = models.GPT(cfg, seed=0, mesh=mesh)
    opt = models.make_optimizer(
        total_steps=config["steps"],
        **({"learning_rate": config["lr"]} if "lr" in config else {}))
    state = models.init_train_state(model, opt, mesh=mesh)
    step = models.make_train_step(model, opt, mesh=mesh)
    restore_s = None
    resume = train.get_checkpoint()
    if resume is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resume.to_state_dict(template=state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    if config.get("ingest"):
        batches = train.get_dataset_shard("train").iter_device_batches(
            batch_size=config["batch"])
    else:
        tokens = torch.from_numpy(_tokens(config["batch"], cfg.max_seq_len,
                                          cfg.vocab_size, seed=1)).cuda()
        batches = itertools.repeat({"tokens": tokens})
    first = state.step
    torch.cuda.synchronize()
    A.reset_launch_counts()
    while state.step < config["steps"]:
        t0 = time.perf_counter()
        batch = next(batches)
        next_ms = (time.perf_counter() - t0) * 1e3
        state, m = step(state, batch)
        info = {"step": state.step, "loss": float(m["loss"]),
                "grad_norm": float(m["grad_norm"]),
                "step_ms": (time.perf_counter() - t0) * 1e3,
                "next_ms": next_ms,
                "attempt": ctx.attempt, "restore_s": restore_s}
        ckpt = None
        if state.step == config["ckpt_at"]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt = train.Checkpoint.from_state_dict(state)
            info["save_s"] = time.perf_counter() - t0
            info["ckpt_bytes"] = sum(
                f.stat().st_size for f in Path(ckpt.path).rglob("*")
                if f.is_file())
        if state.step == config["steps"]:
            info["launches"] = dict(A.launches)
            info["steps_counted"] = state.step - first
            if config["profile"]:
                def one_step():
                    nonlocal state
                    state, _ = step(state, batch)

                path = Path(config["profile"])
                info["profile"] = profile_steps(
                    torch, one_step,
                    path.with_name(f"{path.stem}.{GANG_PATH}{path.suffix}"),
                    info["step_ms"])
        train.report(info, checkpoint=ckpt)
        if (config["fail"] and ctx.attempt == 0
                and state.step == config["ckpt_at"]):
            raise RuntimeError("injected failure after the step-"
                               f"{state.step} checkpoint")


def gang_phase(torch, smi, by_path, base, profile_path=None):
    """Phase 14: ``TorchTrainer`` on the card (see the module docstring):
    an uninterrupted gang run and one failed after its step-3 checkpoint
    and resumed from it, each on a one-worker NCCL gang; `base` is phase
    4's result."""
    import tempfile

    import chip_smoke as me
    import ray_tpu_torch as rt
    from ray_tpu_torch import exceptions
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.train import (CheckpointConfig, FailureConfig,
                                     RunConfig, ScalingConfig, TorchTrainer)

    spec = dict(dp=1, fsdp=1)
    storage = tempfile.mkdtemp(prefix="chip_smoke_gang_")
    out = {}
    rt.init(num_cpus=4)
    try:
        for run_name, fail in (("whole", False), ("resumed", True)):
            config = {"mesh": spec, "steps": GANG_STEPS,
                      "ckpt_at": GANG_CKPT_AT, "batch": base["batch"],
                      "fail": fail,
                      "profile": profile_path if not fail else None}
            t0 = time.perf_counter()
            trainer = TorchTrainer(
                me.gang_loop, train_loop_config=config,
                scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                             mesh=MeshSpec(**spec)),
                run_config=RunConfig(
                    name=run_name, storage_path=storage,
                    failure_config=FailureConfig(max_failures=1),
                    checkpoint_config=CheckpointConfig(num_to_keep=1)))
            result = trainer.fit()
            fit_s = time.perf_counter() - t0
            for line in trainer.failures:
                log(f"{GANG_PATH} ({run_name}): failed {line}")
            if result.error is not None:
                raise SmokeFailure(f"{GANG_PATH} ({run_name}): "
                                   f"{type(result.error).__name__}: "
                                   f"{result.error}")
            out[run_name] = {"history": result.metrics_history,
                             "fit_s": fit_s, "failures": trainer.failures}
    except exceptions.RayTpuError as exc:
        raise SmokeFailure(f"{GANG_PATH}: {type(exc).__name__}: {exc}") \
            from exc
    finally:
        rt.shutdown()
        import shutil
        shutil.rmtree(storage, ignore_errors=True)

    whole, resumed = out["whole"]["history"], out["resumed"]["history"]
    last = whole[-1]
    n = last["steps_counted"]
    counts = last["launches"]
    by_path[GANG_PATH] = counts
    per_step = {k: v / n for k, v in counts.items()}
    want = {k: v for k, v in base["launches_per_step"].items()}
    losses = [h["loss"] for h in whole]
    norms = [h["grad_norm"] for h in whole]
    loss_err = abs(losses[0] - base["losses"][0]) / abs(base["losses"][0])
    gn_err = abs(norms[0] - base["grad_norms"][0]) / abs(
        base["grad_norms"][0])
    steps_seen = [(h["step"], h["attempt"]) for h in resumed]
    tail = [(h["loss"], h["grad_norm"]) for h in resumed
            if h["step"] > GANG_CKPT_AT]
    resumed_equal = (tail == [(h["loss"], h["grad_norm"]) for h in whole
                              if h["step"] > GANG_CKPT_AT])
    if steps_seen != [(i, 0) for i in range(1, GANG_CKPT_AT + 1)] + [
            (i, 1) for i in range(GANG_CKPT_AT + 1, GANG_STEPS + 1)]:
        raise SmokeFailure(f"{GANG_PATH}: the failed run reported (step, "
                           f"attempt) {steps_seen}; its failures "
                           f"{out['resumed']['failures']}")
    saved = next(h for h in resumed if h["step"] == GANG_CKPT_AT)
    restore_s = next(h["restore_s"] for h in resumed if h["attempt"] == 1)
    step_ms = sorted(h["step_ms"] for h in whole[-5:])[2]
    resumed_ms = sorted(h["step_ms"] for h in resumed[-3:])[1]
    resumed_counts = resumed[-1]["launches"]
    resumed_per_step = {k: v / resumed[-1]["steps_counted"]
                        for k, v in resumed_counts.items()}
    res = {"losses": losses, "grad_norms": norms,
           "resumed_losses": [h["loss"] for h in resumed],
           "steps_by_attempt": steps_seen, "resumed_equal": resumed_equal,
           "first_loss_rel_err": loss_err, "first_grad_norm_rel_err": gn_err,
           "step_ms_median": step_ms, "resumed_step_ms_median": resumed_ms,
           "launches_per_step": per_step,
           "resumed_launches_per_step": resumed_per_step,
           "save_s": saved["save_s"], "ckpt_bytes": saved["ckpt_bytes"],
           "restore_s": restore_s, "fit_s": {k: v["fit_s"]
                                             for k, v in out.items()},
           "profile": last.get("profile")}
    log(f"{GANG_PATH}: TorchTrainer, one worker with num_gpus=1 on a "
        f"one-rank NCCL gang, MeshSpec(dp=1, fsdp=1), batch {base['batch']}: "
        f"losses {losses} (phase 4: {base['losses']}); grad norms {norms} "
        f"(phase 4: {base['grad_norms']})")
    log(f"{GANG_PATH}: first loss rel gap {loss_err:.3e} (<= "
        f"{FSDP_LOSS_RTOL:.0e}), first grad norm {gn_err:.3e} (<= "
        f"{FSDP_GRAD_NORM_RTOL:.0e}); losses equal to phase 4's: "
        f"{losses == base['losses']}; the failed run's (step, attempt) "
        f"{steps_seen}, its steps {GANG_CKPT_AT + 1}-{GANG_STEPS} after the "
        f"restart equal to the uninterrupted run's bit for bit: "
        f"{resumed_equal}")
    log(f"{GANG_PATH}: step {step_ms:.1f} ms (median of steps 3-7; phase 4 "
        f"{base['step_ms']:.1f}), resumed {resumed_ms:.1f} ms (median of "
        f"steps 5-7)"
        + (f"; device busy {res['profile']['busy_ms']:.2f} ms/step, idle "
           f"{res['profile']['idle_share']:.3f} (phase 4 busy "
           f"{base['profile']['busy_ms']:.2f}, idle "
           f"{base['profile']['idle_share']:.3f})" if profile_path else "")
        + f"; sharded checkpoint {saved['ckpt_bytes'] / 1e9:.3f} GB saved in "
        f"{saved['save_s']:.2f} s, restored in {restore_s:.2f} s; fit "
        f"{res['fit_s']['whole']:.1f} s and {res['fit_s']['resumed']:.1f} s; "
        f"launches per step {per_step}, resumed {resumed_per_step} (phase "
        f"4: {want}) ({smi})")
    if per_step != want or resumed_per_step != want:
        raise SmokeFailure(f"{GANG_PATH}: launches per step {per_step} and "
                           f"{resumed_per_step}, phase 4 {want}")
    if loss_err > FSDP_LOSS_RTOL or gn_err > FSDP_GRAD_NORM_RTOL:
        raise SmokeFailure(f"{GANG_PATH}: the first step disagrees with "
                           "phase 4's")
    if not resumed_equal:
        raise SmokeFailure(f"{GANG_PATH}: the resumed steps differ from the "
                           "uninterrupted run's")
    if not all(math.isfinite(x) for x in losses + norms):
        raise SmokeFailure(f"{GANG_PATH}: non-finite loss or grad norm")
    return res


# --- phase 15: ingest on the card ------------------------------------------

def ingest_dataset(rd, vocab_size, batch):
    """Phase 15's data: INGEST_BATCHES batches of `batch` rows of seq 1024
    from `default_rng(1)` (the first batch is phase 4's tokens) in
    INGEST_BLOCKS uneven blocks, through one map_batches stage of worker
    tasks (the blocks travel through the store). Returns (dataset,
    rows)."""
    rows = _tokens(INGEST_BATCHES * batch, 1024, vocab_size, seed=1)
    ds = rd.from_numpy({"tokens": rows}, num_blocks=INGEST_BLOCKS
                       ).map_batches(lambda b: {"tokens": b["tokens"]})
    return ds, rows


def unequal_batches(torch, batches, rows, batch):
    """The indices of the yielded batches that are not on the card or not
    their `batch` rows of `rows` bit for bit (and of the missing ones)."""
    bad = [i for i, b in enumerate(batches)
           if list(b) != ["tokens"] or not b["tokens"].is_cuda
           or not torch.equal(b["tokens"].cpu(), torch.from_numpy(
               rows[i * batch:(i + 1) * batch]))]
    return bad + list(range(len(batches), len(rows) // batch))


def ingest_phase(torch, A, models, smi, by_path, base, gang_base,
                 skip_main, profile_path=None):
    """Phase 15 (see the module docstring): (a) gpt2_medium fed by
    ``Dataset.iter_device_batches`` in this process, (b) phase 14's gang
    fed by ``get_dataset_shard("train").iter_device_batches``; `base` is
    phase 4's result and `gang_base` phase 14's, both None under
    --skip-main, where only the batches' bit equality on the card runs."""
    import shutil
    import tempfile

    import chip_smoke as me
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch import exceptions
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    cfg = models.gpt2_medium(max_seq_len=1024, remat_policy="dots")
    batch = base["batch"] if base else 12
    out = {"batch": batch, "blocks": INGEST_BLOCKS}
    rt.init(num_cpus=4)
    try:
        ds, rows = ingest_dataset(rd, cfg.vocab_size, batch)
        out["block_rows"] = [len(b["tokens"]) for b in ds.iter_blocks()]
        if skip_main:
            for name, batches in (
                    ("Dataset", ds.iter_device_batches(batch_size=batch)),
                    ("DataIterator", ds.streaming_split(1)[0]
                     .iter_device_batches(batch_size=batch))):
                kept = list(batches)
                torch.cuda.synchronize()
                bad = unequal_batches(torch, kept, rows, batch)
                log(f"{INGEST_PATH}: {name}.iter_device_batches, blocks "
                    f"{out['block_rows']}: {len(kept)} batches of {batch} "
                    f"rows on the card, not bit-equal to their rows: {bad}")
                if bad:
                    raise SmokeFailure(f"{INGEST_PATH}: {name} batches {bad} "
                                       "differ from their rows")
            by_path[INGEST_PATH] = {k: None for k in A.launches}
            by_path[INGEST_GANG_PATH] = {k: None for k in A.launches}
            return out

        # (a) in process: a fresh phase-4 model, one new batch a step
        model = models.GPT(cfg, seed=0)
        opt = models.make_optimizer(total_steps=INGEST_BATCHES)
        state = models.init_train_state(model, opt)
        step = models.make_train_step(model, opt)
        batches = ds.iter_device_batches(batch_size=batch)
        kept, metrics, next_ms = [], [], []
        torch.cuda.synchronize()
        A.reset_launch_counts()
        for i in range(INGEST_BATCHES):
            if i == 2:       # 2 warm-up steps, then the timed window
                torch.cuda.synchronize()
                t_timed = time.perf_counter()
            t0 = time.perf_counter()
            kept.append(next(batches))
            next_ms.append((time.perf_counter() - t0) * 1e3)
            state, m = step(state, kept[-1])
            metrics.append(m)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t_timed) * 1e3 / (INGEST_BATCHES - 2)
        counts = dict(A.launches)
        by_path[INGEST_PATH] = counts
        bad = unequal_batches(torch, kept, rows, batch)
        if next(batches, None) is not None:
            bad.append(INGEST_BATCHES)
        losses = [float(m["loss"]) for m in metrics]
        norms = [float(m["grad_norm"]) for m in metrics]
        per_step = {k: v / INGEST_BATCHES for k, v in counts.items()}
        tok_s = batch * cfg.max_seq_len / (step_ms / 1e3)
        out.update({"losses": losses, "grad_norms": norms,
                    "step_ms": step_ms, "tokens_per_s": tok_s,
                    "next_ms": next_ms, "launches_per_step": per_step,
                    "unequal_batches": bad})
        if profile_path:
            more = ds.iter_device_batches(batch_size=batch)

            def one_step():
                nonlocal state
                state, _ = step(state, next(more))

            path = Path(profile_path)
            out["profile"] = profile_steps(
                torch, one_step,
                path.with_name(f"{path.stem}.{INGEST_PATH}{path.suffix}"),
                step_ms)
        del model, state, step, opt, kept, batches, metrics
        gc.collect()
        torch.cuda.empty_cache()
        first_equal = (losses[0], norms[0]) == (base["losses"][0],
                                                base["grad_norms"][0])
        log(f"{INGEST_PATH}: Dataset.iter_device_batches(batch_size={batch}) "
            f"over blocks {out['block_rows']}: losses {losses}; grad norms "
            f"{norms}; first loss and grad norm equal to phase 4's: "
            f"{first_equal}; batches not bit-equal to their rows: {bad}")
        log(f"{INGEST_PATH}: step {step_ms:.1f} ms, {tok_s:.0f} tokens/s "
            f"(phase 4 {base['step_ms']:.1f} ms, {base['tokens_per_s']:.0f}); "
            f"host ms per batch in next() {[round(x, 3) for x in next_ms]}"
            + (f"; device busy {out['profile']['busy_ms']:.2f} ms/step, idle "
               f"{out['profile']['idle_share']:.3f} (phase 4 busy "
               f"{base['profile']['busy_ms']:.2f}, idle "
               f"{base['profile']['idle_share']:.3f})" if profile_path else "")
            + f"; launches per step {per_step} (phase 4: "
            f"{base['launches_per_step']}) ({smi})")
        if bad:
            raise SmokeFailure(f"{INGEST_PATH}: batches {bad} are not their "
                               "rows on the card")
        if not first_equal:
            raise SmokeFailure(f"{INGEST_PATH}: the first step differs from "
                               "phase 4's")
        if not all(math.isfinite(x) for x in losses + norms):
            raise SmokeFailure(f"{INGEST_PATH}: non-finite loss or grad norm")
        if per_step != base["launches_per_step"]:
            raise SmokeFailure(f"{INGEST_PATH}: launches per step {per_step}, "
                               f"phase 4 {base['launches_per_step']}")

        # (b) phase 14's gang, fed by its dataset shard
        spec = dict(dp=1, fsdp=1)
        config = {"mesh": spec, "steps": INGEST_BATCHES, "ckpt_at": None,
                  "batch": batch, "fail": False, "profile": None,
                  "ingest": True}
        storage = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
        t0 = time.perf_counter()
        try:
            trainer = TorchTrainer(
                me.gang_loop, train_loop_config=config,
                scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                             mesh=MeshSpec(**spec)),
                run_config=RunConfig(name="ingest", storage_path=storage),
                datasets={"train": ds})
            result = trainer.fit()
        finally:
            shutil.rmtree(storage, ignore_errors=True)
        fit_s = time.perf_counter() - t0
        if result.error is not None:
            raise SmokeFailure(f"{INGEST_GANG_PATH}: "
                               f"{type(result.error).__name__}: "
                               f"{result.error}")
    except exceptions.RayTpuError as exc:
        raise SmokeFailure(f"{INGEST_PATH}: {type(exc).__name__}: {exc}") \
            from exc
    finally:
        rt.shutdown()

    hist = result.metrics_history
    g_losses = [h["loss"] for h in hist]
    g_norms = [h["grad_norm"] for h in hist]
    g_counts = hist[-1]["launches"]
    by_path[INGEST_GANG_PATH] = g_counts
    g_per_step = {k: v / hist[-1]["steps_counted"] for k, v in
                  g_counts.items()}
    g_step_ms = sorted(h["step_ms"] for h in hist[-5:])[2]
    out["gang"] = {"losses": g_losses, "grad_norms": g_norms,
                   "step_ms_median": g_step_ms, "fit_s": fit_s,
                   "next_ms": [h["next_ms"] for h in hist],
                   "launches_per_step": g_per_step}
    equal = (g_losses, g_norms) == (losses, norms)
    log(f"{INGEST_GANG_PATH}: TorchTrainer(datasets=) on one num_gpus=1 "
        f"worker, MeshSpec(dp=1, fsdp=1), get_dataset_shard('train')."
        f"iter_device_batches(batch_size={batch}): losses {g_losses}; grad "
        f"norms {g_norms}; equal to (a)'s bit for bit: {equal}")
    log(f"{INGEST_GANG_PATH}: step {g_step_ms:.1f} ms (median of steps 3-7; "
        f"phase 14 {gang_base['step_ms_median']:.1f}); host ms per batch in "
        f"next() {[round(h['next_ms'], 3) for h in hist]}; fit {fit_s:.1f} "
        f"s; launches per step {g_per_step} (phase 4: "
        f"{base['launches_per_step']}) ({smi})")
    if len(hist) != INGEST_BATCHES or not equal:
        raise SmokeFailure(f"{INGEST_GANG_PATH}: the gang's steps differ from "
                           "(a)'s")
    if g_per_step != base["launches_per_step"]:
        raise SmokeFailure(f"{INGEST_GANG_PATH}: launches per step "
                           f"{g_per_step}, phase 4 "
                           f"{base['launches_per_step']}")
    return out


# --- phase 16: host collectives, MeshGroup, Tune and user metrics ----------

class CommRank:
    """Phase 16(a)'s CPU rank of the host collective group (the driver,
    on the card, is rank 0): the same ops as the driver, in the same
    order, on CPU torch tensors; returns a digest of each result and its
    seconds, never the tensors. (The hook `CollectiveActorMixin` gives is
    taken from it: this module imports no package at its top, so it
    cannot subclass it.)"""

    def _rtpu_init_collective(self, world_size, rank, group_name):
        from ray_tpu_torch.comm.collective import CollectiveActorMixin
        CollectiveActorMixin._rtpu_init_collective(self, world_size, rank,
                                                   group_name)

    def run(self, dtype_name, n, rows):
        import hashlib

        import torch

        from ray_tpu_torch.comm import collective as col

        dtype = getattr(torch, dtype_name)
        rank = col.get_rank(COMM_GROUP)
        kw = {"group_name": COMM_GROUP, "timeout": COMM_TIMEOUT_S}

        def digest(t):
            t = t.contiguous().view(torch.uint8)
            return (hashlib.sha256(t.numpy()).hexdigest(), t.numel())

        out, secs = {}, {}

        def timed(op, fn):
            # every rank starts each op together (the driver does the same)
            col.barrier(**kw)
            t0 = time.perf_counter()
            result = fn()
            secs[op] = time.perf_counter() - t0
            return result

        held = timed("broadcast", lambda: col.broadcast(
            torch.empty(0, dtype=dtype), src_rank=0, **kw))
        out["broadcast"] = digest(held)
        total = timed("allreduce", lambda: col.allreduce(held, **kw))
        out["allreduce"] = digest(total)
        part = held[:rows * COMM_WORLD].reshape(COMM_WORLD, rows)
        mine = timed("reducescatter", lambda: col.reducescatter(part, **kw))
        out["reducescatter"] = digest(mine)
        parts = timed("allgather", lambda: col.allgather(mine, **kw))
        out["allgather"] = digest(torch.cat(parts))
        col.barrier(**kw)
        if rank == 1:
            back = col.recv(0, group_name=COMM_GROUP,
                            timeout=COMM_TIMEOUT_S)
            out["recv"] = (digest(back), str(back.dtype), back.device.type)
            col.send(back, 0, group_name=COMM_GROUP)
        out["dtypes"] = sorted({str(t.dtype) for t in
                                (held, total, mine, *parts)})
        return out, secs


class MeshHost:
    """Phase 16(a)'s MeshGroup host (one CPU and one GPU in its bundle):
    its slots, and a one-rank NCCL mesh from `build_local_mesh()` whose
    group sums a tensor on the card. (The methods `SPMDWorkerBase` gives
    a host are taken from it, as `CommRank` takes its hook.)"""

    def _rtpu_setup_mesh(self, rank, world, coll_group=None):
        from ray_tpu_torch.comm.device_mesh import SPMDWorkerBase
        SPMDWorkerBase._rtpu_setup_mesh(self, rank, world, coll_group)

    def report(self):
        import torch
        import torch.distributed as dist

        import ray_tpu_torch as rt
        from ray_tpu_torch.comm.device_mesh import SPMDWorkerBase
        from ray_tpu_torch.parallel import MeshSpec

        ids = rt.get_runtime_context().get_accelerator_ids()
        mesh = SPMDWorkerBase.build_local_mesh(self, MeshSpec(dp=1, fsdp=1))
        x = torch.full((4,), 2.0, device="cuda")
        dist.all_reduce(x)
        return {"accelerator_ids": ids,
                "cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "backend": dist.get_backend(), "world": dist.get_world_size(),
                "mesh": dict(mesh.shape), "sum": x.tolist(),
                "device": torch.cuda.get_device_name(0)}


def comm_phase(torch, models, smi, skip_main, runtime):
    """Phase 16(a) (see the module docstring): the host collectives with a
    CUDA rank at gpt2_medium's width, then a MeshGroup host on the card;
    `runtime` is phase 13's result, whose put/get rates are printed
    beside."""
    import hashlib

    import chip_smoke as me
    import ray_tpu_torch as rt
    from ray_tpu_torch import exceptions
    from ray_tpu_torch.comm import collective as col
    from ray_tpu_torch.comm import mesh_group

    if skip_main:
        gen = torch.Generator().manual_seed(0)
        flat = torch.randn(RUNTIME_SKIP_MAIN_MB << 18,
                           generator=gen).cuda()
        what = f"{RUNTIME_SKIP_MAIN_MB} MB of seeded f32"
    else:
        cfg = models.gpt2_medium(max_seq_len=1024, remat_policy="dots")
        model = models.GPT(cfg, seed=0)
        flat = torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()])
        del model
        what = f"phase 4's seed-0 gpt2_medium parameters ({cfg.n_params} f32)"
    torch.cuda.synchronize()

    def digest(t):
        t = t.contiguous().cpu().view(torch.uint8)
        return (hashlib.sha256(t.numpy()).hexdigest(), t.numel())

    out = {"input": what, "ops": {}}
    kw = {"group_name": COMM_GROUP, "timeout": COMM_TIMEOUT_S}
    rt.init(num_cpus=4)
    try:
        ranks = [rt.remote(num_cpus=1)(me.CommRank).remote()
                 for _ in range(COMM_WORLD - 1)]
        joins = [r._rtpu_init_collective.remote(COMM_WORLD, i + 1,
                                                COMM_GROUP)
                 for i, r in enumerate(ranks)]
        col.init_collective_group(COMM_WORLD, 0, group_name=COMM_GROUP)
        rt.get(joins, timeout=300)
        for x in (flat, flat.to(torch.bfloat16)):
            name = str(x.dtype).split(".")[-1]
            n, nbytes = x.numel(), x.numel() * x.element_size()
            rows = (min(COMM_SLICE_MB << 20, nbytes) // x.element_size()
                    // COMM_WORLD)
            refs = [r.run.remote(name, n, rows) for r in ranks]
            secs, res = {}, {}

            def timed(op, fn):
                col.barrier(**kw)     # every rank starts each op together
                t0 = time.perf_counter()
                r = fn()
                torch.cuda.synchronize()
                secs[op] = time.perf_counter() - t0
                res[op] = r
                return r

            held = timed("broadcast", lambda: col.broadcast(x, src_rank=0,
                                                            **kw))
            total = timed("allreduce", lambda: col.allreduce(held, **kw))
            part = held[:rows * COMM_WORLD].reshape(COMM_WORLD, rows)
            mine = timed("reducescatter",
                         lambda: col.reducescatter(part, **kw))
            parts = timed("allgather", lambda: col.allgather(mine, **kw))
            col.barrier(**kw)
            t0 = time.perf_counter()
            col.send(x, 1, group_name=COMM_GROUP)
            back = col.recv(1, group_name=COMM_GROUP, timeout=COMM_TIMEOUT_S)
            secs["send_recv"] = time.perf_counter() - t0
            theirs = rt.get(refs, timeout=COMM_TIMEOUT_S)
            results = (held, total, mine, *parts)
            mine_d = {"broadcast": digest(held), "allreduce": digest(total),
                      "reducescatter": digest(mine),
                      "allgather": digest(torch.cat(parts))}
            # every rank's bytes: the driver's, rank 1's and rank 2's
            # (reducescatter: each rank its own row, so the rows gathered)
            same = {op: all(d[op] == mine_d[op] for d, _ in theirs)
                    for op in ("broadcast", "allreduce", "allgather")}
            # the plain version of each result on the card: the sum of 3
            # equal contributions is 3x rounded once, in f32 and in bf16
            want = x * COMM_WORLD
            exact = {"broadcast": torch.equal(held, x),
                     "allreduce": torch.equal(total, want),
                     "reducescatter": torch.equal(
                         mine, want[:rows * COMM_WORLD].reshape(
                             COMM_WORLD, rows)[0:1]),
                     "allgather": torch.equal(
                         torch.cat(parts),
                         want[:rows * COMM_WORLD].reshape(COMM_WORLD, rows)),
                     "send_recv": torch.equal(back, x.cpu())}
            on_card = all(t.is_cuda and t.dtype == x.dtype for t in results)
            on_card &= all(d["dtypes"] == [str(x.dtype)] for d, _ in theirs)
            recv_d = theirs[0][0]["recv"]
            moved = {"broadcast": nbytes, "allreduce": nbytes,
                     "reducescatter": rows * COMM_WORLD * x.element_size(),
                     "allgather": rows * COMM_WORLD * x.element_size(),
                     "send_recv": 2 * nbytes}
            rates = {op: moved[op] / s / 1e9 for op, s in secs.items()}
            out["ops"][name] = {
                "bytes": nbytes, "seconds": secs, "gb_s": rates,
                "cpu_rank_seconds": [s for _, s in theirs],
                "ranks_equal": same, "equal_to_plain": exact,
                "results_on_card": on_card,
                "back_dtype_device": (str(back.dtype), back.device.type),
                "recv_at_rank1": recv_d[1:]}
            log(f"comm: {name} {nbytes / 1e9:.3f} GB ({what}"
                f"{'' if x is flat else ', as bf16'}); driver rank "
                f"0 on the card with {COMM_WORLD - 1} CPU actor ranks: "
                + ", ".join(f"{op} {s:.2f} s ({rates[op]:.2f} GB/s)"
                            for op, s in secs.items())
                + f" (reducescatter and allgather of a {COMM_SLICE_MB} MB "
                f"slice; send+recv a round trip to rank 1); every rank's "
                f"bytes equal {same}; equal to the plain version on the card "
                f"{exact}; results CUDA {x.dtype}: {on_card}; rank 1 got "
                f"{recv_d[1:]}, back {back.dtype} on {back.device.type} "
                f"({smi})")
            p13 = runtime["params"]
            log(f"comm: beside phase 13's {p13['bytes'] / 1e9:.3f} GB put "
                f"{p13['put_gb_s']:.2f} and get {p13['get_gb_s']:.2f} GB/s; "
                f"the host copies into fresh memory at "
                f"{p13['host_copy_gb_s']['anon']:.2f} GB/s, into a fresh "
                f"/dev/shm file at {p13['host_copy_gb_s']['to_shm']:.2f}")
            if not (all(same.values()) and all(exact.values()) and on_card):
                raise SmokeFailure(f"comm: {name}: ranks equal {same}, plain "
                                   f"{exact}, on the card {on_card}")
            if recv_d[0] != digest(x) or recv_d[1:] != (str(x.dtype), "cpu"):
                raise SmokeFailure(f"comm: {name}: rank 1 received {recv_d}")
            del held, total, mine, parts, back, results, want
            torch.cuda.empty_cache()
        col.destroy_collective_group(COMM_GROUP)
        group = mesh_group(rt.remote(num_cpus=1)(me.MeshHost), num_hosts=1,
                           resources_per_host={"CPU": 1, "GPU": 1})
        (rep,) = group.run("report")
        group.shutdown()
        out["mesh_group"] = rep
        log(f"comm: mesh_group(num_hosts=1, resources_per_host={{'CPU': 1, "
            f"'GPU': 1}}): host {rep}")
        if (rep["accelerator_ids"] != {"GPU": [0]} or rep["cuda_visible"]
                != "0" or rep["backend"] != "nccl" or rep["world"] != 1
                or rep["sum"] != [2.0] * 4):
            raise SmokeFailure(f"comm: the MeshGroup host reports {rep}")
    except exceptions.RayTpuError as exc:
        raise SmokeFailure(f"comm: {type(exc).__name__}: {exc}") from exc
    finally:
        rt.shutdown()
    return out


def tune_trainable(config):
    """Phase 16(b)'s trainable, in a trial's actor (which holds no card):
    phase 14's gang_loop through a one-worker TorchTrainer on the card at
    the trial's learning rate; each row of the gang's metrics history goes
    to ``tune.report``, and its step ms into a user Histogram (16(c))."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.util import metrics

    step_ms = metrics.Histogram(
        TUNE_HIST, "phase 16(b): a trial's gang step (ms)",
        boundaries=(50.0, 100.0, 200.0, 400.0, 800.0, 1600.0),
        tag_keys=("lr",))
    spec = dict(dp=1, fsdp=1)
    loop_config = {"mesh": spec, "steps": GANG_STEPS, "ckpt_at": None,
                   "batch": config["batch"], "fail": False, "profile": None,
                   "lr": config["lr"]}
    t0 = time.perf_counter()
    result = TorchTrainer(
        gang_loop, train_loop_config=loop_config,
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                     mesh=MeshSpec(**spec)),
        run_config=RunConfig(name=f"gang_lr{config['lr']:g}",
                             storage_path=config["storage"])).fit()
    fit_s = time.perf_counter() - t0
    if result.error is not None:
        raise result.error
    for row in result.metrics_history:
        step_ms.observe(row["step_ms"], tags={"lr": f"{config['lr']:g}"})
        tune.report({**row, "fit_s": fit_s})
    # flushes this process's samples to the control plane now: the trial's
    # actor is killed as soon as this returns
    metrics.metrics_snapshot()


def tune_phase(torch, smi, by_path, base, gang_base):
    """Phase 16(b) and (c) (see the module docstring); `base` is phase 4's
    result and `gang_base` phase 14's."""
    import inspect
    import shutil
    import tempfile

    import chip_smoke as me
    import ray_tpu_torch as rt
    from ray_tpu_torch import exceptions, models, tune
    from ray_tpu_torch.train import RunConfig
    from ray_tpu_torch.util import metrics

    lr = inspect.signature(models.make_optimizer).parameters[
        "learning_rate"].default
    storage = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    rt.init(num_cpus=4)
    try:
        t0 = time.perf_counter()
        grid = tune.Tuner(
            me.tune_trainable,
            param_space={"lr": tune.grid_search([lr, 10 * lr]),
                         "batch": base["batch"], "storage": storage},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        max_concurrent_trials=1),
            run_config=RunConfig(name="tune", storage_path=storage)).fit()
        tune_s = time.perf_counter() - t0
        errors = [str(r.error) for r in grid if r.error is not None]
        if errors:
            raise SmokeFailure(f"{TUNE_PATH}: trials failed: {errors}")
        key = TUNE_HIST
        deadline = time.monotonic() + 30
        while True:
            snap = metrics.metrics_snapshot()
            counts = {dict(t)["lr"]: h["count"]
                      for (n, t), h in snap.get("hists", {}).items()
                      if n == key}
            if sum(counts.values()) >= 2 * GANG_STEPS \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        text = metrics.export_prometheus()
    except exceptions.RayTpuError as exc:
        raise SmokeFailure(f"{TUNE_PATH}: {type(exc).__name__}: {exc}") \
            from exc
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)

    trials = {}
    for res, rate in zip(grid, (lr, 10 * lr)):
        hist = res.metrics_history
        trials[rate] = {
            "losses": [h["loss"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "step_ms_median": sorted(h["step_ms"] for h in hist[-5:])[2],
            "fit_s": hist[-1]["fit_s"],
            "launches_per_step": {k: v / hist[-1]["steps_counted"]
                                  for k, v in hist[-1]["launches"].items()},
            "launches": hist[-1]["launches"]}
    base_trial = trials[lr]
    by_path[TUNE_PATH] = base_trial["launches"]
    finals = {rate: t["losses"][-1] for rate, t in trials.items()}
    best = grid.get_best_result()
    best_rate = min(finals, key=finals.get)
    prom_count = sum(int(float(ln.rsplit(" ", 1)[1]))
                     for ln in text.splitlines()
                     if ln.startswith(f"{key}_count"))
    out = {"trials": {f"{r:g}": t for r, t in trials.items()},
           "tune_s": tune_s, "best_final_loss": best.metrics["loss"],
           "histogram_counts": counts, "prometheus_count": prom_count}
    equal14 = (base_trial["losses"], base_trial["grad_norms"]) == (
        gang_base["losses"], gang_base["grad_norms"])
    first_equal = len({t["losses"][0] for t in trials.values()}) == 1
    want = base["launches_per_step"]
    log(f"{TUNE_PATH}: Tuner over grid_search(lr=[{lr:g}, {10 * lr:g}]), "
        f"max_concurrent_trials=1, each trial a one-worker TorchTrainer "
        f"(num_gpus=1, MeshSpec(dp=1, fsdp=1)) running phase 14's loop: "
        + "; ".join(f"lr {r:g}: losses {t['losses']}, grad norms "
                    f"{t['grad_norms']}" for r, t in trials.items()))
    log(f"{TUNE_PATH}: the phase-14-rate trial equal to phase 14 bit for "
        f"bit: {equal14}; first losses equal: {first_equal}; best result's "
        f"final loss {best.metrics['loss']} (lowest final: lr {best_rate:g}, "
        f"{finals[best_rate]}); step ms (median of steps 3-7) "
        + ", ".join(f"lr {r:g} {t['step_ms_median']:.1f}"
                    for r, t in trials.items())
        + f" beside phase 14's {gang_base['step_ms_median']:.1f}; fit s "
        + ", ".join(f"lr {r:g} {t['fit_s']:.1f}" for r, t in trials.items())
        + f" beside phase 14's {gang_base['fit_s']['whole']:.1f}; tuning "
        f"{tune_s:.1f} s; launches per step in the trial's gang "
        f"{base_trial['launches_per_step']} (phase 4: {want}) ({smi})")
    log(f"{TUNE_PATH}: util.metrics Histogram {key} recorded in the trials: "
        f"count by trial {counts} through metrics_snapshot(), "
        f"{prom_count} through export_prometheus(); steps reported "
        f"{2 * GANG_STEPS}")
    if not equal14:
        raise SmokeFailure(f"{TUNE_PATH}: the trial at phase 14's rate "
                           "differs from phase 14")
    if not first_equal:
        raise SmokeFailure(f"{TUNE_PATH}: the trials' first losses differ")
    if best.metrics["loss"] != finals[best_rate]:
        raise SmokeFailure(f"{TUNE_PATH}: get_best_result() has final loss "
                           f"{best.metrics['loss']}, the lowest is "
                           f"{finals[best_rate]}")
    if any(t["launches_per_step"] != want for t in trials.values()):
        raise SmokeFailure(f"{TUNE_PATH}: launches per step "
                           f"{[t['launches_per_step'] for t in trials.values()]}"
                           f", phase 4 {want}")
    if (counts != {f"{r:g}": GANG_STEPS for r in trials}
            or prom_count != 2 * GANG_STEPS):
        raise SmokeFailure(f"{TUNE_PATH}: the step-ms histogram counts "
                           f"{counts} / {prom_count}, steps reported "
                           f"{2 * GANG_STEPS}")
    return out


# --- phase 17: serving gpt2_medium from a GPU replica ------------------------

def _serve_decorator(name, **kw):
    """``serve.<name>(**kw)``; without the package (run() then exits) the
    method stays as it is."""
    return (getattr(_serve, name)(**kw) if _serve is not None
            else (lambda fn: fn))


def last_logits(torch, model, prompts):
    """The f32 logits at each prompt's last position, as a CPU tensor [n, V]:
    the prompts (token lists) right-padded to the longest rounded up to
    SERVE_PAD (exact under causal attention), one `model.apply` on the
    card. inference_mode is entered here: it is per thread, and a batch
    runs on the batcher's thread."""
    lens = [len(p) for p in prompts]
    seq = -(-max(lens) // SERVE_PAD) * SERVE_PAD
    tokens = torch.zeros(len(prompts), seq, dtype=torch.long)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p)
    with torch.inference_mode():
        logits = model.apply(tokens.cuda())
        rows = torch.arange(len(prompts), device=logits.device)
        last = logits[rows, torch.tensor(lens, device=logits.device) - 1]
        out = last.float().cpu()
    return out.clone()          # a plain tensor, outside inference mode


class ServeReplicaTools:
    """What the driver reads in a phase-17 replica through its actor's
    ``call_method``: the launch counts of this process, its slots and
    memory."""

    def kernel_launches(self, reset=False):
        from ray_tpu_torch.ops import attention as A
        counts = dict(A.launches)
        if reset:
            A.reset_launch_counts()
        return counts

    def device_report(self):
        """(GPU slots, CUDA_VISIBLE_DEVICES, the card's name, bytes
        allocated on it after a gc)."""
        import torch

        import ray_tpu_torch as rt
        gc.collect()
        return (rt.get_runtime_context().get_accelerator_ids(),
                os.environ.get("CUDA_VISIBLE_DEVICES"),
                torch.cuda.get_device_name(0),
                torch.cuda.memory_allocated())


class GPT2Server(ServeReplicaTools):
    """Phase 17's deployment (user code: the package has no model server;
    the driver wraps it in ``serve.deployment`` with a card of its own):
    gpt2_medium from seed 0 on the card. A request is ``{"prompts":
    [[token, ...], ...]}``, with ``"format": "list"`` for JSON callers; its
    answer is each prompt's f32 logits at its last position, a CPU tensor
    [n, V] (lists for "list"). Concurrent requests are batched, up to
    SERVE_MAX_BATCH a forward."""

    def __init__(self):
        from ray_tpu_torch import models
        self.model = models.GPT(models.gpt2_medium(), device="cuda",
                                seed=0).eval()
        self.batch_sizes = []      # prompts in each forward

    @_serve_decorator("batch", max_batch_size=SERVE_MAX_BATCH,
                      batch_wait_timeout_s=SERVE_WAIT_S)
    def infer(self, requests):
        import torch

        prompts = [p for r in requests for p in r]
        self.batch_sizes.append(len(prompts))
        logits = last_logits(torch, self.model, prompts)
        out, i = [], 0
        for r in requests:
            out.append(logits[i:i + len(r)])
            i += len(r)
        return out

    def __call__(self, request):
        logits = self.infer(request["prompts"])
        return logits.tolist() if request.get("format") == "list" else logits

    def seen_batches(self):
        return list(self.batch_sizes)

    def profile_forward(self, prompts, path):
        """Device time of one batch's forward: the unprofiled ms (host
        clock to a synchronise, median of 3), then `profile_steps` over 2
        more; the flash forward's µs per launch from its class."""
        import torch

        model = self.model

        def one():
            last_logits(torch, model, prompts)
            torch.cuda.synchronize()

        one()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            one()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = sorted(times)[1]
        prof = profile_steps(torch, one, path, ms)
        layers = self.model.config.n_layers
        prof["flash_fwd_us"] = (prof["by_class_ms"]["flash kernels"] * 1e3
                                / layers)
        prof["forward_ms"] = ms
        return prof


class MuxGPT2(ServeReplicaTools):
    """Phase 17(e)'s deployment: one gpt2_medium per multiplexed model id
    (the id is its seed), at most one held by the replica."""

    @_serve_decorator("multiplexed", max_num_models_per_replica=1)
    def get_model(self, model_id):
        from ray_tpu_torch import models
        return models.GPT(models.gpt2_medium(), device="cuda",
                          seed=int(model_id)).eval()

    def __call__(self, request):
        import torch

        model = self.get_model(_serve.get_multiplexed_model_id())
        return last_logits(torch, model, request["prompts"])


def wf_logits(tokens, marker):
    """Phase 17(f)'s first workflow step, in a ``num_gpus=1`` task: the
    last-position logits of `tokens` (a CPU tensor [B, S]) through a
    seed-0 gpt2_medium on the card; appends a line to `marker`."""
    import torch

    from ray_tpu_torch import models
    with open(marker, "a") as f:
        f.write("wf_logits\n")
    model = models.GPT(models.gpt2_medium(), device="cuda", seed=0).eval()
    return last_logits(torch, model, tokens.tolist())


def wf_reduce(logits):
    """Phase 17(f)'s second step, on the CPU: each row's argmax and max."""
    return {"argmax": logits.argmax(-1).tolist(),
            "max": logits.max(-1).values.tolist()}


def autoscaled_flash():
    """Phase 17(f), in a ``num_gpus=1`` task on the node the autoscaler
    launched: its slots and card, and one flash forward at gpt2_medium's
    attention shape against its plain version (phase 2's bf16 rule)."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.ops import attention as A

    seen = torch.cuda.is_available()
    report = {"slots": rt.get_runtime_context().get_accelerator_ids(),
              "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
              "device": torch.cuda.get_device_name(0) if seen else None}
    if not seen:
        return report
    q, k, v, _ = make_case(torch, 1, 16, 16, 1024, 1024, 64,
                           torch.bfloat16, True, seed=17)
    A.reset_launch_counts()
    out, lse = A.flash_fwd(q, k, v, True)
    report["launches"] = dict(A.launches)
    p_out, p_lse = A.flash_fwd_plain(q, k, v, True)
    torch.cuda.synchronize()
    report["out"] = compare(out, p_out)
    report["lse_max_abs"] = compare(lse, p_lse)[0]
    return report


def _answers_within(torch, got, refs):
    """Answers `got` against `refs` (rows of [n, V]): the (max |err|,
    normwise) readings, how many had their argmax checked, and the
    failures as text."""
    atol, norm_rtol = SERVE_TOL
    readings, n_checked, bad = [], 0, []
    for i, (g, r) in enumerate(zip(got, refs)):
        err = (g.float() - r.float()).abs()
        max_abs, norm = err.max().item(), (err.norm() / r.norm()).item()
        top = r.topk(2).values
        checked = bool(top[0] - top[1] > 2 * atol)
        same = bool(g.argmax() == r.argmax())
        readings.append((max_abs, norm))
        n_checked += checked
        if max_abs > atol or norm > norm_rtol or (checked and not same):
            bad.append(f"#{i}: max {max_abs:.4g}, norm {norm:.3g}, "
                       f"argmax {'equal' if same else 'differs'}"
                       f"{' (margin > 2 atol)' if checked else ''}")
    return readings, n_checked, bad


def serve_phase(torch, A, models, smi, by_path, skip_main,
                profile_path=None):
    """Phase 17 (see the module docstring); under --skip-main (a) only."""
    import concurrent.futures
    import shutil
    import tempfile
    import urllib.request

    import numpy as np

    import chip_smoke as me
    import ray_tpu_torch as rt
    from ray_tpu_torch import exceptions, serve, state, workflow
    from ray_tpu_torch.dag import InputNode

    out = {}
    cfg = models.gpt2_medium()
    atol, norm_rtol = SERVE_TOL
    batch_a = _tokens(12, 1024, cfg.vocab_size, seed=1).tolist()

    # the driver's references: the same seed-0 model through the kernel, and
    # through the plain attention
    ref_model = models.GPT(cfg, device="cuda", seed=0).eval()
    ref_a = last_logits(torch, ref_model, batch_a)
    plain_model = models.GPT(dataclasses.replace(
        cfg, attention_impl="reference"), device="cuda", seed=0).eval()
    same_weights = all(torch.equal(p, q) for p, q in zip(
        ref_model.parameters(), plain_model.parameters()))
    plain_a = last_logits(torch, plain_model, batch_a)
    del plain_model
    plain_read, _, plain_bad = _answers_within(torch, ref_a, plain_a)
    out["kernel_vs_plain"] = plain_read
    log(f"{SERVE_PATH}: the driver's forward of phase 4's batch [12, 1024] "
        f"through the flash kernel against the plain attention: max |err| "
        f"{max(r[0] for r in plain_read):.4g} (<= {atol}), normwise "
        f"{max(r[1] for r in plain_read):.3g} (<= {norm_rtol:.0e}) over the "
        f"12 last-position logit rows; weights equal: {same_weights}")
    if not same_weights:
        raise SmokeFailure(f"{SERVE_PATH}: the plain model's weights differ")
    if plain_bad:
        raise SmokeFailure(f"{SERVE_PATH}: kernel against plain attention: "
                           + "; ".join(plain_bad))

    storage = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    rt.init(num_cpus=4)
    try:
        server = serve.deployment(
            ray_actor_options={"num_gpus": 1},
            max_concurrent_queries=SERVE_MAX_QUERIES)(me.GPT2Server)
        t0 = time.perf_counter()
        handle = serve.run(server.bind())
        controller = rt.get_actor("rtpu:serve_controller")
        (replica,) = rt.get(controller.get_replicas.remote("GPT2Server"))
        report = rt.get(replica.call_method.remote("device_report"),
                        timeout=600)
        out["replica_start_s"] = time.perf_counter() - t0
        name = torch.cuda.get_device_name(0)
        log(f"{SERVE_PATH}: replica up in {out['replica_start_s']:.1f} s: "
            f"slots {report[0]}, CUDA_VISIBLE_DEVICES {report[1]!r}, "
            f"{report[2]}, {report[3] / 2**30:.2f} GiB allocated")
        if report[:3] != ({"GPU": [0]}, "0", name):
            raise SmokeFailure(f"{SERVE_PATH}: the replica sees {report}")

        # (a) exactness: one request of 12 prompts, bit for bit
        rt.get(replica.call_method.remote("kernel_launches", True))
        t0 = time.perf_counter()
        got_a = handle.remote({"prompts": batch_a}).result(timeout=600)
        out["a_request_s"] = time.perf_counter() - t0
        counts = rt.get(replica.call_method.remote("kernel_launches"))
        by_path[SERVE_PATH] = counts
        bit_a = torch.equal(got_a, ref_a)
        log(f"{SERVE_PATH}: (a) one request of [12, 1024] in "
            f"{out['a_request_s']:.2f} s: logits {tuple(got_a.shape)} "
            f"{got_a.dtype}, equal to the driver's bit for bit: {bit_a}; "
            f"launches in the replica {counts}")
        want = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0}
        if counts != want:
            raise SmokeFailure(f"{SERVE_PATH}: (a) launches {counts}, "
                               f"expected {want}")
        if not bit_a:
            err = (got_a - ref_a).abs().max().item()
            raise SmokeFailure(f"{SERVE_PATH}: (a) the replica's logits "
                               f"differ from the driver's (max {err:.3g})")
        out["a"] = {"bit_equal": bit_a, "launches": counts}
        if skip_main:
            return out

        # (b) traffic: 16 closed-loop clients, 6 single-prompt requests each
        rng = np.random.default_rng(2)
        lens = rng.integers(SERVE_LENS[0], SERVE_LENS[1] + 1, SERVE_REQUESTS)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
        per_client = SERVE_REQUESTS // SERVE_CLIENTS
        answers, latency = [None] * SERVE_REQUESTS, [0.0] * SERVE_REQUESTS

        def client(c):
            for j in range(per_client):
                i = c * per_client + j
                t = time.perf_counter()
                answers[i] = handle.remote(
                    {"prompts": [prompts[i]]}).result(timeout=600)[0]
                latency[i] = time.perf_counter() - t

        before = len(rt.get(replica.call_method.remote("seen_batches")))
        rt.get(replica.call_method.remote("kernel_launches", True))
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            list(pool.map(client, range(SERVE_CLIENTS)))
        wall = time.perf_counter() - t0
        traffic_counts = rt.get(replica.call_method.remote("kernel_launches"))
        sizes = rt.get(replica.call_method.remote("seen_batches"))[before:]
        rows = [r for r in state.serve_requests(limit=1000)
                if r["deployment"] == "GPT2Server"]
        row_sizes = {}
        for r in rows:
            row_sizes[r["batch_size"]] = row_sizes.get(r["batch_size"], 0) + 1
        refs_b = [last_logits(torch, ref_model, [p])[0] for p in prompts]
        read_b, checked, bad_b = _answers_within(torch, answers, refs_b)
        lat = sorted(latency)
        p50 = lat[len(lat) // 2]
        p99 = lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)]
        out["b"] = {
            "requests_per_s": SERVE_REQUESTS / wall,
            "prompt_tokens_per_s": int(sum(lens)) / wall, "wall_s": wall,
            "p50_s": p50, "p99_s": p99, "batch_sizes": sizes,
            "access_log_batch_sizes": row_sizes,
            "launches": traffic_counts,
            "max_abs_err": max(r[0] for r in read_b),
            "max_norm_err": max(r[1] for r in read_b),
            "argmax_checked": checked}
        log(f"{SERVE_PATH}: (b) {SERVE_REQUESTS} requests from "
            f"{SERVE_CLIENTS} closed-loop clients ({per_client} each), prompt "
            f"lengths {SERVE_LENS[0]}-{SERVE_LENS[1]} (default_rng(2)), "
            f"{int(sum(lens))} prompt tokens in {wall:.3f} s: "
            f"{out['b']['requests_per_s']:.2f} requests/s, "
            f"{out['b']['prompt_tokens_per_s']:.0f} prompt tokens/s, latency "
            f"p50 {p50 * 1e3:.1f} ms p99 {p99 * 1e3:.1f} ms; forwards "
            f"{len(sizes)} of sizes {sizes}; access-log batch sizes "
            f"{row_sizes} (requests per size, (a) included); launches in the "
            f"replica {traffic_counts} ({smi})")
        log(f"{SERVE_PATH}: (b) answers against the driver's forward of each "
            f"prompt alone (batch 1, unpadded): max |err| "
            f"{out['b']['max_abs_err']:.4g} (<= {atol}), normwise "
            f"{out['b']['max_norm_err']:.3g} (<= {norm_rtol:.0e}); argmax "
            f"checked on {checked} answers (top-2 margin > {2 * atol})")
        if bad_b:
            raise SmokeFailure(f"{SERVE_PATH}: (b) answers off: "
                               + "; ".join(bad_b))
        want_b = {"flash_fwd": cfg.n_layers * len(sizes), "flash_bwd_dq": 0,
                  "flash_bwd_dkv": 0}
        if traffic_counts != want_b or sum(sizes) != SERVE_REQUESTS:
            raise SmokeFailure(f"{SERVE_PATH}: (b) launches {traffic_counts}"
                               f" for forwards {sizes}")
        if profile_path:
            path = Path(profile_path)
            prof = rt.get(replica.call_method.remote(
                "profile_forward", batch_a,
                str(path.with_name(f"{path.stem}.{SERVE_PATH}{path.suffix}"))),
                timeout=600)
            out["b"]["profile"] = prof
            log(f"{SERVE_PATH}: (b) --profile, in the replica: one forward "
                f"of [12, 1024] {prof['forward_ms']:.2f} ms, device busy "
                f"{prof['busy_ms']:.3f} ms a batch (idle "
                f"{prof['idle_share']:.3f}), flash forward "
                f"{prof['flash_fwd_us']:.1f} us a launch ({smi})")

        # (c) HTTP: 8 of (b)'s prompts as JSON through the gateway
        url = serve.start_http(port=0)

        def post(i):
            body = json.dumps({"prompts": [prompts[i]],
                               "format": "list"}).encode()
            req = urllib.request.Request(
                f"{url}/GPT2Server", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                return json.loads(resp.read())["result"][0]

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(SERVE_HTTP) as pool:
            http = list(pool.map(post, range(SERVE_HTTP)))
        http_s = time.perf_counter() - t0
        serve.stop_http()
        got_c = [torch.tensor(h, dtype=torch.float32) for h in http]
        read_c, _, bad_c = _answers_within(torch, got_c,
                                           refs_b[:SERVE_HTTP])
        out["c"] = {"seconds": http_s,
                    "max_abs_err": max(r[0] for r in read_c),
                    "max_norm_err": max(r[1] for r in read_c)}
        log(f"{SERVE_PATH}: (c) {SERVE_HTTP} JSON requests through "
            f"serve.start_http in {http_s:.2f} s: max |err| "
            f"{out['c']['max_abs_err']:.4g}, normwise "
            f"{out['c']['max_norm_err']:.3g} against the driver's")
        if bad_c:
            raise SmokeFailure(f"{SERVE_PATH}: (c) answers off: "
                               + "; ".join(bad_c))

        # (d) redeploy: the slot comes back to a new replica
        t0 = time.perf_counter()
        serve.delete("GPT2Server")
        handle = serve.run(server.bind())
        (replica,) = rt.get(controller.get_replicas.remote("GPT2Server"))
        report = rt.get(replica.call_method.remote("device_report"),
                        timeout=600)
        got_d = handle.remote({"prompts": batch_a}).result(timeout=600)
        out["d"] = {"seconds": time.perf_counter() - t0,
                    "bit_equal": torch.equal(got_d, ref_a),
                    "slots": report[0], "visible": report[1]}
        log(f"{SERVE_PATH}: (d) delete and redeploy in "
            f"{out['d']['seconds']:.1f} s: the new replica's slots "
            f"{report[0]}, CUDA_VISIBLE_DEVICES {report[1]!r}; (a)'s request "
            f"bit-equal: {out['d']['bit_equal']}")
        if report[:3] != ({"GPU": [0]}, "0", name) \
                or not out["d"]["bit_equal"]:
            raise SmokeFailure(f"{SERVE_PATH}: (d) redeploy: {out['d']}")
        serve.delete("GPT2Server")

        # (e) multiplexing on the card: one model at a time
        t0 = time.perf_counter()
        mux = serve.run(serve.deployment(
            ray_actor_options={"num_gpus": 1})(me.MuxGPT2).bind())
        (replica,) = rt.get(controller.get_replicas.remote("MuxGPT2"))
        one_model = sum(p.numel() * p.element_size()
                        for p in ref_model.parameters())
        mux_out = {}
        for seed in (0, 1):
            got = mux.options(multiplexed_model_id=str(seed)).remote(
                {"prompts": batch_a}).result(timeout=600)
            held = rt.get(replica.multiplexed_model_ids.remote())
            nbytes = rt.get(replica.call_method.remote("device_report"))[3]
            fresh = (ref_model if seed == 0 else
                     models.GPT(cfg, device="cuda", seed=seed).eval())
            mux_out[seed] = {"held": held, "bytes": nbytes,
                             "bit_equal": torch.equal(
                                 got, last_logits(torch, fresh, batch_a))}
            del fresh
        out["e"] = {"seconds": time.perf_counter() - t0,
                    "one_model_bytes": one_model, "by_seed": mux_out}
        log(f"{SERVE_PATH}: (e) multiplexed seeds 0 then 1 (at most one "
            "model a replica) in "
            f"{out['e']['seconds']:.1f} s: " + "; ".join(
                f"seed {s}: models held {m['held']}, "
                f"{m['bytes'] / 2**20:.1f} MiB allocated after gc "
                f"(one model {one_model / 2**20:.1f} MiB), bit-equal to a "
                f"fresh model: {m['bit_equal']}" for s, m in mux_out.items()))
        for seed, m in mux_out.items():
            if (m["held"] != [str(seed)] or not m["bit_equal"]
                    or abs(m["bytes"] - one_model) > SERVE_MUX_SLACK):
                raise SmokeFailure(f"{SERVE_PATH}: (e) seed {seed}: {m}")
        serve.delete("MuxGPT2")

        # (f) a durable workflow whose first step runs on the card
        t0 = time.perf_counter()
        workflow.init(storage)
        marker = os.path.join(storage, "marker")
        with InputNode() as inp:
            step = rt.remote(num_gpus=1)(me.wf_logits).bind(inp, marker)
            dag = rt.remote(me.wf_reduce).bind(step)
        tokens_a = torch.tensor(batch_a)
        first = workflow.run(dag, tokens_a, workflow_id=SERVE_WORKFLOW)
        again = workflow.run(dag, torch.tensor(batch_a),
                             workflow_id=SERVE_WORKFLOW)
        ran = open(marker).read().splitlines()
        want_wf = {"argmax": ref_a.argmax(-1).tolist(),
                   "max": ref_a.max(-1).values.tolist()}
        out["f_workflow"] = {"seconds": time.perf_counter() - t0,
                             "step_runs": len(ran),
                             "status": workflow.get_status(SERVE_WORKFLOW),
                             "equal": first == want_wf and again == first}
        workflow.init(None)
        log(f"{SERVE_PATH}: (f) workflow {SERVE_WORKFLOW}: the num_gpus=1 "
            f"step and the CPU reduction in "
            f"{out['f_workflow']['seconds']:.1f} s, status "
            f"{out['f_workflow']['status']}, the rerun read the stored "
            f"output; step runs {len(ran)}; argmax and max equal to (a)'s: "
            f"{out['f_workflow']['equal']}")
        if len(ran) != 1 or not out["f_workflow"]["equal"]:
            raise SmokeFailure(f"{SERVE_PATH}: (f) workflow: "
                               f"{out['f_workflow']}")
    except exceptions.RayTpuError as exc:
        raise SmokeFailure(f"{SERVE_PATH}: {type(exc).__name__}: {exc}") \
            from exc
    finally:
        serve.shutdown()
        rt.shutdown()
        workflow.init(None)
        shutil.rmtree(storage, ignore_errors=True)

    out["f_autoscaler"] = autoscaler_check(torch, smi)
    return out


def autoscaler_check(torch, smi):
    """Phase 17(f)'s autoscaler: a GPU node type scaled up for a queued
    num_gpus=1 task and drained when idle."""
    import chip_smoke as me
    import ray_tpu_torch as rt
    from ray_tpu_torch import exceptions
    from ray_tpu_torch.autoscaler import (AutoscalerConfig, FakeNodeProvider,
                                          NodeType, StandardAutoscaler)
    from ray_tpu_torch.cluster_utils import Cluster

    t0 = time.perf_counter()
    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    rt.init(address=cluster,
            _system_config={"infeasible_task_grace_s": 120.0})
    provider = FakeNodeProvider(cluster)
    scaler = StandardAutoscaler(cluster.gcs, provider, AutoscalerConfig(
        node_types={"gpu_worker": NodeType(
            resources={"CPU": 2.0, "GPU": 1.0}, max_workers=1)},
        idle_timeout_s=3.0, update_interval_s=0.4))
    scaler.start()
    try:
        head_gpus = rt.cluster_resources().get("GPU", 0)
        report = rt.get(rt.remote(num_gpus=1)(me.autoscaled_flash).remote(),
                        timeout=300)
        up_s = time.perf_counter() - t0
        launched = scaler.num_launched
        deadline = time.monotonic() + 120
        while provider.non_terminated_nodes() and time.monotonic() < deadline:
            time.sleep(0.2)
        drained = not provider.non_terminated_nodes()
        out = {"head_gpus": head_gpus, "task": report, "launched": launched,
               "terminated": scaler.num_terminated, "drained": drained,
               "up_s": up_s, "seconds": time.perf_counter() - t0}
    except exceptions.RayTpuError as exc:
        raise SmokeFailure(f"{SERVE_PATH}: (f) autoscaler: "
                           f"{type(exc).__name__}: {exc}") from exc
    finally:
        scaler.stop()
        rt.shutdown()
        cluster.shutdown()
    norm_tol, atol, lse_atol = KERNEL_TOL["bf16"]
    err = report.get("out")
    log(f"{SERVE_PATH}: (f) autoscaler: head GPUs {head_gpus}; the queued "
        f"num_gpus=1 task ran on a launched gpu_worker node after "
        f"{up_s:.1f} s: slots {report['slots']}, CUDA_VISIBLE_DEVICES "
        f"{report['visible']!r}, {report['device']}; its flash forward "
        f"against the plain version: " + (
            f"out max {err[0]:.3e}, norm {err[1]:.3e} (<= {norm_tol:.0e}), "
            f"atol needed {err[2]:.3e} (<= {atol:.0e}), lse max "
            f"{report['lse_max_abs']:.3e} (<= {lse_atol:.0e}), launches "
            f"{report['launches']}" if err else "no card")
        + f"; launched {launched}, terminated {out['terminated']}, drained: "
        f"{drained} ({out['seconds']:.1f} s) ({smi})")
    name = torch.cuda.get_device_name(0)
    ok = (head_gpus == 0 and launched == 1 and drained
          and out["terminated"] == 1
          and report["slots"] == {"GPU": [0]} and report["visible"] == "0"
          and report["device"] == name and err is not None
          and err[1] <= norm_tol and err[2] <= atol
          and report["lse_max_abs"] <= lse_atol
          and report["launches"]["flash_fwd"] == 1)
    if not ok:
        raise SmokeFailure(f"{SERVE_PATH}: (f) autoscaler: {out}")
    return out


# --- phase 18: the node main and the head's services on the card ------------
# A process-isolated cluster: a head node process without a GPU and a node
# process with one slot; a job submitted through the head's job service runs
# phase 4's path in a num_gpus=1 task, which the workers import from this
# module by its name. The task's result reaches this process through the
# job's logs, on a line that starts with JOB_RESULT.

def job_task(smi, skip_main):
    """Phase 18's task, in a worker of the GPU node: phase 4's path (under
    --skip-main a 2-layer cut of it at batch 2 x seq 256). Returns the
    losses, the step ms, the launch counts, where it ran and what it
    printed."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import models
    from ray_tpu_torch.ops import attention as A

    cfg, batch = phase_cut(skip_main)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        counts, result = train_path(torch, A, models, smi, JOB_PATH, cfg,
                                    (batch,))
    return {"losses": result["losses"], "grad_norms": result["grad_norms"],
            "step_ms": result["step_ms"], "launches": counts,
            "n_layers": cfg.n_layers,
            "node_id": rt.get_runtime_context().get_node_id().hex(),
            "pid": os.getpid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device": torch.cuda.get_device_name(0),
            "printed": printed.getvalue()}


def job_driver(args):
    """Phase 18's job driver, run by the submitted entrypoint with
    RTPU_ADDRESS set by the head: it attaches to the cluster, runs
    job_task in a num_gpus=1 task and prints the result on one line."""
    import chip_smoke as me
    import ray_tpu_torch as rt

    t0 = time.perf_counter()
    rt.init(address=os.environ["RTPU_ADDRESS"])
    try:
        out = rt.get(rt.remote(num_gpus=1)(me.job_task).remote(
            args["smi"], args["skip_main"]), timeout=900)
    finally:
        rt.shutdown()
    for ln in out.pop("printed").splitlines():
        print(f"  (task) {ln}")
    out.update(driver_pid=os.getpid(), driver_s=time.perf_counter() - t0)
    print(JOB_RESULT + json.dumps(out), flush=True)


JOB_DRIVER = """\
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke
chip_smoke.job_driver(json.loads({args!r}))
"""


def card_holders():
    """The processes that hold a context on the card: the pids of this
    machine whose open files include a device node /dev/nvidia<N>, and
    how many compute apps nvidia-smi lists. On the card's machine
    nvidia-smi names each app by a pid of another pid namespace (1 for
    every process), so its pids cannot name ours; the holders are found
    by their handles, and the two counts must agree."""
    holders = set()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            fds = os.listdir(f"/proc/{entry}/fd")
        except OSError:
            continue
        for fd in fds:
            try:
                target = os.readlink(f"/proc/{entry}/fd/{fd}")
            except OSError:
                continue
            if re.fullmatch(r"/dev/nvidia\d+", target):
                holders.add(int(entry))
                break
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    listed = [ln for ln in out.stdout.splitlines() if ln.strip()]
    return holders, len(listed)


def cli_status(session):
    """`python -m ray_tpu_torch.scripts.cli status` on the head's
    session: its "GPU: <available> / <total> available" line."""
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "--session",
         session, "status"], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        raise SmokeFailure(f"{JOB_PATH}: cli status failed: {out.stderr}")
    line = next((ln.strip() for ln in out.stdout.splitlines()
                 if ln.strip().startswith("GPU:")), None)
    return line, out.stdout


def dashboard_sample(address):
    """The dashboard's newest cluster snapshot (its /api/history ring)."""
    import urllib.request

    with urllib.request.urlopen(f"http://{address}/api/history",
                                timeout=30) as resp:
        samples = json.loads(resp.read())["samples"]
    return samples[-1] if samples else None


def job_phase(torch, smi, by_path, base, skip_main):
    """Phase 18 (see the module docstring); `base` is phase 4's result
    (None under --skip-main)."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import exceptions
    from ray_tpu_torch._private.gcs_service import RemoteControlPlane
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.job import JobSubmissionClient

    out = {}
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    cluster = Cluster(process_isolated=True, head_node_args={"num_cpus": 2})
    try:
        out["head_ready_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        gpu_node = cluster.add_node(num_cpus=2, num_gpus=1)
        out["gpu_node_ready_s"] = time.perf_counter() - t0
        head = cluster.head
        node_pids = {head.pid, gpu_node.pid}
        rt.init(address=cluster)
        try:
            # (a) the GPU slot is the second node's only
            gpus = {n["node_id"].hex(): n["resources"].get("GPU")
                    for n in rt.nodes() if n["alive"]}
            out["node_gpus"] = gpus
            log(f"{JOB_PATH}: (a) head node process ready in "
                f"{out['head_ready_s']:.3f} s, GPU node process in "
                f"{out['gpu_node_ready_s']:.3f} s; nodes' GPU {gpus}")
            if gpus != {head.node_id_hex: None, gpu_node.node_id_hex: 1.0}:
                raise SmokeFailure(f"{JOB_PATH}: (a) nodes' GPU {gpus}")

            # (b) the job, at the addresses the head published
            gcs = RemoteControlPlane(cluster.gcs_address)
            try:
                job_api = gcs.kv_get(b"__rtpu_job_api").decode()
                dash = gcs.kv_get(b"__rtpu_dashboard").decode()
            finally:
                gcs.close()
            client = JobSubmissionClient(job_api)
            script = os.path.join(tempfile.mkdtemp(
                prefix="rtpt_job_", dir=cluster.session_dir), "driver.py")
            with open(script, "w") as f:
                f.write(JOB_DRIVER.format(
                    root=str(Path(__file__).resolve().parent),
                    args=json.dumps({"smi": smi, "skip_main": skip_main})))
            t_submit = time.perf_counter()
            job_id = client.submit_job(
                entrypoint=f"{sys.executable} {script}")

            # (c) what the dashboard, the CLI and nvidia-smi show while
            # the task holds the card
            statuses, apps, held = [], set(), None
            before, listed_before = card_holders()
            deadline = time.monotonic() + 900
            while True:
                status = client.get_job_status(job_id)["status"]
                if not statuses or statuses[-1] != status:
                    statuses.append(status)
                if status in ("SUCCEEDED", "FAILED", "STOPPED"):
                    break
                if time.monotonic() > deadline:
                    raise SmokeFailure(f"{JOB_PATH}: the job never ended")
                apps |= card_holders()[0]
                sample = dashboard_sample(dash)
                if held is None and sample and sample["gpu_used"] == 1.0:
                    held = {"sample": sample,
                            "cli": cli_status(head.ready["session_dir"])[0],
                            "after_s": time.perf_counter() - t_submit}
                time.sleep(0.5)
            out["job_s"] = time.perf_counter() - t_submit
            after, listed_after = card_holders()
            apps |= after
            logs = client.get_job_logs(job_id)
            line = next((ln for ln in logs.splitlines()
                         if ln.startswith(JOB_RESULT)), None)
            for ln in logs.splitlines():
                if not ln.startswith(JOB_RESULT):
                    log(f"  (job) {ln}")
            if status != "SUCCEEDED" or line is None:
                raise SmokeFailure(f"{JOB_PATH}: job {status}; its logs:\n"
                                   + logs[-4000:])
            res = json.loads(line[len(JOB_RESULT):])
            by_path[JOB_PATH] = res["launches"]
            out.update(statuses=statuses, result=res, held=held)

            # after the job: the slot is free again
            t_done = time.time()
            deadline = time.monotonic() + 30
            freed = dashboard_sample(dash)
            while freed is None or freed["ts"] <= t_done:
                if time.monotonic() > deadline:
                    break
                time.sleep(0.5)
                freed = dashboard_sample(dash)
            free_cli = cli_status(head.ready["session_dir"])[0]
            out["freed"] = {"sample": freed, "cli": free_cli}
            worker = res["pid"]
            holders = {"worker": worker in apps,
                       "node_processes": sorted(node_pids & apps),
                       "driver": res["driver_pid"] in apps,
                       "before": sorted(before),
                       "after": sorted(after),
                       "smi_listed": [listed_before, listed_after]}
            out["context_holders"] = holders

            n_steps = len(res["losses"])
            per_step = {k: v / n_steps for k, v in res["launches"].items()}
            want = {"flash_fwd": 2 * res["n_layers"],
                    "flash_bwd_dq": res["n_layers"],
                    "flash_bwd_dkv": res["n_layers"]}
            same = (base is not None and res["losses"] == base["losses"]
                    and res["grad_norms"] == base["grad_norms"])
            out["losses_bit_equal"] = same
            log(f"{JOB_PATH}: (b) job {job_id} {statuses} in "
                f"{out['job_s']:.1f} s from submit (its driver "
                f"{res['driver_s']:.1f} s); the task in pid {worker} on node "
                f"{res['node_id'][:12]} (CUDA_VISIBLE_DEVICES "
                f"{res['visible']!r}, {res['device']}): step "
                f"{res['step_ms']:.1f} ms" + (
                    f" (phase 4 {base['step_ms']:.1f} ms)" if base else "")
                + f", launches per step {per_step}; losses {res['losses']}; "
                f"equal to phase 4's bit for bit: {same} ({smi})")
            log(f"{JOB_PATH}: (c) while the task held the card "
                f"({held['after_s']:.1f} s after submit) the dashboard's "
                f"gpu_used {held['sample']['gpu_used']} of "
                f"{held['sample']['gpu_total']}, cli status {held['cli']!r}; "
                f"after the job gpu_used "
                f"{freed['gpu_used'] if freed else None}, cli "
                f"{free_cli!r}; processes holding the card "
                f"{sorted(before)} before the job (nvidia-smi lists "
                f"{listed_before}), {sorted(after)} after ({listed_after}), "
                f"{sorted(apps)} seen in all: the task's worker {worker} "
                f"{holders['worker']}, node processes {sorted(node_pids)} "
                f"{holders['node_processes'] or 'none'}, the job's driver "
                f"{res['driver_pid']} {holders['driver']}"
                if held else f"{JOB_PATH}: (c) the dashboard never showed "
                "the GPU in use")
            bad = []
            if res["node_id"] != gpu_node.node_id_hex:
                bad.append(f"the task ran on node {res['node_id']}")
            if per_step != want:
                bad.append(f"launches per step {per_step}, want {want}")
            if base is not None and not same:
                bad.append("the losses differ from phase 4's")
            if held is None or held["cli"] != "GPU: 0 / 1 available":
                bad.append(f"while held: {held}")
            if (freed is None or freed["gpu_used"] != 0.0
                    or free_cli != "GPU: 1 / 1 available"):
                bad.append(f"after the job: {out['freed']}")
            if (not holders["worker"] or holders["node_processes"]
                    or holders["driver"] or worker not in after
                    or after - before != {worker}
                    or listed_before != len(before)
                    or listed_after != len(after)):
                bad.append(f"context holders {holders}, seen {sorted(apps)}")
            if bad:
                raise SmokeFailure(f"{JOB_PATH}: " + "; ".join(bad))

            # (d) the GPU node removed: its worker lets the card go and
            # the head reports the node dead
            t0 = time.perf_counter()
            cluster.remove_node(gpu_node)
            gone = dead = None
            while gone is None or dead is None:
                elapsed = time.perf_counter() - t0
                if elapsed > NODE_GONE_S:
                    raise SmokeFailure(
                        f"{JOB_PATH}: (d) {NODE_GONE_S} s after remove_node: "
                        f"worker released the card: {gone is not None}, "
                        f"node reported dead: {dead is not None}")
                if gone is None:
                    now, listed = card_holders()
                    if worker not in now and listed == len(before):
                        gone = elapsed
                if dead is None and not any(
                        n["alive"] for n in rt.nodes()
                        if n["node_id"].hex() == gpu_node.node_id_hex):
                    dead = elapsed
                time.sleep(0.2)
            out.update(released_s=gone, dead_s=dead)
            log(f"{JOB_PATH}: (d) after remove_node the worker let the "
                f"card go (nvidia-smi back to {len(before)} app(s)) in "
                f"{gone:.2f} s and the head reported the node dead in "
                f"{dead:.2f} s (limit {NODE_GONE_S:.0f} s)")
        except exceptions.RayTpuError as exc:
            raise SmokeFailure(f"{JOB_PATH}: {type(exc).__name__}: {exc}") \
                from exc
        finally:
            rt.shutdown()
    finally:
        cluster.shutdown()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def phase_cut(skip_main):
    """Phase 4's model and batch, or under --skip-main phase 18's 2-layer
    cut of it at batch 2 x seq 256."""
    from ray_tpu_torch import models

    if skip_main:
        return dataclasses.replace(models.gpt2_medium(
            max_seq_len=256, remat_policy="dots"), n_layers=2), 2
    return models.gpt2_medium(max_seq_len=1024, remat_policy="dots"), 12


def stream_train(smi, skip_main):
    """Phase 19(a)'s streaming task, in a num_gpus=1 worker: phase 4's path
    (phase_cut) in a thread, each step's loss, grad norm and ms yielded as
    the step ends, stamped with this worker's clock; then one last item
    with the launch counts and where it ran."""
    import queue
    import threading

    import torch

    from ray_tpu_torch import models
    from ray_tpu_torch.ops import attention as A

    cfg, batch = phase_cut(skip_main)
    items = queue.Queue()
    done = {}

    def on_step(i, loss, norm, ms):
        items.put({"step": i, "loss": loss, "grad_norm": norm,
                   "step_ms": ms, "t_end": time.time()})

    def body():
        printed = io.StringIO()
        try:
            with contextlib.redirect_stdout(printed):
                done["counts"], done["result"] = train_path(
                    torch, A, models, smi, STREAM_PATH, cfg, (batch,),
                    on_step=on_step)
        except BaseException as exc:   # raised again in the generator
            done["error"] = exc
        finally:
            done["printed"] = printed.getvalue()
            items.put(None)

    runner = threading.Thread(target=body, name="chip-smoke-stream-train")
    runner.start()
    while (item := items.get()) is not None:
        yield item
    runner.join()
    if "error" in done:
        raise done["error"]
    yield {"launches": done["counts"], "n_layers": cfg.n_layers,
           "step_ms": done["result"]["step_ms"], "pid": os.getpid(),
           "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
           "device": torch.cuda.get_device_name(0),
           "printed": done["printed"]}


def paced_stream(n, progress):
    """Phase 19(a)'s second stream, num_gpus=1: `n` small sums on the card,
    the count yielded so far written to `progress` before each item, and
    "done" once the last is out."""
    import torch

    x = torch.arange(1024, device="cuda", dtype=torch.float32)
    for i in range(n):
        Path(progress).write_text(str(i + 1))
        yield float((x * i).sum())
    Path(progress).write_text("done")


def slot_probe(progress):
    """Phase 19(a): a num_gpus=1 task's start on this worker's clock, its
    slot and what the closed stream last wrote."""
    import ray_tpu_torch as rt

    return {"t_start": time.time(), "pid": os.getpid(),
            "slots": rt.get_runtime_context().get_accelerator_ids(),
            "progress": Path(progress).read_text()}


def _mark(marks, kind):
    """One file in `marks` for each execution of a phase-19(b) task."""
    Path(marks, f"{kind}.{os.getpid()}.{time.time_ns()}").touch()


def lineage_tokens(batch, seq, vocab, seed, marks):
    """Phase 19(b)'s CPU task: the [batch, seq] tokens from `seed`."""
    import torch

    _mark(marks, "tokens")
    return torch.from_numpy(_tokens(batch, seq, vocab, seed))


def lineage_logits(tokens, skip_main, marks):
    """Phase 19(b)'s num_gpus=1 task: phase_cut's model from seed 0, one
    forward of `tokens` on the card through the flash forward kernel; the
    f32 logits at the last position as a CPU tensor, the launch counts of
    the forward and where it ran."""
    import torch

    from ray_tpu_torch import models
    from ray_tpu_torch.ops import attention as A

    _mark(marks, "logits")
    cfg, _ = phase_cut(skip_main)
    model = models.GPT(cfg, device="cuda", seed=0).eval()
    A.reset_launch_counts()
    with torch.inference_mode():
        logits = model.apply(tokens.cuda())[:, -1].float().cpu()
    torch.cuda.synchronize()
    return {"logits": logits.clone(), "launches": dict(A.launches),
            "n_layers": cfg.n_layers, "pid": os.getpid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device": torch.cuda.get_device_name(0)}


def task_kinds_phase(torch, smi, by_path, base, skip_main):
    """Phase 19 (see the module docstring); `base` is phase 4's result
    (None under --skip-main)."""
    import tempfile

    import chip_smoke as me
    import ray_tpu_torch as rt
    from ray_tpu_torch import exceptions
    from ray_tpu_torch._private.config import CONFIG

    out = {}
    t_phase = time.perf_counter()
    rt.init(num_cpus=4)
    try:
        # (a) a streaming training task, consumed while it trains
        t_submit = time.time()
        gen = rt.remote(num_gpus=1)(me.stream_train).options(
            num_returns="streaming").remote(smi, skip_main)
        items, arrived = [], []
        for ref in gen:
            items.append(rt.get(ref, timeout=900))
            arrived.append(time.time())
        final, steps = items[-1], items[:-1]
        for ln in final.pop("printed").splitlines():
            log(f"  (task) {ln}")
        by_path[STREAM_PATH] = final["launches"]
        losses = [x["loss"] for x in steps]
        norms = [x["grad_norm"] for x in steps]
        n_layers = final["n_layers"]
        per_step = {k: v / len(steps) for k, v in final["launches"].items()}
        want = {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers,
                "flash_bwd_dkv": n_layers}
        same = (base is not None and losses == base["losses"]
                and norms == base["grad_norms"])
        first_s, total_s = arrived[0] - t_submit, arrived[-1] - t_submit
        ahead_s = steps[-1]["t_end"] - arrived[0]
        out["stream"] = {"losses": losses, "grad_norms": norms,
                         "step_ms": [x["step_ms"] for x in steps],
                         "first_item_s": first_s, "total_s": total_s,
                         "first_before_last_step_s": ahead_s,
                         "launches_per_step": per_step,
                         "losses_bit_equal": same, "pid": final["pid"],
                         "visible": final["visible"]}
        log(f"{STREAM_PATH}: (a) {len(steps)} steps streamed from a "
            f"num_gpus=1 task (pid {final['pid']}, CUDA_VISIBLE_DEVICES "
            f"{final['visible']!r}, {final['device']}): the first item "
            f"{first_s:.3f} s after submit, {ahead_s:.3f} s before the last "
            f"step ended (worker clock), the last {total_s:.3f} s; step ms "
            f"{[round(x['step_ms'], 1) for x in steps]}; launches per step "
            f"{per_step}; losses {losses}; equal to phase 4's bit for bit: "
            f"{same} ({smi})")
        bad = []
        if per_step != want:
            bad.append(f"launches per step {per_step}, want {want}")
        if base is not None and not same:
            bad.append(f"losses {losses} and grad norms {norms} differ from "
                       f"phase 4's {base['losses']} {base['grad_norms']}")
        if not skip_main and ahead_s <= 0:
            # under --skip-main the 2-layer cut's steps take milliseconds
            bad.append("the first item arrived after the last step ended")
        if final["visible"] != "0":
            bad.append(f"CUDA_VISIBLE_DEVICES {final['visible']!r}")
        if bad:
            raise SmokeFailure(f"{STREAM_PATH}: (a) " + "; ".join(bad))

        # ... then a stream held by its backpressure window, closed after
        # two items: its producer runs out and the slot goes to the next
        # num_gpus=1 task
        window = CONFIG.generator_backpressure_window
        progress = os.path.join(tempfile.mkdtemp(
            prefix="rtpt_stream_", dir=rt._global_node.session_dir),
            "progress")
        gen = rt.remote(num_gpus=1)(me.paced_stream).options(
            num_returns="streaming").remote(STREAM_CLOSE_ITEMS, progress)
        got = [rt.get(next(gen), timeout=300) for _ in range(2)]
        time.sleep(1.0)   # an unpaced producer would finish here
        held = Path(progress).read_text()
        t_close = time.time()
        del gen
        gc.collect()
        probe = rt.get(rt.remote(num_gpus=1)(me.slot_probe).remote(progress),
                       timeout=300)
        slot_s = probe["t_start"] - t_close
        out["close"] = {"items": got, "held_at": held, "window": window,
                        "slot_free_s": slot_s, "probe": probe}
        log(f"{STREAM_PATH}: (a) a stream of {STREAM_CLOSE_ITEMS} held at "
            f"{held} items (window {window}) after 2 were read; closed, its "
            f"producer ran out ({probe['progress']!r}) and the next "
            f"num_gpus=1 task started on slots {probe['slots']} "
            f"{slot_s:.3f} s after the close (limit {CLOSE_SLOT_S:.0f} s)")
        if (got != [0.0, float(sum(range(1024)))] or not held.isdigit()
                or int(held) > window + 2 or probe["progress"] != "done"
                or probe["slots"] != {"GPU": [0]} or slot_s > CLOSE_SLOT_S):
            raise SmokeFailure(f"{STREAM_PATH}: (a) the closed stream: "
                               f"{out['close']}")

        # (b) lineage: a lost result of the card computed again
        cfg, batch = phase_cut(skip_main)
        marks = tempfile.mkdtemp(prefix="rtpt_lineage_",
                                 dir=rt._global_node.session_dir)
        node = rt._global_node
        t0, t_first = time.perf_counter(), time.time()
        tokens = rt.remote(me.lineage_tokens).remote(
            batch, cfg.max_seq_len, cfg.vocab_size, 1, marks)
        result = rt.remote(num_gpus=1)(me.lineage_logits).remote(
            tokens, skip_main, marks)
        first = rt.get(result, timeout=600)
        first_get_s = time.perf_counter() - t0
        for ref in (tokens, result):
            node.store.free([ref.id])
            node.gcs.drop_location(ref.id)
        lost = not any(node.store.contains(r.id) for r in (tokens, result))
        t0, t_rebuild = time.perf_counter(), time.time()
        again = rt.get(result, timeout=600)
        rebuild_s = time.perf_counter() - t0
        # each execution: its task, worker pid and start, in seconds after
        # the get that ran it began
        runs, starts = {}, []
        for f in sorted(os.listdir(marks), key=lambda f: int(f.split(".")[2])):
            kind, pid, t_ns = f.split(".")
            runs[kind] = runs.get(kind, 0) + 1
            t = int(t_ns) / 1e9
            starts.append((kind, int(pid), round(
                t - (t_rebuild if t >= t_rebuild else t_first), 3)))
        by_path[LINEAGE_PATH] = again["launches"]
        logits = again["logits"]
        want = {"flash_fwd": again["n_layers"], "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0}
        equal = torch.equal(first["logits"], logits)
        out["lineage"] = {"first_get_s": first_get_s, "rebuild_s": rebuild_s,
                          "runs": runs, "starts": starts, "lost": lost,
                          "bit_equal": equal,
                          "launches": [first["launches"], again["launches"]],
                          "shape": list(logits.shape),
                          "pids": [first["pid"], again["pid"]]}
        log(f"{LINEAGE_PATH}: (b) [{batch}, {cfg.max_seq_len}] tokens from a "
            f"CPU task, their last position's f32 logits "
            f"{list(logits.shape)} ({logits.numel() * 4 / 1e6:.2f} MB) from "
            f"a num_gpus=1 task ({again['device']}, CUDA_VISIBLE_DEVICES "
            f"{again['visible']!r}); both objects freed from the store and "
            f"the directory (gone: {lost}); rebuilt in {rebuild_s:.3f} s "
            f"beside the first get's {first_get_s:.3f} s; executions "
            f"{runs}, (task, pid, s after its get began) {starts}; launches "
            f"{first['launches']} then {again['launches']}; bit-equal: "
            f"{equal}")
        bad = []
        if not lost:
            bad.append("the objects were still in the store")
        if runs != {"tokens": 2, "logits": 2}:
            bad.append(f"executions {runs}, want each task twice")
        if first["launches"] != want or again["launches"] != want:
            bad.append(f"launches {first['launches']}, {again['launches']},"
                       f" want {want}")
        if not equal or logits.dtype != torch.float32 or list(
                logits.shape) != [batch, cfg.vocab_size]:
            bad.append(f"rebuilt logits {logits.dtype} "
                       f"{list(logits.shape)}, bit-equal {equal}")
        if not torch.isfinite(logits).all():
            bad.append("non-finite logits")
        if again["visible"] != "0":
            bad.append(f"CUDA_VISIBLE_DEVICES {again['visible']!r}")
        if bad:
            raise SmokeFailure(f"{LINEAGE_PATH}: (b) " + "; ".join(bad))
    except exceptions.RayTpuError as exc:
        raise SmokeFailure(f"phase 19: {type(exc).__name__}: {exc}") from exc
    finally:
        rt.shutdown()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def run(args) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from ray_tpu_torch import models, rl
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

    # phase 3: small models against the reference attention; moe_ffn
    model = model_check(torch, models)
    model["moe_ffn"] = moe_check(torch)
    torch.cuda.empty_cache()

    # phases 4-6: the train paths, each with the launch counts set to 0 just
    # before its timed steps and read just after; with --skip-main none runs
    # and no launch was counted (null)
    paths = {
        "gpt2_medium": (models.gpt2_medium(max_seq_len=1024,
                                           remat_policy="dots"), (12,)),
        "llama_1b": (models.llama_1b(remat_policy="dots"), LLAMA_BATCHES),
        "llama_1b_moe": (models.llama_1b(n_experts=4, moe_top_k=2,
                                         remat_policy="dots"), MOE_BATCHES),
    }
    by_path, main = {}, {}
    driver_params = {}   # phase 4's parameters after its steps, for phase 13
    for name, (cfg, batches) in paths.items():
        if args.skip_main:
            by_path[name] = {k: None for k in A.launches}
            continue
        by_path[name], main[name] = train_path(
            torch, A, models, smi, name, cfg, batches,
            profile_path=args.profile,
            params_out=driver_params if name == "gpt2_medium" else None)
        gc.collect()
        torch.cuda.empty_cache()

    # phase 7: the ring against full-sequence flash attention (also under
    # --skip-main)
    ring = ring_check(torch, A, by_path)

    # phase 8: llama_1b at seq 8192 through the sp-4 ring, then without a
    # mesh at the same batch, on the same weights and tokens
    long_cfg = models.llama_1b(max_seq_len=8192, remat_policy="dots")
    long_paths = ("llama_1b_s8192_ring_sp4", "llama_1b_s8192")
    if args.skip_main:
        by_path.update({n: {k: None for k in A.launches} for n in long_paths})
        log("train paths: skipped (--skip-main)")
    else:
        main["long_context"] = long_context(torch, A, models, smi, long_cfg,
                                            long_paths, by_path,
                                            args.profile)

    # phase 9: llama_1b through the process-mesh path (FSDP2, tp, the
    # global-norm clip) on a one-rank NCCL group, beside phase 5; phase 10:
    # the MoE model through it, beside phase 6; phase 11: llama_1b through
    # the GPipe schedule over 4 loopback stages, beside phase 5
    mesh_path = "llama_1b_fsdp_tp_mesh1"
    moe_path = "llama_1b_moe_mesh1"
    pp_path = "llama_1b_pp4_loopback"
    if args.skip_main:
        by_path.update({n: {k: None for k in A.launches}
                        for n in (mesh_path, moe_path, pp_path)})
    else:
        with one_rank_nccl(torch):
            main[mesh_path] = fsdp_tp_path(
                torch, A, models, smi, paths["llama_1b"][0],
                main["llama_1b"], mesh_path, by_path, args.profile)
            gc.collect()
            torch.cuda.empty_cache()
            main[moe_path] = moe_mesh_path(
                torch, A, models, smi, paths["llama_1b_moe"][0],
                main["llama_1b_moe"], moe_path, by_path, args.profile)
            gc.collect()
            torch.cuda.empty_cache()
        main[pp_path] = pipeline_path(
            torch, A, models, smi,
            models.llama_1b(remat_policy="dots", pp_microbatches=4),
            main["llama_1b"], pp_path, by_path, args.profile)
        gc.collect()
        torch.cuda.empty_cache()

    # phase 12: the RL learners on the card against the CPU, then PPO on
    # CartPole with the learner on the card (also under --skip-main); the
    # path launches no flash kernel, and its counts say so
    learners = rl_learner_check(torch, rl, smi)
    rl_out = {"learners": learners,
              "ppo_loop": rl_ppo_loop(torch, rl, smi, by_path,
                                      "rl_ppo_cartpole", learners["ppo"])}

    # phase 13: the port's runtime on the card; the main path inside a GPU
    # actor, beside phase 4 (its steps skipped under --skip-main)
    gc.collect()
    torch.cuda.empty_cache()
    runtime = runtime_phase(torch, smi, by_path, main.get("gpt2_medium"),
                            driver_params or None, args.skip_main,
                            args.profile)

    # phase 14: the gang trainer on the card, beside phase 4 (skipped under
    # --skip-main)
    gc.collect()
    torch.cuda.empty_cache()
    if args.skip_main:
        by_path[GANG_PATH] = {k: None for k in A.launches}
    else:
        main[GANG_PATH] = gang_phase(torch, smi, by_path,
                                     main["gpt2_medium"], args.profile)

    # phase 15: ingest on the card, in process and through the gang, beside
    # phases 4 and 14 (under --skip-main only the batches' bit equality)
    gc.collect()
    torch.cuda.empty_cache()
    main[INGEST_PATH] = ingest_phase(
        torch, A, models, smi, by_path, main.get("gpt2_medium"),
        main.get(GANG_PATH), args.skip_main, args.profile)

    # phase 16: the host collectives with a CUDA rank and a MeshGroup host on
    # the card (at 64 MB under --skip-main), then Tune trials training on the
    # card with a user histogram (skipped under --skip-main)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    comm = comm_phase(torch, models, smi, args.skip_main, runtime)
    if args.skip_main:
        by_path[TUNE_PATH] = {k: None for k in A.launches}
    else:
        main[TUNE_PATH] = tune_phase(torch, smi, by_path,
                                     main["gpt2_medium"], main[GANG_PATH])
    phase16_s = time.perf_counter() - t0
    log(f"phase 16: {phase16_s:.1f} s")

    # phase 17: gpt2_medium served from a GPU replica through the flash
    # forward kernel, then a workflow step and an autoscaled node on the
    # card ((a) only under --skip-main)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serving = serve_phase(torch, A, models, smi, by_path, args.skip_main,
                          args.profile)
    phase17_s = time.perf_counter() - t0
    log(f"phase 17: {phase17_s:.1f} s")

    # phase 18: a process-isolated cluster with a GPU node process; a job
    # submitted to the head trains phase 4's path there (a 2-layer cut
    # under --skip-main), watched through the dashboard, the CLI and
    # nvidia-smi, then the node is removed
    gc.collect()
    torch.cuda.empty_cache()
    cluster_job = job_phase(torch, smi, by_path, main.get("gpt2_medium"),
                            args.skip_main)
    log(f"phase 18: {cluster_job['phase_s']:.1f} s")

    # phase 19: a streaming num_gpus=1 task trains phase 4's path (a 2-layer
    # cut under --skip-main); a closed stream frees the slot; a lost result
    # of the card is rebuilt from lineage
    gc.collect()
    torch.cuda.empty_cache()
    task_kinds = task_kinds_phase(torch, smi, by_path, main.get("gpt2_medium"),
                                  args.skip_main)
    log(f"phase 19: {task_kinds['phase_s']:.1f} s")

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name],
                "launches": by_path["gpt2_medium"][name],
                "launches_by_path": {p: c[name] for p, c in by_path.items()},
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
                       "model_check": model, "ring": ring,
                       "main": main, "rl": rl_out, "runtime": runtime,
                       "comm": comm, "phase16_s": phase16_s,
                       "serve": serving, "phase17_s": phase17_s,
                       "cluster_job": cluster_job,
                       "task_kinds": task_kinds},
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
                    help="after each train path, profile two more steps and "
                    "write torch.profiler's table to PATH with the path's "
                    "name before the suffix")
    ap.add_argument("--skip-main", action="store_true",
                    help="skip the train paths, phases 4-6, 8-11, 14, "
                    "16(b)-(c) and 17(b)-(f) and the steps of phases 13 and "
                    "15; phases 18 and 19 run a 2-layer cut (debugging)")
    args = ap.parse_args()
    try:
        return run(args)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
