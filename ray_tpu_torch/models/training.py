"""Training step: optimizer, TrainState, train/eval step, on one device or
over a mesh of any of the six axes.

Counterpart of ``ray_tpu/models/training.py``. The optimizer is written out
by hand with optax's semantics for
``chain(clip_by_global_norm(c), adamw(schedule, b1, b2, eps=1e-8, wd))``:

* clipping scales by ``c / g_norm`` only when ``g_norm >= c`` (no epsilon,
  unlike ``torch.nn.utils.clip_grad_norm_``);
* Adam's bias-corrected moments, ``eps`` outside the square root, the
  corrections ``1 - b**count`` computed in f32 as optax computes them;
* decoupled weight decay on every parameter (norms and biases included),
  added to the Adam update and scaled by the learning rate with it;
* the warmup-cosine schedule counts warmup inside the decay steps and is
  read at the update count before it is incremented, so the first update
  has lr = 0.

The step updates parameters and moments in place, and clips the gradients
in their own buffers (the JAX step donates its state buffers, and XLA fuses
the update, for the same reason: one copy of the state in memory).

On a process mesh (`ray_tpu_torch.parallel`) every rank takes the global
batch, of which the model's loss reads this rank's rows and sequence
columns (`shard_batch`), and holds its shards of the parameters (the
model's tp and ep slice, FSDP2's part of it over fsdp). FSDP2 sums the
gradients over dp and fsdp in its reduce-scatter; the step sums them over
sp in one all-reduce; tp- and ep-sharded gradients are never summed. With
pp > 1 the step runs the GPipe forward and backward (`GPT.pipeline_loss`)
in place of ``loss.backward()`` and sums the gradients of the parameters
every stage holds over pp in one more all-reduce. The update runs on the
local shards, and its clip takes the norm of the full logical gradient:
the squared norms of the shards summed over the axes each is cut over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..parallel.mesh import AXIS_PP, AXIS_SP, Mesh
from ..util import tracing
from .gpt import GPT, resolve_device

Params = Dict[str, torch.Tensor]
# (process group, parameter names) pairs: see `Optimizer.update_`
NormSums = Sequence[Tuple[Any, List[str]]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"

    def lr(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, peak, warmup,
        max(total, warmup + 1), 0.1 * peak) at `count`, or the constant."""
        peak = self.learning_rate
        if self.schedule != "cosine":
            return peak
        warmup = self.warmup_steps
        if count < warmup:
            return peak * count / warmup
        decay_steps = max(self.total_steps, warmup + 1) - warmup
        t = min(count - warmup, decay_steps)
        alpha = 0.1
        cosine = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
        return peak * ((1 - alpha) * cosine + alpha)

    def init(self, params: Params) -> Dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update_(self, params: Params, grads: List[torch.Tensor],
                state: Dict, norm_sums: NormSums = ()) -> torch.Tensor:
        """One clipped AdamW update, in place. Returns the global norm of
        the unclipped grads (a 0-d tensor; no host sync). `grads` are
        clipped in place, so their values are spent; the rest of the update
        runs in chunks of at most `_CHUNK_NUMEL` elements (or one larger
        tensor), which bounds its temporaries to two such chunks.

        Sharded state: `params` and `grads` are this rank's local shards,
        and `norm_sums` lists (process group, parameter names) pairs: the
        squared norms of those parameters' shards are summed over the group
        (`norm_sums_for`), so the norm is that of the full gradients, each
        replicated parameter counted once. Over groups of one rank the
        result equals the unsharded one bit for bit (sqrt(x * x) == x in
        binary floating point)."""
        names = list(params)
        p = [params[n] for n in names]
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        norms = torch.stack(torch._foreach_norm(grads))
        if norm_sums:
            norms = _global_norms(norms, names, norm_sums)
        g_norm = torch.linalg.vector_norm(norms)
        # optax: select(g_norm < c, g, g / g_norm * c)
        clip = torch.where(g_norm < self.grad_clip, torch.ones_like(g_norm),
                           self.grad_clip / g_norm)
        torch._foreach_mul_(grads, clip)
        count = state["count"] + 1
        torch._foreach_lerp_(mu, grads, 1 - self.b1)      # b1*mu + (1-b1)*g
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        lr = self.lr(state["count"])
        for lo, hi in _chunks(p):
            upd = torch._foreach_div(mu[lo:hi], _bias_correction(self.b1,
                                                                 count))
            denom = torch._foreach_div(nu[lo:hi], _bias_correction(self.b2,
                                                                   count))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_div_(upd, denom)                # mu_hat / denom
            if self.weight_decay:
                torch._foreach_add_(upd, p[lo:hi], alpha=self.weight_decay)
            if lr:
                torch._foreach_add_(p[lo:hi], upd, alpha=-lr)
        state["count"] = count
        return g_norm


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay**count``, computed in f32 as optax computes it
    (at decay 0.999 the f64 value lies 1.3e-5 from the f32 one)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


# Elements per chunk of `Optimizer.update_` (2**26: 256 MiB of f32)
_CHUNK_NUMEL = 1 << 26


def _global_norms(norms: torch.Tensor, names: List[str],
                  norm_sums: NormSums) -> torch.Tensor:
    """Per-parameter norms of the local shards -> the norms of the full
    parameters: each square summed over the groups `norm_sums` names it
    in."""
    import torch.distributed as dist

    sq = norms.square()
    index = {n: i for i, n in enumerate(names)}
    for group, members in norm_sums:
        idx = torch.tensor([index[n] for n in members], device=sq.device)
        part = sq.index_select(0, idx)
        dist.all_reduce(part, group=group)
        sq.index_copy_(0, idx, part)
    return sq.sqrt()


def norm_sums_for(mesh: Mesh, shard_axes: Dict[str, Tuple[str, ...]]
                  ) -> NormSums:
    """`Optimizer.update_`'s `norm_sums` for parameters whose local shards
    are cut over the mesh axes `shard_axes` gives each (a model's
    ``param_shard_axes()``): one (group, names) pair per axis."""
    axes = sorted({a for ax in shard_axes.values() for a in ax})
    return tuple((mesh.group(axis),
                  [n for n, ax in shard_axes.items() if axis in ax])
                 for axis in axes)


def _chunks(tensors: List[torch.Tensor]) -> List[Tuple[int, int]]:
    """[lo, hi) runs of consecutive `tensors` of at most `_CHUNK_NUMEL`
    elements together; a larger tensor is a run of its own."""
    runs, lo, size = [], 0, 0
    for i, t in enumerate(tensors):
        if i > lo and size + t.numel() > _CHUNK_NUMEL:
            runs.append((lo, i))
            lo, size = i, 0
        size += t.numel()
    if tensors:
        runs.append((lo, len(tensors)))
    return runs


def make_optimizer(learning_rate: float = 3e-4,
                   warmup_steps: int = 100,
                   total_steps: int = 10000,
                   weight_decay: float = 0.1,
                   b1: float = 0.9, b2: float = 0.95,
                   grad_clip: float = 1.0,
                   schedule: str = "cosine") -> Optimizer:
    return Optimizer(learning_rate=learning_rate, warmup_steps=warmup_steps,
                     total_steps=total_steps, weight_decay=weight_decay,
                     b1=b1, b2=b2, grad_clip=grad_clip, schedule=schedule)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params          # the model's own parameters (updated in place;
    #                         under FSDP2 DTensors, whose local shards the
    #                         update writes)
    opt_state: Dict         # mu and nu: local tensors like the shards


def _check_mesh(model: GPT, mesh: Optional[Mesh]) -> None:
    """A step runs on the model's own mesh; a `mesh` given to it must be
    that one."""
    if mesh is not None and mesh is not model.mesh:
        raise ValueError("the step's mesh must be the one the model was "
                         "built with (GPT(config, mesh=...))")


def init_train_state(model: GPT, optimizer: Optimizer, device="cuda",
                     mesh: Optional[Mesh] = None) -> TrainState:
    """Optimizer state for `model`'s parameters on `device` (the model is
    moved there). The parameters were initialised by `GPT(config, seed=)`,
    where the JAX version initialises them here from its key; on a mesh
    every rank builds the same weights from the same seed and keeps its
    shards, and mu and nu shard like them (JAX's `state_shardings`)."""
    device = resolve_device(device)
    _check_mesh(model, mesh)
    model.to(device)
    params = dict(model.named_parameters())
    with torch.no_grad():
        opt_state = optimizer.init(_locals(params))
    return TrainState(step=0, params=params, opt_state=opt_state)


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (FSDP2's parameters and gradients):
    under no_grad, the plain tensor over the DTensor's own storage. A
    plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _locals(params: Params) -> Params:
    return {n: _local(p) for n, p in params.items()}


def _all_reduce_grads(grads: List[torch.Tensor], group) -> None:
    """Sum `grads` over `group`, in place, as one all-reduce of one flat
    buffer."""
    import torch.distributed as dist

    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_train_step(model: GPT, optimizer: Optimizer, device="cuda",
                    mesh: Optional[Mesh] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """step(state, batch) -> (state, metrics): forward, backward and one
    optimizer update, in place. `batch` is the global batch; on a mesh the
    model takes this rank's part of it (`GPT.loss`). Metrics are 0-d
    tensors on the device, global over the mesh."""
    device = resolve_device(device)
    if model.device.type != device.type:
        raise ValueError(f"model is on {model.device}, step asked for {device}")
    _check_mesh(model, mesh)
    norm_sums, sp_group = (), None
    pipelined = model.pp_stages > 1
    pp_names = set(model.pp_replicated())
    if model.sums_over_ranks:
        norm_sums = norm_sums_for(model.mesh, model.param_shard_axes())
        if model.mesh.shape[AXIS_SP] > 1:
            sp_group = model.mesh.group(AXIS_SP)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        for p in state.params.values():
            p.grad = None
        if pipelined:
            with tracing.start_span("model::" + "pipeline"):
                _, metrics = model.pipeline_loss(batch, backward=True)
        else:
            with tracing.start_span("model::" + "forward"):
                loss, metrics = model.loss(batch)
            with tracing.start_span("model::" + "backward"):
                loss.backward()
        with torch.no_grad(), tracing.start_span("model::" + "update"):
            # a pipeline stage leaves no gradient on the parameters outside
            # its blocks that it does not use (the head's, off the last)
            grads = [_local(p.grad) if p.grad is not None
                     else torch.zeros_like(_local(p))
                     for p in state.params.values()]
            if sp_group is not None:
                _all_reduce_grads(grads, sp_group)
            if pp_names:
                _all_reduce_grads([g for n, g in zip(state.params, grads)
                                   if n in pp_names],
                                  model.mesh.group(AXIS_PP))
            g_norm = optimizer.update_(_locals(state.params), grads,
                                       state.opt_state, norm_sums)
        for p in state.params.values():
            p.grad = None
        metrics = dict(metrics)
        metrics["grad_norm"] = g_norm
        state.step += 1
        return state, metrics

    return train_step


def eval_step_fn(model: GPT, device="cuda", mesh: Optional[Mesh] = None):
    """eval_step(batch) -> metrics, without gradients (the parameters are
    the model's own, where the JAX version takes them as an argument).
    `batch` is the global batch, as for the train step."""
    resolve_device(device)
    _check_mesh(model, mesh)

    @torch.no_grad()
    def eval_step(batch):
        _, metrics = model.loss(batch)
        return metrics

    return eval_step


def flops_per_token(config) -> float:
    """~6 * n_params non-embedding FLOPs/token (fwd+bwd), attention extra."""
    n = config.n_params - config.vocab_size * config.d_model * (
        1 if config.tie_embeddings else 2)
    attn_extra = 12 * config.n_layers * config.d_model * config.max_seq_len
    # lm head matmul counts (it's a real matmul): 6 * d * V
    head = 6 * config.d_model * config.vocab_size
    return 6.0 * n + attn_extra + head
