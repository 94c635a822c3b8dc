"""Training step: optimizer, TrainState, train/eval step, on one device or
over a dp x sp mesh.

Counterpart of ``ray_tpu/models/training.py``. The optimizer is written out
by hand with optax's semantics for
``chain(clip_by_global_norm(c), adamw(schedule, b1, b2, eps=1e-8, wd))``:

* clipping scales by ``c / g_norm`` only when ``g_norm >= c`` (no epsilon,
  unlike ``torch.nn.utils.clip_grad_norm_``);
* Adam's bias-corrected moments, ``eps`` outside the square root;
* decoupled weight decay on every parameter (norms and biases included),
  added to the Adam update and scaled by the learning rate with it;
* the warmup-cosine schedule counts warmup inside the decay steps and is
  read at the update count before it is incremented, so the first update
  has lr = 0.

The step updates parameters and moments in place, and clips the gradients
in their own buffers (the JAX step donates its state buffers, and XLA fuses
the update, for the same reason: one copy of the state in memory).

On a mesh (`ray_tpu_torch.parallel`) every rank holds the whole model and
takes the global batch, of which the model's loss reads this rank's rows
and sequence columns (`shard_batch`); the step sums the gradients over the
dp x sp ranks in one all-reduce before the update, which then sees the
global gradients (and takes their global norm) exactly as on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..parallel.mesh import Mesh
from .gpt import GPT, resolve_device

Params = Dict[str, torch.Tensor]


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
                state: Dict) -> torch.Tensor:
        """One clipped AdamW update, in place. Returns the global norm of
        the unclipped grads (a 0-d tensor; no host sync). `grads` are
        clipped in place, so their values are spent; the rest of the update
        runs in chunks of at most `_CHUNK_NUMEL` elements (or one larger
        tensor), which bounds its temporaries to two such chunks."""
        names = list(params)
        p = [params[n] for n in names]
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        g_norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
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
            upd = torch._foreach_div(mu[lo:hi], 1 - self.b1 ** count)
            denom = torch._foreach_div(nu[lo:hi], 1 - self.b2 ** count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_div_(upd, denom)                # mu_hat / denom
            if self.weight_decay:
                torch._foreach_add_(upd, p[lo:hi], alpha=self.weight_decay)
            if lr:
                torch._foreach_add_(p[lo:hi], upd, alpha=-lr)
        state["count"] = count
        return g_norm


# Elements per chunk of `Optimizer.update_` (2**26: 256 MiB of f32)
_CHUNK_NUMEL = 1 << 26


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
    params: Params          # the model's own parameters (updated in place)
    opt_state: Dict


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
    every rank builds the same weights from the same seed."""
    device = resolve_device(device)
    _check_mesh(model, mesh)
    model.to(device)
    params = dict(model.named_parameters())
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(params))


def _all_reduce_grads(grads: List[torch.Tensor]) -> None:
    """Sum `grads` over every rank, in place, as one all-reduce of one
    flat buffer."""
    import torch.distributed as dist

    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
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

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        for p in state.params.values():
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        grads = [p.grad for p in state.params.values()]
        with torch.no_grad():
            if model.sums_over_ranks:
                _all_reduce_grads(grads)
            g_norm = optimizer.update_(state.params, grads, state.opt_state)
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
