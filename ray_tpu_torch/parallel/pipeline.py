"""GPipe over the pp mesh axis.

Counterpart of ``ray_tpu/models/gpt.py:GPT._pipeline_blocks``. The layers
split into P stages of L/P each; the batch into M microbatches. The forward
fills and drains the pipe in M + P - 1 ticks: at tick t stage s runs
microbatch t - s and hands its output to stage s + 1. Stage 0 embeds its
microbatch first; the last stage ends with the head (and the loss). The
backward runs the microbatches in reverse, in as many ticks: each stage
calls ``torch.autograd.backward`` on its output with the gradient received
from the next stage (the last on its loss), and hands its input's gradient
to the previous one. Every microbatch's activations live until its
backward, as in GPipe.

Where JAX carries a [P, mb, S, D] buffer through a scan and lets
``jnp.roll`` over the stage-sharded axis become a collective-permute, the
port runs the same schedule with explicit transports, as the ring does:

* `ProcessGroupPipe`: this rank's stage in a pp group; ``batch_isend_irecv``
  of [mb, S_local, D] to the next stage (forward) or the previous one
  (backward) each tick, over gloo (CPU tensors) or NCCL (CUDA tensors);
* `LoopbackPipe`: every stage in this process; a tick hands each stage's
  tensor to its neighbour without a copy.

Both run the same `forward` and `backward` below.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

Like = Tuple[Tuple[int, ...], torch.dtype, torch.device]


class LoopbackPipe:
    """Every stage of a pipe in this process."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"pipe size must be >= 1, got {size}")
        self.size = size
        self.stages = tuple(range(size))

    def shift(self, sent: Dict[int, torch.Tensor], expect: Sequence[int],
              like: Like, step: int) -> Dict[int, torch.Tensor]:
        """Stage s's tensor of `sent` to stage s + step (step ±1)."""
        got = {s + step: t for s, t in sent.items()}
        if sorted(got) != sorted(expect):
            raise RuntimeError(f"pipe tick sent to stages {sorted(got)}, "
                               f"expected {sorted(expect)}")
        return got


class ProcessGroupPipe:
    """This rank's stage in a pipe over a `torch.distributed` group: group
    rank s is stage s."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group if group is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.group)
        rank = dist.get_rank(self.group)
        self.stages = (rank,)
        # a P2POp names its peer by its global rank
        self._peer = {step: dist.get_global_rank(self.group, rank + step)
                      for step in (-1, 1) if 0 <= rank + step < self.size}
        self._gloo = dist.get_backend(self.group) == "gloo"

    def global_rank(self, stage: int) -> int:
        import torch.distributed as dist

        return dist.get_global_rank(self.group, stage)

    def shift(self, sent: Dict[int, torch.Tensor], expect: Sequence[int],
              like: Like, step: int) -> Dict[int, torch.Tensor]:
        """Send this stage's tensor of `sent` to stage s + step and receive
        one of shape, dtype and device `like` from stage s - step for each
        stage of `expect` (this one, or none)."""
        import torch.distributed as dist

        if self._gloo:
            bad = sorted({str(t.device) for t in sent.values()
                          if t.device.type != "cpu"})
            if bad or like[2].type != "cpu":
                raise RuntimeError(
                    f"a gloo pipe carries CPU tensors only, got "
                    f"{bad or [str(like[2])]}; use an NCCL group for CUDA "
                    "tensors")
        ops, got = [], {}
        for t in sent.values():
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  self._peer[step], self.group))
        for s in expect:
            got[s] = torch.empty(like[0], dtype=like[1], device=like[2])
            ops.append(dist.P2POp(dist.irecv, got[s], self._peer[-step],
                                  self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return got


def pipe_transport(group):
    """The pipe over `group`: a `LoopbackPipe` is its own transport, a
    process group gets a `ProcessGroupPipe`."""
    if isinstance(group, (LoopbackPipe, ProcessGroupPipe)):
        return group
    return ProcessGroupPipe(group)


def forward(pipe, n_micro: int, first: Callable, stage: Callable,
            last: Callable, like: Like) -> Dict[str, Dict]:
    """The fill-and-drain forward over `pipe`'s stages held here.

    first(m) -> stage 0's input of microbatch m; stage(s, x, m) -> stage s's
    output; last(y, m) -> what the last stage keeps of its output (the
    loss, or the logits). Returns {"inputs": {(s, m): the input leaf of
    stage s > 0}, "outputs": {(s, m): stage s's output, last's on the last
    stage}}, plain containers (FSDP2 hooks the tensors a module returns).
    Inputs require grad when grad is enabled."""
    P, M = pipe.size, n_micro
    grad = torch.is_grad_enabled()
    inputs, outputs, received = {}, {}, {}
    for t in range(M + P - 1):
        sent = {}
        for s in pipe.stages:
            m = t - s
            if not 0 <= m < M:
                continue
            if s == 0:
                x = first(m)
            else:
                x = received.pop(s).detach().requires_grad_(grad)
                inputs[s, m] = x
            y = stage(s, x, m)
            if s == P - 1:
                outputs[s, m] = last(y, m)
            else:
                outputs[s, m] = y
                sent[s] = y.detach()
        expect = [s for s in pipe.stages if s > 0 and 0 <= t + 1 - s < M]
        received = pipe.shift(sent, expect, like, 1)
    return {"inputs": inputs, "outputs": outputs}


def backward(pipe, n_micro: int, run: Dict[str, Dict], like: Like) -> None:
    """The backward of `forward`'s `run`, microbatches in reverse: the last
    stage backpropagates its scalar output (the loss) of each microbatch,
    every other stage its output with the gradient from the next stage;
    stage s > 0 hands its input's gradient to stage s - 1. The parameters'
    gradients accumulate over the microbatches. `run` is spent."""
    P, M = pipe.size, n_micro
    inputs, outputs = run["inputs"], run["outputs"]
    received = {}

    def micro(t, s):
        return M - 1 - t + (P - 1 - s)

    for t in range(M + P - 1):
        sent = {}
        for s in pipe.stages:
            m = micro(t, s)
            if not 0 <= m < M:
                continue
            if s == P - 1:
                torch.autograd.backward(outputs.pop((s, m)))
            else:
                torch.autograd.backward(outputs.pop((s, m)), received.pop(s))
            if s > 0:
                sent[s] = inputs.pop((s, m)).grad
        expect = [s for s in pipe.stages
                  if s < P - 1 and 0 <= micro(t + 1, s) < M]
        received = pipe.shift(sent, expect, like, -1)
