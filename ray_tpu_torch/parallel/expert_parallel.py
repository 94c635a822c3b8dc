"""Collectives of the mixture-of-experts FFN on a mesh.

JAX's GSPMD layout of `moe_ffn` (``ray_tpu/parallel/sharding.py``): the
tokens are split over the batch axes (dp, fsdp and sp) and replicated over
ep; the expert axis of the weights is split over ep, their mlp axis over
tp. So each ep rank runs its own experts for every token of its batch
group, the expert buffers collect tokens from every batch rank, and the
combine contracts the ep-split expert axis: a sum over ep, not an
all-to-all. The port places those collectives by hand:

* `copy_to_ep` / `reduce_from_ep`: Megatron's pair over ep, on the inputs
  of the expert part (identity forward, gradient summed over ep: each ep
  rank's part of the gradient comes from its own experts) and on its output
  (the partial combine over this rank's experts, summed);
* `sum_over_batch`: the expert buffers summed over the batch group, whose
  backward is also a sum over the batch group: every batch rank reads the
  summed buffer, so the gradient of each rank's part is the sum of every
  rank's gradient of the buffer;
* `gather_over_batch`: one tensor from every rank of the batch group,
  stacked in batch-group rank order, without a gradient (the routing
  choices, for the global slot order).
"""

from __future__ import annotations

import torch

from .tensor_parallel import _all_reduce, _CopyTo, _ReduceFrom


class _SumOverBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def copy_to_ep(x: torch.Tensor, group) -> torch.Tensor:
    """`x` unchanged; its gradient summed over the ep group."""
    return _CopyTo.apply(x, group)


def reduce_from_ep(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ep group; the gradient passes unchanged."""
    return _ReduceFrom.apply(x, group)


def sum_over_batch(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the batch group; its gradient summed over the
    batch group too."""
    return _SumOverBatch.apply(x, group)


@torch.no_grad()
def gather_over_batch(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: `x` of every rank of the batch group, in group rank
    order (`Mesh.batch_index`); no gradient."""
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)
