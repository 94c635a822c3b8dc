"""Megatron-style tensor parallelism on plain local tensors.

Where JAX's GSPMD inserts the collectives that tp-sharded weights imply,
the port places them by hand around the model's local products, with the
pair of autograd functions of Megatron-LM: `copy_to_tp` (identity forward,
all-reduce of the gradient) before a column-parallel product and
`reduce_from_tp` (all-reduce forward, identity backward) after a
row-parallel one. `gather_from_tp` stacks one tensor from every tp rank
(the vocab-parallel loss combines its per-rank log-sum-exps with it).

Every tp rank holds the same replicated activations and the same loss, and
backpropagates its own copy: that is why the backward of the forward
all-reduce is the identity and the backward of the gather takes this
rank's slice. Each collective works on a copy: autograd may hand one
gradient tensor to several consumers, and the "dots" checkpoint policy
keeps a product's output, which an in-place all-reduce would change.
The pair's autograd functions take any group; `expert_parallel` uses them
over ep.
"""

from __future__ import annotations

import torch


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.rank = dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank], None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """`x` unchanged; its gradient summed over the tp group (the input of a
    column-parallel product, whose per-rank input gradients are partial)."""
    return _CopyTo.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the tp group (the partial outputs of a
    row-parallel product); the gradient passes through unchanged."""
    return _ReduceFrom.apply(x, group)


def gather_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """[tp, *x.shape]: `x` of every rank of the tp group, in group rank
    order; the gradient of this rank's entry flows back to `x`."""
    return _GatherFromTP.apply(x, group)
