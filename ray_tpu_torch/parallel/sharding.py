"""Logical-axis sharding rules: parameter shards and this rank's batch.

Counterpart of ``ray_tpu/parallel/sharding.py``: model code names array
dimensions with *logical* axes ("embed", "heads", "act_batch", ...), and a
`ShardingRules` table maps each to mesh axes. Where JAX places a global
array's shards on devices (``NamedSharding``), a rank here holds its own
local slice of each tensor: `logical_sharding` is that slice, `shard_params`
takes it from full tensors and `gather_params` puts full tensors back
together over the mesh's process groups. `shard_batch` is this rank's part
of a global batch. `with_logical_constraint` checks a local shape against
the rules (JAX's is a layout hint to XLA).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from .mesh import (AXIS_DP, AXIS_EP, AXIS_FSDP, AXIS_PP, AXIS_SP, AXIS_TP,
                   Mesh)

LogicalAxis = Optional[str]
MeshAxes = Union[None, str, Tuple[str, ...]]


class ShardingRules(dict):
    """Mapping logical axis name → mesh axis (or tuple of mesh axes)."""

    def mesh_axes(self, logical: LogicalAxis) -> MeshAxes:
        if logical is None:
            return None
        return self.get(logical)

    def spec(self, *logical_axes: LogicalAxis) -> Tuple[MeshAxes, ...]:
        """The mesh axes of each logical axis, as the entries of a JAX
        PartitionSpec."""
        return tuple(self.mesh_axes(a) for a in logical_axes)

    def only(self, *mesh_axes: str) -> "ShardingRules":
        """These rules with every mesh axis but `mesh_axes` dropped (the
        model slices its parameters over tp itself and leaves the fsdp axis
        to FSDP2)."""
        out = ShardingRules()
        for logical, entry in self.items():
            kept = tuple(a for a in _axes(entry) if a in mesh_axes)
            out[logical] = (None if not kept else
                            kept[0] if len(kept) == 1 else kept)
        return out


# The JAX package's table, key for key (ray_tpu/parallel/sharding.py).
DEFAULT_RULES = ShardingRules({
    # activations
    "act_batch": (AXIS_DP, AXIS_FSDP),
    "act_seq": AXIS_SP,
    "act_embed": None,
    "act_heads": AXIS_TP,
    "act_kv_heads": AXIS_TP,
    "act_mlp": AXIS_TP,
    "act_vocab": AXIS_TP,
    "head_dim": None,
    # weights
    "embed": AXIS_FSDP,
    "heads": AXIS_TP,
    "kv_heads": AXIS_TP,
    "mlp": AXIS_TP,
    "vocab": AXIS_TP,
    "expert": AXIS_EP,
    "layers": None,
    "stage": AXIS_PP,
})


def _axes(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_sharding(mesh: Mesh, rules: ShardingRules,
                     logical: Sequence[LogicalAxis],
                     shape: Sequence[int]) -> Tuple[slice, ...]:
    """This rank's part of a tensor of global `shape` whose dimensions
    carry the `logical` axes: one slice per dimension, each split over its
    mesh axes in the order a PartitionSpec entry splits them (the index
    JAX's sharding gives the device at this rank's coordinates)."""
    if len(logical) != len(shape):
        raise ValueError(f"logical axes {tuple(logical)} do not match a "
                         f"tensor of shape {tuple(shape)}")
    return tuple(slice(*mesh.local_range(_axes(rules.mesh_axes(a)), n))
                 for a, n in zip(logical, shape))


def shard_params(params: Mapping[str, torch.Tensor],
                 logical: Mapping[str, Tuple[LogicalAxis, ...]], mesh: Mesh,
                 rules: Optional[ShardingRules] = None
                 ) -> Dict[str, torch.Tensor]:
    """Full tensors -> this rank's slices of them (views), by the logical
    axes of each (a model's ``param_logical_axes()``)."""
    rules = rules if rules is not None else DEFAULT_RULES
    return {n: t[logical_sharding(mesh, rules, logical[n], t.shape)]
            for n, t in params.items()}


def gather_params(params: Mapping[str, torch.Tensor],
                  logical: Mapping[str, Tuple[LogicalAxis, ...]], mesh: Mesh,
                  rules: Optional[ShardingRules] = None
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of `shard_params` on a process mesh: each sharded
    dimension all-gathered over the groups of its mesh axes, innermost axis
    first. Every rank of the mesh calls it with the same names in the same
    order; every rank gets the full tensors."""
    import torch.distributed as dist

    rules = rules if rules is not None else DEFAULT_RULES
    out = {}
    for name, t in params.items():
        for dim, axis_name in enumerate(logical[name]):
            for axis in reversed(_axes(rules.mesh_axes(axis_name))):
                if mesh.loopback or mesh.shape[axis] == 1:
                    continue
                t = t.contiguous()
                parts = [torch.empty_like(t)
                         for _ in range(mesh.shape[axis])]
                dist.all_gather(parts, t, group=mesh.group(axis))
                t = torch.cat(parts, dim=dim)
        out[name] = t
    return out


def with_logical_constraint(x: torch.Tensor, *logical_axes: LogicalAxis,
                            global_shape: Sequence[int],
                            rules: Optional[ShardingRules] = None,
                            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """`x`, after checking that it is this rank's part of a tensor of
    `global_shape` with `logical_axes`: its shape must be what the rules
    give on `mesh`. JAX's counterpart asks XLA for that layout; here each
    rank already holds a local tensor, so the port can only check it. No
    mesh, no check."""
    if mesh is None:
        return x
    rules = rules if rules is not None else DEFAULT_RULES
    want = tuple(s.stop - s.start for s in logical_sharding(
        mesh, rules, logical_axes, global_shape))
    if tuple(x.shape) != want:
        raise ValueError(
            f"local shape {tuple(x.shape)} is not this rank's part "
            f"{want} of {tuple(global_shape)} over {logical_axes} on mesh "
            f"{mesh.shape}")
    return x


def shard_batch(mesh: Optional[Mesh], batch: Dict[str, torch.Tensor],
                rules: Optional[ShardingRules] = None
                ) -> Dict[str, torch.Tensor]:
    """This rank's part of the global batch {"tokens": [B, S], optional
    "loss_mask": [B, S]}: its rows (``act_batch``) and columns
    (``act_seq``), with the next-token targets, the loss mask and the
    global positions. Targets and mask come from the full rows before the
    slice: a shard's last position takes its target from the next shard,
    and only the row's final position is masked. With no mesh (or a
    loopback mesh) the part is the whole batch."""
    rules = rules if rules is not None else DEFAULT_RULES
    tokens = batch["tokens"]
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                        dim=1)
    mask = torch.ones(tokens.shape, device=tokens.device)
    mask[:, -1] = 0.0
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"].float()
    positions = torch.arange(tokens.shape[1], device=tokens.device
                             ).expand(tokens.shape)
    out = {"tokens": tokens, "targets": targets, "loss_mask": mask,
           "positions": positions}
    if mesh is None:
        return out
    index = logical_sharding(mesh, rules, ("act_batch", "act_seq"),
                             tokens.shape)
    return {k: v[index] for k, v in out.items()}
