"""Logical-axis sharding rules, and this rank's shard of a batch.

Counterpart of ``ray_tpu/parallel/sharding.py``: model code names array
dimensions with *logical* axes ("act_batch", "act_seq", ...), and a
`ShardingRules` table maps each to mesh axes. This slice of the port keeps
every parameter whole on every rank, so only the activation rules are read:
the batch rows split over ``act_batch`` and the sequence over ``act_seq``
(`shard_batch`). Parameter sharding (``shard_params``) and
``with_logical_constraint`` come with the fsdp/tp slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

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
    r0, r1 = mesh.local_range(_axes(rules.mesh_axes("act_batch")),
                              tokens.shape[0])
    c0, c1 = mesh.local_range(_axes(rules.mesh_axes("act_seq")),
                              tokens.shape[1])
    return {k: v[r0:r1, c0:c1] for k, v in out.items()}
