"""Device meshes with named parallelism axes.

Counterpart of ``ray_tpu/parallel/mesh.py``: the same axis names, order and
`MeshSpec`. Where JAX builds one `jax.sharding.Mesh` over devices, a rank
here holds its coordinate on each axis and a process group per axis,
from `torch.distributed.device_mesh.init_device_mesh` over the default
process group (`build_mesh`). `loopback_mesh` is the one-process form whose
only axis larger than 1 is ``sp`` or ``pp``: it holds every sp shard (or
every pipeline stage) in this process, as JAX's virtual-device meshes hold
every device in one process, and its sp "group" is an in-process ring
(`ray_tpu_torch.ops.ring_attention.LoopbackRing`), its pp "group" an
in-process pipe (`ray_tpu_torch.parallel.pipeline.LoopbackPipe`).

Axes (rank-major order, innermost last, so tp neighbours are adjacent
ranks, then sp neighbours):

  ``dp``   data parallel (FSDP2 replicates over it: HSDP when fsdp > 1)
  ``fsdp`` sharded data parallel (FSDP2 shards parameters, gradients and
           optimizer state over it)
  ``tp``   tensor parallel (Megatron-style: heads, mlp and vocab split)
  ``sp``   sequence parallel (ring attention)
  ``pp``   pipeline parallel (GPipe over the stages, `parallel/pipeline.py`)
  ``ep``   expert parallel (each rank holds E/ep experts; tokens are
           replicated over ep, `models/moe.py`)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

AXIS_PP = "pp"
AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_EP = "ep"
AXIS_SP = "sp"
AXIS_TP = "tp"

# Innermost-last ordering: tp and sp get neighbouring ranks.
AXIS_ORDER: Tuple[str, ...] = (AXIS_PP, AXIS_DP, AXIS_FSDP, AXIS_EP,
                               AXIS_SP, AXIS_TP)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape. ``-1`` on at most one axis means "absorb the
    remaining devices" (like a reshape wildcard)."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = {f.name: getattr(self, f.name)
                 for f in dataclasses.fields(self)}
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wild}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh spec {sizes} covers {fixed} devices, have "
                f"{n_devices}")
        return MeshSpec(**sizes)

    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, name) for name in AXIS_ORDER)

    @property
    def total(self) -> int:
        if any(s == -1 for s in self.axis_sizes()):
            raise ValueError(
                "MeshSpec has an unresolved -1 axis; call resolve(n) first")
        return math.prod(self.axis_sizes())


def mesh_shape_for(n_devices: int,
                   tp: int = 1,
                   sp: int = 1,
                   pp: int = 1,
                   ep: int = 1,
                   fsdp: int = 1) -> MeshSpec:
    """Convenience: everything not given goes to dp."""
    return MeshSpec(dp=-1, fsdp=fsdp, tp=tp, sp=sp, pp=pp,
                    ep=ep).resolve(n_devices)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A resolved `MeshSpec` as one process sees it.

    `coords` is this rank's coordinate on each axis; `groups` maps an axis
    to its process group (or, for a loopback mesh, to the in-process ring
    of its sp shards). A loopback mesh holds every shard of every axis
    here, so it slices nothing. A process mesh also carries `data_mesh`,
    the ("dp", "fsdp") `DeviceMesh` that FSDP2 shards over, and
    `batch_group`, the group of the ranks that hold different parts of the
    batch and the same parameter shards: dp x fsdp x sp (never tp, ep or
    pp). Its group ranks follow the coordinates: (dp·fsdp_size + fsdp)·sp_size
    + sp (`batch_index`), the order in which its all-gathers stack the parts
    of the batch."""

    spec: MeshSpec
    coords: Dict[str, int]
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    loopback: bool = False
    data_mesh: Any = None
    batch_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in AXIS_ORDER (as `jax.sharding.Mesh.shape`)."""
        return dict(zip(AXIS_ORDER, self.spec.axis_sizes()))

    def group(self, axis: str):
        if axis not in self.groups:
            raise ValueError(f"mesh has no group for axis {axis!r}")
        return self.groups[axis]

    @property
    def batch_index(self) -> int:
        """This rank's index in the batch group: its row block over (dp,
        fsdp), then its column block over sp."""
        shape, coords = self.shape, self.coords
        return ((coords[AXIS_DP] * shape[AXIS_FSDP] + coords[AXIS_FSDP])
                * shape[AXIS_SP] + coords[AXIS_SP])

    def local_range(self, axes: Sequence[str], length: int
                    ) -> Tuple[int, int]:
        """[start, stop) of this process's part of a dimension of `length`
        split over `axes` (row-major, as a PartitionSpec entry splits it)."""
        n, index = 1, 0
        for axis in axes:
            n *= self.shape[axis]
            index = index * self.shape[axis] + self.coords[axis]
        if length % n:
            raise ValueError(f"dimension of {length} does not split over "
                             f"mesh axes {tuple(axes)} of {n}")
        if self.loopback:
            return 0, length
        part = length // n
        return index * part, (index + 1) * part


def build_mesh(spec: Optional[MeshSpec] = None,
               device_type: str = "cuda") -> Mesh:
    """This rank's `Mesh` over the default process group (which the caller
    has initialised): `init_device_mesh` with the canonical axis names, one
    process group per axis, the ("dp", "fsdp") sub-mesh and the batch group
    (every rank calls this, so every rank creates every group)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    spec = (spec or MeshSpec()).resolve(dist.get_world_size())
    device_mesh = init_device_mesh(device_type, spec.axis_sizes(),
                                   mesh_dim_names=AXIS_ORDER)
    coords = dict(zip(AXIS_ORDER, device_mesh.get_coordinate()))
    groups = {axis: device_mesh.get_group(axis) for axis in AXIS_ORDER}
    # ranks by coordinate, the batch axes last: one group per (pp, ep, tp)
    batch_axes = (AXIS_DP, AXIS_FSDP, AXIS_SP)
    order = ([AXIS_ORDER.index(a) for a in AXIS_ORDER
              if a not in batch_axes]
             + [AXIS_ORDER.index(a) for a in batch_axes])
    n_batch = math.prod(getattr(spec, a) for a in batch_axes)
    ranks = device_mesh.mesh.permute(order).reshape(-1, n_batch).tolist()
    batch_group, _ = dist.new_subgroups_by_enumeration(ranks)
    mesh = Mesh(spec, coords, groups,
                data_mesh=device_mesh[AXIS_DP, AXIS_FSDP],
                batch_group=batch_group)
    if dist.get_rank(batch_group) != mesh.batch_index:
        raise RuntimeError(
            f"batch group rank {dist.get_rank(batch_group)} is not the "
            f"coordinates' index {mesh.batch_index}")
    return mesh


def loopback_mesh(spec: MeshSpec) -> Mesh:
    """A one-process mesh whose only axis larger than 1 is sp or pp: every
    sp shard (every stage) lives in this process, and the sp group is a
    `LoopbackRing` (the pp group a `LoopbackPipe`)."""
    from ..ops.ring_attention import LoopbackRing
    from .pipeline import LoopbackPipe

    others = {a: s for a, s in zip(AXIS_ORDER, spec.axis_sizes())
              if s not in (1, -1)}
    if len(others) > 1 or set(others) - {AXIS_SP, AXIS_PP}:
        raise ValueError(f"a loopback mesh holds sp alone or pp alone; got "
                         f"{others}")
    spec = spec.resolve(math.prod(others.values()))
    groups = {AXIS_SP: LoopbackRing(spec.sp)}
    if spec.pp > 1:
        groups = {AXIS_PP: LoopbackPipe(spec.pp)}
    return Mesh(spec, {a: 0 for a in AXIS_ORDER}, groups, loopback=True)
