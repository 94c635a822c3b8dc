"""MeshGroup — the SPMD-vs-actor bridge (SURVEY §7 "hard parts"); a copy
of ``ray_tpu/comm/device_mesh.py`` whose ``build_local_mesh`` builds the
port's ``Mesh`` over a one-rank ``torch.distributed`` group of the actor's
own process.

On TPU, ONE jitted program owns all chips of a slice, but placement/
lifecycle is per *host* (4 chips per host). The reference has no
equivalent (its unit is one process per GPU with NCCL groups); here a
``MeshGroup`` is a placement-group gang of host actors driven in
lockstep: every ``run()`` invokes the same method on every host actor
concurrently, which is exactly the multi-controller JAX model
(`jax.distributed` — every host runs the same program, XLA runs the
collectives over ICI/DCN).

On a single-host dev box (or CPU tests) each actor simply owns the local
devices; the lockstep structure is identical, so code written against
MeshGroup moves to a real pod unchanged.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

from .. import get
from .collective import CollectiveActorMixin
from ..util.placement_group import (PlacementGroup, placement_group,
                                    remove_placement_group)
from ..util.scheduling_strategies import PlacementGroupSchedulingStrategy


class SPMDWorkerBase(CollectiveActorMixin):
    """Base for user host-actors in a MeshGroup.

    Subclasses get `self.mesh_rank` / `self.mesh_world` and can build a
    local port `Mesh` via `build_local_mesh()`. When the group
    was created with ``collective_group=...`` the host actors also form
    a host-level collective group (peer-to-peer ring/tree schedules over
    the node plane — see ``comm/collective.py``) and the ``mesh_*``
    helpers below run over it: host-side gradient/metric sync for the
    DCN axis, complementing the ICI collectives XLA runs inside jitted
    programs.
    """

    mesh_coll_group: Optional[str] = None

    def _rtpu_setup_mesh(self, rank: int, world: int,
                         coll_group: Optional[str] = None) -> None:
        self.mesh_rank = rank
        self.mesh_world = world
        self.mesh_coll_group = coll_group
        if coll_group is not None:
            self._rtpu_init_collective(world, rank, coll_group)

    def _mesh_group_name(self) -> str:
        if self.mesh_coll_group is None:
            raise RuntimeError(
                "this MeshGroup was created without collective_group=; "
                "host-level mesh_* collectives are not wired")
        return self.mesh_coll_group

    def mesh_allreduce(self, tensor, op: str = "sum"):
        from . import collective as col
        return col.allreduce(tensor, group_name=self._mesh_group_name(),
                             op=op)

    def mesh_broadcast(self, tensor, src_rank: int = 0):
        from . import collective as col
        return col.broadcast(tensor, src_rank=src_rank,
                             group_name=self._mesh_group_name())

    def mesh_reducescatter(self, tensor, op: str = "sum"):
        """Reduce across hosts, keep this host's 1/world slice (the
        DCN half of a cross-slice gradient shard: each host feeds its
        slice of the reduced update to its own chips)."""
        from . import collective as col
        return col.reducescatter(tensor, op=op,
                                 group_name=self._mesh_group_name())

    def mesh_allgather(self, tensor):
        """Gather every host's array (rank order) over the host plane."""
        from . import collective as col
        return col.allgather(tensor, group_name=self._mesh_group_name())

    def mesh_barrier(self) -> None:
        from . import collective as col
        col.barrier(group_name=self._mesh_group_name())

    def build_local_mesh(self, spec=None):
        """The port's `Mesh` over this actor's own devices, as JAX's is a
        mesh over the process's local devices with no rendezvous: the
        default process group is a one-rank group of this process (NCCL
        on the actor's card when it holds a GPU slot, gloo without one)
        through a private in-memory store, made on the first call;
        `spec` as ``parallel.build_mesh``'s."""
        import torch
        import torch.distributed as dist

        from ..parallel.mesh import build_mesh
        from ..runtime_context import get_runtime_context

        has_gpu = bool(get_runtime_context().get_accelerator_ids()["GPU"])
        if not dist.is_initialized():
            kw = {}
            if has_gpu:
                device = torch.device("cuda", 0)
                torch.cuda.set_device(device)
                kw["device_id"] = device
            dist.init_process_group("nccl" if has_gpu else "gloo",
                                    store=dist.HashStore(), rank=0,
                                    world_size=1, **kw)
        elif dist.get_world_size() != 1:
            raise RuntimeError(
                "build_local_mesh: this process is already a rank of a "
                f"{dist.get_world_size()}-rank process group; a local mesh "
                "is a group of this process alone")
        return build_mesh(spec, device_type="cuda" if has_gpu else "cpu")


class MeshGroup:
    """A gang of host actors driven in lockstep SPMD calls."""

    def __init__(self, actors: List[Any],
                 pg: Optional[PlacementGroup] = None,
                 collective_group: Optional[str] = None):
        self._actors = actors
        self._pg = pg
        self.collective_group = collective_group
        # all ranks are driven concurrently: rank 0's init creates the
        # group coordinator and later ranks block on its appearance
        refs = [a._rtpu_setup_mesh.remote(i, len(actors), collective_group)
                for i, a in enumerate(actors)]
        get(refs)

    @property
    def world_size(self) -> int:
        return len(self._actors)

    @property
    def actors(self) -> List[Any]:
        return list(self._actors)

    def run(self, method_name: str, *args, **kwargs) -> List[Any]:
        """Invoke `method_name` on every host actor concurrently; block
        for all results (lockstep — all hosts must enter the same
        computation, like every multi-controller JAX program)."""
        refs = [getattr(a, method_name).remote(*args, **kwargs)
                for a in self._actors]
        return get(refs)

    def run_async(self, method_name: str, *args, **kwargs) -> List[Any]:
        return [getattr(a, method_name).remote(*args, **kwargs)
                for a in self._actors]

    def run_rank(self, rank: int, method_name: str, *args, **kwargs) -> Any:
        return get(getattr(self._actors[rank], method_name)
                   .remote(*args, **kwargs))

    def shutdown(self) -> None:
        from .. import kill
        if self.collective_group is not None:
            # any member can tear the group down (destroy fences the
            # epoch, sweeps stranded chunks and kills the coordinator);
            # bounded so a dead rank 0 can't hang the gang's teardown
            try:
                get(self._actors[0]._rtpu_destroy_collective.remote(
                    self.collective_group), timeout=15.0)
            except Exception:
                pass
        for a in self._actors:
            try:
                kill(a)
            except Exception:
                pass
        if self._pg is not None:
            remove_placement_group(self._pg)


def mesh_group(actor_cls, num_hosts: int,
               resources_per_host: Optional[dict] = None,
               strategy: str = "STRICT_SPREAD",
               actor_args: Sequence[Any] = (),
               actor_kwargs: Optional[dict] = None,
               collective_group: Optional[str] = None) -> MeshGroup:
    """Gang-schedule `num_hosts` host actors, one per placement bundle.

    `actor_cls` must be a `@ray_tpu_torch.remote` class whose implementation
    inherits `SPMDWorkerBase`. STRICT_SPREAD puts one host actor per
    node — the TPU-pod shape (one worker per TPU-VM host).
    ``collective_group`` additionally joins the hosts into a named
    host-level collective group (ring/tree schedules over the node
    plane) usable via the ``mesh_*`` helpers.
    """
    bundle = dict(resources_per_host or {"CPU": 1})
    pg = placement_group([bundle] * num_hosts, strategy=strategy)
    pg.ready(timeout=60.0)
    actor_kwargs = actor_kwargs or {}
    actors = []
    try:
        for i in range(num_hosts):
            strategy_obj = PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=i)
            opts = {"scheduling_strategy": strategy_obj}
            if "CPU" in bundle:
                opts["num_cpus"] = bundle["CPU"]
            extra = {k: v for k, v in bundle.items() if k not in ("CPU",)}
            if extra:
                opts["resources"] = extra
            actors.append(actor_cls.options(**opts).remote(*actor_args,
                                                           **actor_kwargs))
        return MeshGroup(actors, pg=pg, collective_group=collective_group)
    except Exception:
        # don't leak the gang reservation (or stragglers) on failure
        from .. import kill
        for a in actors:
            try:
                kill(a)
            except Exception:
                pass
        remove_placement_group(pg)
        raise
