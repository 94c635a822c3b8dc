"""Rank programs for the multi-process (gloo) tests of ray_tpu_torch.

`launch` starts one spawned process per rank, joined by a `FileStore` in
the test's own directory (no TCP port, so tests in parallel cannot
collide; a new file for every group), and gives each group a deadline.
Each rank program runs with the default process group set up and returns
a dict of numpy arrays, which `launch` hands back in rank order. This
module imports torch, numpy and the port only: the children never import
JAX.
"""

from __future__ import annotations

import multiprocessing
import os
import time
import traceback
import uuid
from typing import Callable, Dict, List

import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu_torch.ops.cpu_numerics import settle_cpu_numerics

# the parent tests run torch on 2 threads too, so sums come out the same
THREADS = 2
# seconds a group may live before `launch` kills it
LAUNCH_TIMEOUT = 240.0


def launch(target: Callable, world: int, workdir, *args,
           timeout: float = LAUNCH_TIMEOUT) -> List[Dict[str, np.ndarray]]:
    """Run target(rank, world, *args) on `world` gloo ranks; fail if any
    rank fails or the group outlives `timeout` seconds."""
    workdir = str(workdir)
    t0 = time.monotonic()
    ctx = multiprocessing.get_context("spawn")
    # a new store file for every group: a FileStore removes its file only
    # once every rank's store object is destroyed, and a rank that exits
    # before that leaves the file with its group's addresses in it; a later
    # group in the same directory read them and connected to a dead port
    store = os.path.join(workdir, f"store_{target.__name__}_{world}_"
                                  f"{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, rank, world, store, workdir, args))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = t0 + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        raise AssertionError(
            f"{target.__name__} on {world} ranks: hung ranks {hung}, exit "
            f"codes {codes}, after {time.monotonic() - t0:.1f} s of the "
            f"{timeout:.0f} s deadline")
    return [dict(np.load(_out_path(workdir, target, rank)))
            for rank in range(world)]


def _out_path(workdir, target, rank):
    return os.path.join(workdir, f"{target.__name__}_rank{rank}.npz")


def settle() -> None:
    """Torch on THREADS intra-op threads, with the first call of each
    VML-backed op made in one thread: two passes over the same values give
    the same bits from the first op on (`settle_cpu_numerics`). Every rank
    program and every test process that compares bits runs this first."""
    settle_cpu_numerics(THREADS)


def fresh_processes(target: Callable, n: int, at_once: int, workdir, *args,
                    timeout: float = LAUNCH_TIMEOUT
                    ) -> List[Dict[str, np.ndarray]]:
    """Run target(i, *args) in `n` fresh spawned processes, `at_once` at a
    time, each set up as a rank program is (`settle`) but with no process
    group; fail if any fails or the whole run outlives `timeout` s."""
    workdir = str(workdir)
    deadline = time.monotonic() + timeout
    ctx = multiprocessing.get_context("spawn")
    codes = []
    for start in range(0, n, at_once):
        procs = [ctx.Process(target=_fresh_main,
                             args=(target, i, workdir, args))
                 for i in range(start, min(n, start + at_once))]
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(10)
            codes.append(p.exitcode)
    if any(codes):
        raise AssertionError(f"{target.__name__} in {n} fresh processes: "
                             f"exit codes {codes}")
    return [dict(np.load(_out_path(workdir, target, i))) for i in range(n)]


def _fresh_main(target, i, workdir, args):
    settle()
    try:
        np.savez(_out_path(workdir, target, i), **target(i, *args))
    except BaseException:
        traceback.print_exc()
        raise SystemExit(1)


def _rank_main(target, rank, world, store, workdir, args):
    settle()
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world)
        try:
            out = target(rank, world, *args)
        finally:
            dist.destroy_process_group()
        np.savez(_out_path(workdir, target, rank), **out)
    except BaseException:
        traceback.print_exc()
        raise SystemExit(1)


# --- ring attention ----------------------------------------------------------

def ring_rank(rank, world, inputs_path, causal):
    """This rank's shard through `ProcessGroupRing` over the world, and the
    same shard through `LoopbackRing` holding every shard: outputs and the
    q/k/v gradients of sum(out**2), and the loopback ring's output over the
    whole sequence (the reference for the ranks' shards, computed here on
    the ranks' own thread count). Also: a CUDA tensor on the gloo ring
    raises before anything is sent (a stand-in object carries the device,
    so this needs no card; the exchanges after it would fail if a send had
    gone out)."""
    import importlib
    from types import SimpleNamespace

    R = importlib.import_module("ray_tpu_torch.ops.ring_attention")

    ring = R.ProcessGroupRing()
    cuda_raises = False
    try:
        ring.shift([(SimpleNamespace(device=torch.device("cuda", 0)),)])
    except RuntimeError:
        cuda_raises = True

    data = np.load(inputs_path)

    def run(transport, shards):
        ts = [[torch.tensor(data[n]).chunk(world, dim=2)[i]
               .clone().requires_grad_() for i in shards]
              for n in ("q", "k", "v")]
        qs, ks, vs = ts
        if isinstance(transport, R.LoopbackRing):
            outs = R.ring_attention(qs, ks, vs, transport, causal=causal)
        else:
            outs = [R.ring_attention(qs[0], ks[0], vs[0], transport,
                                     causal=causal)]
        sum((o ** 2).sum() for o in outs).backward()
        j = shards.index(rank)
        full = torch.cat([o.detach() for o in outs], dim=2).numpy()
        return [outs[j].detach().numpy()] + [t[j].grad.numpy()
                                             for t in ts], full

    names = ("out", "dq", "dk", "dv")
    mine, _ = run(ring, [rank])
    loop, full = run(R.LoopbackRing(world), list(range(world)))
    res = dict(zip(names, mine))
    res.update({f"loopback_{n}": a for n, a in zip(names, loop)})
    # the whole sequence's output, every shard through the loopback ring
    res["loopback_full_out"] = full
    res["cuda_raises"] = np.array(cuda_raises)
    return res


def store_left_behind(rank, world, workdir, leave):
    """With `leave`, join the group and leave at once without destroying it
    (os._exit): the group's FileStore file stays behind with its
    addresses. Without it, an all-reduce of rank + 1."""
    if leave:
        np.savez(_out_path(workdir, store_left_behind, rank),
                 sum=np.array([-1.0]))
        dist.barrier()
        os._exit(0)
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    return {"sum": x.numpy()}


def loopback_twice(index, inputs_path, sp, causal):
    """Two passes of the loopback ring over sp shards in this fresh
    process: the output and the q/k/v gradients of sum(out**2) of each."""
    import importlib

    R = importlib.import_module("ray_tpu_torch.ops.ring_attention")
    data = np.load(inputs_path)
    res = {}
    for p in (1, 2):
        ts = [torch.tensor(data[n]).requires_grad_() for n in ("q", "k", "v")]
        shards = [list(t.chunk(sp, dim=2)) for t in ts]
        out = torch.cat(R.ring_attention(*shards, R.LoopbackRing(sp),
                                         causal=causal), dim=2)
        (out ** 2).sum().backward()
        for name, a in zip(("out", "dq", "dk", "dv"),
                           (out, *(t.grad for t in ts))):
            res[f"{name}{p}"] = a.detach().numpy()
    return res


# --- the model and the train step --------------------------------------------

def gang_loop(config):
    """f32 llama_tiny on this worker's part of the mesh, from the saved
    parameters; a sharded checkpoint after each step in `ckpt_at`, resumed
    from on a restart; optionally rank `die_rank` exits after the step-
    `die_step` checkpoint of the first attempt. Rank 0 saves the final
    parameters, gathered to full."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch import train
    from ray_tpu_torch.models import convert, gpt, training
    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    settle()    # a resumed gang takes its steps in fresh processes
    ctx = train.get_context()
    mesh = build_mesh(MeshSpec(**config["spec"]), device_type="cpu")
    model = gpt.GPT(gpt.llama_tiny(dtype=torch.float32), device="cpu",
                    seed=0, mesh=mesh)
    data = np.load(config["params"])
    convert.load_full_state_dict(
        model, {n: torch.tensor(data[n]) for n in data.files})
    opt = training.make_optimizer(**config["opt"])
    state = training.init_train_state(model, opt, device="cpu", mesh=mesh)
    step = training.make_train_step(model, opt, device="cpu", mesh=mesh)
    resume = train.get_checkpoint()
    if resume is not None:
        resume.to_state_dict(template=state)
    batch = {"tokens": torch.tensor(np.load(config["tokens"])["tokens"])
             .long()}
    while state.step < config["steps"]:
        state, m = step(state, batch)
        ckpt = (train.Checkpoint.from_state_dict(state)
                if state.step in config["ckpt_at"] else None)
        train.report({"step": state.step, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "attempt": ctx.attempt}, checkpoint=ckpt)
        if (ctx.attempt == 0 and state.step == config.get("die_step")):
            dist.barrier()      # rank 0's report is in the queue
            if ctx.get_world_rank() == config["die_rank"]:
                os._exit(1)
    full = convert.full_state_dict(model)
    if ctx.get_world_rank() == 0:
        np.savez(config["out"], **{n: t.numpy() for n, t in full.items()})



def job_train_steps(params_path, tokens_path, steps, opt_kw):
    """f32 llama_tiny on the CPU, no mesh, from the saved parameters:
    `steps` train steps on the saved tokens through the plain attention,
    on one intra-op thread (a task of one CPU runs on one). Returns the
    losses and grad norms. A submitted job's task and the test process
    both run it, for the same bits."""
    from ray_tpu_torch.models import convert, gpt, training

    threads = torch.get_num_threads()
    settle_cpu_numerics(1)
    try:
        model = gpt.GPT(gpt.llama_tiny(dtype=torch.float32), device="cpu",
                        seed=0)
        data = np.load(params_path)
        convert.load_full_state_dict(
            model, {n: torch.tensor(data[n]) for n in data.files})
        opt = training.make_optimizer(**opt_kw)
        state = training.init_train_state(model, opt, device="cpu")
        step = training.make_train_step(model, opt, device="cpu")
        batch = {"tokens": torch.tensor(np.load(tokens_path)["tokens"])
                 .long()}
        losses, grad_norms = [], []
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            grad_norms.append(float(m["grad_norm"]))
        return {"losses": losses, "grad_norms": grad_norms,
                "pid": os.getpid()}
    finally:
        torch.set_num_threads(threads)


def _model(config_kw, spec_kw, params_path, family="llama_tiny",
           check_shards=False):
    from ray_tpu_torch.models import convert, gpt
    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(**spec_kw), device_type="cpu")
    if family == "llama_tiny":
        cfg = gpt.llama_tiny(dtype=torch.float32, **config_kw)
    else:
        cfg = gpt.GPTConfig(dtype=torch.float32, **config_kw)
    model = gpt.GPT(cfg, device="cpu", seed=0, mesh=mesh)
    if check_shards:
        model.shards_not_matching = _shards_match_unsharded(model, cfg)
    init = torch.cat([t.reshape(-1) for t in
                      convert.full_state_dict(model).values()])
    if params_path is not None:
        data = np.load(params_path)
        convert.load_full_state_dict(
            model, {n: torch.tensor(data[n]) for n in data.files})
    return model, mesh, init.numpy()


class LiveBytes(TorchDispatchMode):
    """A dispatch mode that tracks the storages the ops inside it allocate
    and the most bytes of them alive at once (a storage is alive while any
    tensor or parameter holds it), and the largest one."""

    def __init__(self):
        super().__init__()
        self.storages = {}
        self.peak = 0
        self.largest = 0

    def live(self):
        return sum(n for ref, n in self.storages.values()
                   if ref() is not None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                try:
                    st = t.untyped_storage()
                    key = st.data_ptr()
                except RuntimeError:    # no storage of its own
                    continue
                known = self.storages.get(key)
                if known is None or known[0]() is not st:
                    self.storages[key] = (weakref.ref(st), st.nbytes())
                    self.largest = max(self.largest, st.nbytes())
        self.peak = max(self.peak, self.live())
        return out


def build_memory_rank(rank, world, spec_kw, config_kw):
    """The most bytes alive at once while this rank builds f32 llama_tiny
    (with `config_kw`) on the mesh, beside the bytes of its tp/ep slices
    (what it holds before FSDP2 shards them further), the largest single
    tensor allocated, and the largest full parameter of the model."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    cfg = gpt.llama_tiny(dtype=torch.float32, **config_kw)
    mesh = build_mesh(MeshSpec(**spec_kw), device_type="cpu")
    mode = LiveBytes()
    with mode:
        model = gpt.GPT(cfg, device="cpu", seed=0, mesh=mesh)
    # a DTensor's shape is that of the tp/ep slice FSDP2 shards
    sliced = sum(p.numel() * p.element_size() for p in model.parameters())
    full = gpt.GPT(cfg, device="cpu", seed=0)
    return {"peak": np.array(mode.peak), "sliced": np.array(sliced),
            "largest": np.array(mode.largest),
            "largest_param": np.array(max(
                p.numel() * p.element_size() for p in full.parameters())),
            "model": np.array(sum(p.numel() * p.element_size()
                                  for p in full.parameters()))}


def _shards_match_unsharded(model, cfg):
    """Whether each parameter this rank holds (its FSDP2 shard of its tp/ep
    slice) equals, bit for bit, the same part of the tensor that
    `GPT(cfg, seed=0)` draws with no mesh: the names that differ."""
    from torch.distributed.tensor import Shard

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import logical_sharding

    full = dict(gpt.GPT(cfg, device="cpu", seed=0).named_parameters())
    rules = model.rules.only("tp", "ep")
    axes = model.param_logical_axes()
    bad = []
    for n, p in model.named_parameters():
        want = full[n].detach()[logical_sharding(model.mesh, rules, axes[n],
                                                 full[n].shape)]
        coord = p.device_mesh.get_coordinate()
        for dim, pl in enumerate(p.placements):
            if isinstance(pl, Shard):
                chunks = torch.chunk(want, p.device_mesh.size(dim), pl.dim)
                want = (chunks[coord[dim]] if coord[dim] < len(chunks)
                        else want.narrow(pl.dim, 0, 0))
        if not torch.equal(p.to_local(), want):
            bad.append(n)
    return bad


def _coords(mesh):
    """This rank's coordinate on each axis, in AXIS_ORDER."""
    from ray_tpu_torch.parallel import AXIS_ORDER

    return np.array([mesh.coords[a] for a in AXIS_ORDER])


def train_rank(rank, world, spec_kw, params_path, tokens_path, steps,
               opt_kw, config_kw=None):
    """`steps` train steps of f32 llama_tiny (with `config_kw`) on this
    rank's part of the global batch: losses, grad norms, tokens (and the
    load-balance loss, with experts) each step, the final parameters
    gathered to full, and the weights the seed gave before the load."""
    from ray_tpu_torch.models import convert, training

    model, mesh, init = _model(config_kw or {}, spec_kw, params_path,
                               check_shards=True)
    opt = training.make_optimizer(**opt_kw)
    state = training.init_train_state(model, opt, device="cpu", mesh=mesh)
    step = training.make_train_step(model, opt, device="cpu", mesh=mesh)
    batch = {"tokens": torch.tensor(np.load(tokens_path)["tokens"]).long()}
    losses, norms, tokens, aux = [], [], [], []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        tokens.append(float(m["tokens"]))
        aux.append(float(m.get("moe_aux_loss", 0.0)))
    out = {f"param/{n}": t.numpy()
           for n, t in convert.full_state_dict(model).items()}
    out.update(losses=np.array(losses), grad_norms=np.array(norms),
               tokens=np.array(tokens), aux=np.array(aux), init=init,
               coords=_coords(mesh),
               shards_not_matching=np.array(model.shards_not_matching,
                                            dtype=str))
    eval_metrics = training.eval_step_fn(model, device="cpu", mesh=mesh)(
        batch)
    out["eval_loss"] = np.array(float(eval_metrics["loss"]))
    return out


def forward_rank(rank, world, spec_kw, config_kw, params_path, tokens_path,
                 family="gpt2"):
    """Logits of this rank's sequence shard (its vocab columns under tp),
    the global loss and the full gradients of a model (by default the GPT-2
    family: learned positions, LayerNorm biases, tied embeddings) on a
    mesh. With pp > 1 the pipeline's forward and backward give the
    gradients, those of the parameters every stage holds summed over pp."""
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.parallel import shard_batch

    model, mesh, _ = _model(config_kw, spec_kw, params_path, family=family)
    tokens = torch.tensor(np.load(tokens_path)["tokens"]).long()
    with torch.no_grad():
        # apply takes this rank's tokens (positions default to the shard's
        # global ones); loss takes the global batch
        logits = model.apply(shard_batch(mesh, {"tokens": tokens})["tokens"])
    if model.pp_stages > 1:
        loss, metrics = model.pipeline_loss({"tokens": tokens},
                                            backward=True)
        for n in model.pp_replicated():
            p = dict(model.named_parameters())[n]
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            g = p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad
            dist.all_reduce(g, group=mesh.group("pp"))
    else:
        loss, metrics = model.loss({"tokens": tokens})
        loss.backward()
    grads = convert.full_state_dict(
        model, {n: p.grad for n, p in model.named_parameters()})
    out = {f"grad/{n}": g.numpy() for n, g in grads.items()}
    out.update(logits=logits.numpy(), loss=np.array(float(loss)),
               global_loss=np.array(float(metrics["loss"])),
               coords=_coords(mesh))
    return out


def clip_rank(rank, world, spec_kw, inputs_path, logical, opt_kw):
    """`Optimizer.update_` on this rank's shards (by `shard_params` over
    every mesh axis) of full params and grads, with the norm summed over
    the axes each is cut over; three updates. Returns the norms, the
    updated params gathered to full, and whether the same update on one
    rank's whole tensors with `norm_sums` over groups of one rank equals
    the update without them bit for bit."""
    from ray_tpu_torch.models import training
    from ray_tpu_torch.parallel import (DEFAULT_RULES, MeshSpec, build_mesh,
                                        gather_params, shard_params)
    from ray_tpu_torch.parallel.sharding import _axes

    mesh = build_mesh(MeshSpec(**spec_kw), device_type="cpu")
    data = np.load(inputs_path)
    full_p = {n: torch.tensor(data[f"p/{n}"]) for n in logical}
    full_g = {n: torch.tensor(data[f"g/{n}"]) for n in logical}
    params = {n: t.clone() for n, t in
              shard_params(full_p, logical, mesh).items()}
    grads = shard_params(full_g, logical, mesh)
    shard_axes = {n: tuple(a for ax in axes for a in _axes(
        DEFAULT_RULES.mesh_axes(ax)) if mesh.shape[a] > 1)
        for n, axes in logical.items()}
    norm_sums = training.norm_sums_for(mesh, shard_axes)
    opt = training.make_optimizer(**opt_kw)
    state = opt.init(params)
    norms = [float(opt.update_(params, [g.clone() for g in grads.values()],
                               state, norm_sums)) for _ in range(3)]
    # whole tensors, squares "summed" over groups of one rank
    whole = {n: t.clone() for n, t in full_p.items()}
    plain = {n: t.clone() for n, t in full_p.items()}
    s_whole, s_plain = opt.init(whole), opt.init(plain)
    ones = [(mesh.group("pp"), list(full_p)), (mesh.group("ep"),
                                               list(full_p)[:2])]
    same = True
    for _ in range(3):
        n1 = opt.update_(whole, [g.clone() for g in full_g.values()],
                         s_whole, ones)
        n2 = opt.update_(plain, [g.clone() for g in full_g.values()],
                         s_plain)
        same = same and torch.equal(n1, n2)
    same = same and all(torch.equal(whole[n], plain[n]) for n in whole)
    out = {f"param/{n}": t.numpy() for n, t in
           gather_params(params, logical, mesh).items()}
    out.update(norms=np.array(norms), bit_identical=np.array(same))
    return out


# --- the MoE FFN on a mesh -----------------------------------------------------

def moe_rank(rank, world, spec_kw, inputs_path, top_k, capacity_factor):
    """`moe_ffn` and its routing on this rank's rows and columns of a global
    f32 input, with its ep and tp slices of the expert weights: routing
    (expert choice, slot, fits) of its tokens, the output, the metrics, and
    the gradients of sum(out * probe): of its part of x, and of the router
    and expert weights summed over the batch group and gathered to full."""
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel import (DEFAULT_RULES, MeshSpec, build_mesh,
                                        gather_params, logical_sharding,
                                        shard_params)

    mesh = build_mesh(MeshSpec(**spec_kw), device_type="cpu")
    data = np.load(inputs_path)
    logical = {"router": ("embed", None), "w_up": ("expert", "embed", "mlp"),
               "w_gate": ("expert", "embed", "mlp"),
               "w_down": ("expert", "mlp", "embed")}
    rules = DEFAULT_RULES.only("tp", "ep")
    weights = {n: t.clone().requires_grad_() for n, t in shard_params(
        {n: torch.tensor(data[n]) for n in logical}, logical, mesh,
        rules).items()}
    index = logical_sharding(mesh, DEFAULT_RULES,
                             ("act_batch", "act_seq", None), data["x"].shape)
    x = torch.tensor(data["x"])[index].clone().requires_grad_()
    m = moe.MoEMesh.from_mesh(mesh)
    with torch.no_grad():
        r = moe.route_on_mesh(x, weights["router"], top_k, capacity_factor, m)
    out, metrics = moe.moe_ffn(
        x, weights["router"], weights["w_up"], weights["w_gate"],
        weights["w_down"], top_k=top_k, capacity_factor=capacity_factor,
        dtype=torch.float32, mesh=m)
    (out * torch.tensor(data["probe"])[index]).sum().backward()
    grads = {}
    for n, w in weights.items():
        g = w.grad.clone()
        dist.all_reduce(g, group=mesh.batch_group)
        grads[n] = g
    grads = gather_params(grads, logical, mesh, rules)
    res = {f"grad/{n}": g.numpy() for n, g in grads.items()}
    res.update({k: r[k].numpy() for k in ("expert_idx", "slot", "fits")})
    res.update(out=out.detach().numpy(), grad_x=x.grad.numpy(),
               aux=np.array(float(metrics["moe_aux_loss"])),
               overflow=np.array(float(metrics["moe_overflow"])),
               coords=_coords(mesh))
    return res



# --- a mesh of one rank --------------------------------------------------------

# the collectives of the model on a process mesh, by module
MESH_CALLS = {
    "ray_tpu_torch.models.gpt": ("copy_to_tp", "reduce_from_tp",
                                 "gather_from_tp"),
    "ray_tpu_torch.models.moe": ("copy_to_tp", "reduce_from_tp",
                                 "copy_to_ep", "reduce_from_ep",
                                 "sum_over_batch", "gather_over_batch"),
    "ray_tpu_torch.models.training": ("_global_norms",),
}


def mesh1_rank(rank, world, config_kw, params_path, tokens_path, steps,
               opt_kw):
    """`steps` train steps of f32 llama_tiny (with `config_kw`) through the
    process-mesh path on a mesh of this one rank, counting the calls of
    each of MESH_CALLS (as module attributes: the model looks them up at
    each call): losses, grad norms, the load-balance loss, the final
    parameters and the calls per step, "module.name" -> calls."""
    import importlib

    from ray_tpu_torch.models import convert, training

    calls, real = {}, {}
    for mod_name, names in MESH_CALLS.items():
        mod = importlib.import_module(mod_name)
        for n in names:
            key = f"{mod_name.rsplit('.', 1)[1]}.{n}"
            calls[key], real[key] = 0, getattr(mod, n)

            def counted(*args, _key=key, **kw):
                calls[_key] += 1
                return real[_key](*args, **kw)

            setattr(mod, n, counted)
    model, mesh, _ = _model(config_kw, dict(dp=1), params_path)
    opt = training.make_optimizer(**opt_kw)
    state = training.init_train_state(model, opt, device="cpu", mesh=mesh)
    step = training.make_train_step(model, opt, device="cpu", mesh=mesh)
    batch = {"tokens": torch.tensor(np.load(tokens_path)["tokens"]).long()}
    losses, norms, aux = [], [], []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        aux.append(float(m.get("moe_aux_loss", 0.0)))
    out = {f"param/{n}": t.numpy()
           for n, t in convert.full_state_dict(model).items()}
    out.update(losses=np.array(losses), grad_norms=np.array(norms),
               aux=np.array(aux),
               call_names=np.array(list(calls)),
               calls=np.array([calls[k] / steps for k in calls]))
    return out
