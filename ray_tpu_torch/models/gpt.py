"""Decoder-only transformer on one CUDA device (or the CPU, for tests).

Counterpart of ``ray_tpu/models/gpt.py``: one implementation covers the
GPT-2 family (learned positions, GELU MLP, LayerNorm) and the Llama family
(RoPE, SwiGLU, RMSNorm, GQA) through `GPTConfig` switches.

Numerics follow the JAX model with explicit casts (no autocast): params are
f32 and cast to the activation dtype at use, the embedding gather happens
in that dtype, the residual stream stays in it, norms compute in f32 and
cast back, logits come back f32 (the head's products run on a working copy
padded to a multiple of 64 rows, `HEAD_ROW_ALIGN`, and are cut back to the
vocabulary; the parameters keep their shapes). Every per-layer parameter
keeps the JAX layout of one slice of the stacked tree (``wq [d, h, hd]``,
``wo [h, hd, d]``, ...), so a JAX checkpoint loads by unstacking only
(`ray_tpu_torch.models.convert.params_from_jax`).

Parallelism comes in through a `ray_tpu_torch.parallel.Mesh` and its
rules, as in JAX, on all six axes. On a process mesh (`build_mesh`) each
rank holds its tp slice of every parameter (heads, kv_heads, mlp and vocab
split, Megatron's column- and row-parallel layout with one all-reduce over
tp after each block half, a vocab-parallel embedding, head and cross
entropy) and its ep slice of the experts, and FSDP2 shards that over (dp,
fsdp): each block, then the root module. A rank computes its rows and
sequence columns; attention runs the flash kernels on the rank's heads, or
`ring_attention` over sp on them. The mixture-of-experts FFN (``n_experts
> 0``, `moe.py`) routes over the global tokens of the batch group and runs
this rank's experts. With pp > 1 a rank holds the blocks of its stage (the
parameters outside the blocks on every stage, as JAX replicates them over
pp) and the GPipe schedule of `ray_tpu_torch.parallel.pipeline` carries the
microbatches through the stages; every stage runs the flash kernels, where
JAX's pipeline falls back to its reference attention. On a loopback mesh
one process holds every sp shard (it runs the whole sequence and splits
only attention into the ring's shards) or every stage. JAX's refusals
stand: n_layers must divide into the stages, and experts with pp > 1
raise.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.attention import dot_product_attention
from ..ops.ring_attention import ring_attention, ring_transport
from ..parallel import pipeline
from ..parallel.mesh import AXIS_EP, AXIS_FSDP, AXIS_PP, AXIS_TP, Mesh
from ..parallel.sharding import (DEFAULT_RULES, ShardingRules, _axes,
                                 logical_sharding, shard_batch,
                                 with_logical_constraint)
from ..parallel.tensor_parallel import (copy_to_tp, gather_from_tp,
                                        reduce_from_tp)
from ..util import tracing
from .moe import MoEMesh, moe_ffn


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304          # GPT-2 vocab padded to a multiple of 128
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    n_kv_heads: Optional[int] = None  # None -> n_heads (MHA); < n_heads -> GQA
    d_ff: Optional[int] = None        # None -> 4*d_model (gelu) / 8/3*d (swiglu)
    max_seq_len: int = 1024
    # family switches
    activation: str = "gelu"          # "gelu" | "swiglu"
    norm: str = "layernorm"           # "layernorm" | "rmsnorm"
    positions: str = "learned"        # "learned" | "rope"
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    # GPipe microbatches on a mesh with pp > 1 (0: one per stage)
    pp_microbatches: int = 0
    # mixture-of-experts FFN (moe.py) in every block when n_experts > 0
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coeff: float = 0.01
    # numerics
    dtype: Any = torch.bfloat16       # activation dtype
    param_dtype: Any = torch.float32
    # training
    remat: bool = True
    # what the per-block checkpoint saves for backward: "full" recomputes
    # everything; "dots" saves the outputs of the 2-D matrix products (the
    # projections) and recomputes the rest, attention's forward included
    remat_policy: str = "full"
    z_loss: float = 1e-4
    # attention: "auto" | "cuda" | "reference"
    attention_impl: str = "auto"
    # TPU tile sizes of the JAX model; the CUDA kernels choose their own
    attn_block_q: int = 512
    attn_block_k: int = 512

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def ff_dim(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        if self.activation == "swiglu":
            # llama convention: 8/3 * d, rounded up to a multiple of 256
            raw = int(8 * self.d_model / 3)
            return (raw + 255) // 256 * 256
        return 4 * self.d_model

    @property
    def n_params(self) -> int:
        """Approximate parameter count (excludes norms/bias)."""
        d, f, v = self.d_model, self.ff_dim, self.vocab_size
        hd, h, hk = self.head_dim, self.n_heads, self.kv_heads
        attn = d * h * hd + 2 * d * hk * hd + h * hd * d
        if self.n_experts > 0:
            mlp = self.n_experts * 3 * d * f + d * self.n_experts
        else:
            mlp = (3 if self.activation == "swiglu" else 2) * d * f
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + mlp) + emb


# --- presets ---------------------------------------------------------------

def gpt2_small(**kw) -> GPTConfig:
    return GPTConfig(n_layers=12, d_model=768, n_heads=12, **kw)


def gpt2_medium(**kw) -> GPTConfig:
    return GPTConfig(n_layers=24, d_model=1024, n_heads=16, **kw)


def gpt2_large(**kw) -> GPTConfig:
    return GPTConfig(n_layers=36, d_model=1280, n_heads=20, **kw)


def _llama(**kw) -> GPTConfig:
    base = dict(activation="swiglu", norm="rmsnorm", positions="rope",
                tie_embeddings=False, vocab_size=32000, max_seq_len=2048)
    base.update(kw)
    return GPTConfig(**base)


def llama_tiny(**kw) -> GPTConfig:
    """Test-scale llama-style config (CPU-friendly)."""
    return _llama(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                  vocab_size=512, max_seq_len=256, **kw)


def llama_1b(**kw) -> GPTConfig:
    return _llama(n_layers=16, d_model=2048, n_heads=16, n_kv_heads=8, **kw)


def llama_7b(**kw) -> GPTConfig:
    return _llama(n_layers=32, d_model=4096, n_heads=32, d_ff=11008,
                  max_seq_len=4096, **kw)


# --- device and remat policy -------------------------------------------------

def resolve_device(device) -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "ray_tpu_torch on the CPU")
    return device


def _dots_policy(ctx, op, *args, **kwargs):
    # JAX's dots_with_no_batch_dims_saveable: keep the 2-D products (the
    # projections and MoE's router, dispatch and combine, aten.mm);
    # recompute everything else, attention and the per-expert bmm included.
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_CONTEXTS = {
    "full": None,
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _dots_policy),
}


def _pp_stages(mesh: Optional[Mesh], rules: ShardingRules) -> int:
    """Pipeline stages: the size of the mesh axis "stage" maps to."""
    if mesh is None:
        return 1
    ax = rules.mesh_axes("stage")
    if isinstance(ax, str) and ax in mesh.shape:
        return mesh.shape[ax]
    return 1


def check_mesh(c: GPTConfig, mesh: Optional[Mesh],
               rules: ShardingRules = DEFAULT_RULES) -> None:
    """JAX's refusals (``ray_tpu/models/gpt.py``, ``GPT.__init__``)."""
    P = _pp_stages(mesh, rules)
    if P > 1:
        if c.n_layers % P:
            raise ValueError(f"n_layers={c.n_layers} must divide into "
                             f"pp={P} stages")
        if c.n_experts > 0:
            raise NotImplementedError(
                "EP+PP combined (MoE aux-loss masking across pipeline "
                "bubbles) is not supported yet")


# --- model -----------------------------------------------------------------

class _Draw:
    """Draws the parameters from one generator in one order, whatever the
    layout: each tensor is drawn whole (normal, std, in f32, then cast)
    and, when `local` is given, cut at once to this rank's part of it, so
    the full tensor is freed before the next is drawn. `local(name,
    shape)` gives the slices of that part, or None for a parameter this
    rank does not hold (another pipeline stage's block), which is drawn
    all the same to keep the generator's order."""

    def __init__(self, gen: torch.Generator, device, dtype,
                 local: Optional[Callable] = None, prefix: str = ""):
        self.gen, self.device, self.dtype = gen, device, dtype
        self.local, self.prefix = local, prefix

    def scoped(self, prefix: str) -> "_Draw":
        return _Draw(self.gen, self.device, self.dtype, self.local,
                     self.prefix + prefix)

    def _part(self, name: str, shape):
        if self.local is None:
            return ()
        return self.local(self.prefix + name, shape)

    def normal(self, name: str, std: float, *shape
               ) -> Optional[nn.Parameter]:
        full = torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=torch.float32).mul_(std).to(self.dtype)
        part = self._part(name, shape)
        if part is None:
            return None
        return nn.Parameter(full if part == () else full[part].clone())

    def const(self, name: str, value: float, *shape
              ) -> Optional[nn.Parameter]:
        part = self._part(name, shape)
        if part is None:
            return None
        if part != ():
            shape = torch.empty(shape, device="meta")[part].shape
        return nn.Parameter(torch.full(shape, value, device=self.device,
                                       dtype=self.dtype))


class Block(nn.Module):
    """One transformer block's parameters, in the JAX layout, drawn by
    `draw` (scoped to the block's name) in the generator's order."""

    def __init__(self, c: GPTConfig, draw: _Draw):
        super().__init__()
        d, f, hd = c.d_model, c.ff_dim, c.head_dim
        h, hk = c.n_heads, c.kv_heads
        std = 0.02
        resid_std = std / math.sqrt(2 * c.n_layers)
        normal, const = draw.normal, draw.const

        self.norm1 = const("norm1", 1.0, d)
        self.norm2 = const("norm2", 1.0, d)
        self.wq = normal("wq", std, d, h, hd)
        self.wk = normal("wk", std, d, hk, hd)
        self.wv = normal("wv", std, d, hk, hd)
        self.wo = normal("wo", resid_std, h, hd, d)
        if c.n_experts > 0:
            E = c.n_experts
            self.router = normal("router", std, d, E)
            self.w_up = normal("w_up", std, E, d, f)
            self.w_gate = normal("w_gate", std, E, d, f)
            self.w_down = normal("w_down", resid_std, E, f, d)
        else:
            self.w_up = normal("w_up", std, d, f)
            self.w_down = normal("w_down", resid_std, f, d)
            if c.activation == "swiglu":
                self.w_gate = normal("w_gate", std, d, f)
        if c.norm == "layernorm":
            self.bias1 = const("bias1", 0.0, d)
            self.bias2 = const("bias2", 0.0, d)

    def forward(self, block_fn, x, positions):
        """block_fn(self, x, positions): the model's computation of this
        block, called through the module so that FSDP2's hooks gather the
        block's parameters around it."""
        return block_fn(self, x, positions)


# cuBLAS's Hopper kernels need each leading dimension 16-byte aligned, and
# the head's row count is one in all three of its products: `GPT._head`
# pads the rows to a multiple of this (unpadded, GPT-2's 50,257 rows run on
# sm75 CUTLASS kernels; the GPT-2 presets' 50,304 are such a multiple)
HEAD_ROW_ALIGN = 64


def _cast_to_width(t: torch.Tensor, cols: int, dtype) -> torch.Tensor:
    """`t` [..., n] cast to `dtype` with its last dimension cut or
    zero-padded to `cols`, in one pass into a new tensor. A transposed 2-D
    table (a [V, d] table read as [d, V]) keeps that layout."""
    keep = min(t.shape[-1], cols)
    if t.dim() == 2 and t.stride(0) == 1 and t.stride(1) != 1:
        out = t.new_empty((cols, t.shape[0]), dtype=dtype).t()
    else:
        out = t.new_empty((*t.shape[:-1], cols), dtype=dtype)
    out[..., :keep].copy_(t[..., :keep])
    out[..., keep:].zero_()
    return out


class _CastToWidth(torch.autograd.Function):
    """`_cast_to_width` under autograd: its backward is the same cast back
    to the input's dtype and width, so the gradient of a cut tensor is
    padded (and that of a padded one cut) in one pass, with no second
    buffer of the padded size."""

    @staticmethod
    def forward(ctx, t, cols, dtype):
        ctx.back = (t.shape[-1], t.dtype)
        return _cast_to_width(t, cols, dtype)

    @staticmethod
    def backward(ctx, grad):
        return _cast_to_width(grad, *ctx.back), None, None


class GPT(nn.Module):
    """`forward` (= `forward_with_aux`) -> (logits, aux), `apply` ->
    logits, `loss`.

    Parameters are initialised from `seed` with a `torch.Generator` on
    `device` (normal, std 0.02; residual projections 0.02/sqrt(2L)), as the
    JAX model's `init` does with its key; the two give different numbers.
    On a process mesh every rank draws the same tensors in the same order
    and keeps only its shards, cutting each as it is drawn.
    """

    def __init__(self, config: GPTConfig, device="cuda", seed: int = 0,
                 mesh: Optional[Mesh] = None,
                 rules: Optional[ShardingRules] = None):
        super().__init__()
        with tracing.start_span("model::" + "init") as span:
            self._build(config, device, seed, mesh, rules)
            if span is not None:
                span["attributes"]["head_pad_rows"] = self.head_pad_rows

    def _build(self, config: GPTConfig, device, seed: int,
               mesh: Optional[Mesh], rules: Optional[ShardingRules]) -> None:
        """The constructor's work: the mesh's transports, the weights'
        draw and, on a process mesh, the shards."""
        c = config
        self.mesh = mesh
        self.rules = rules if rules is not None else DEFAULT_RULES
        check_mesh(c, mesh, self.rules)
        # the loss and the gradients sum over ranks on a process mesh (of
        # any size, one program as GSPMD runs one: a mesh of one rank takes
        # the same collectives); a loopback mesh holds every shard here
        self.sums_over_ranks = mesh is not None and not mesh.loopback
        self._tp = mesh.group(AXIS_TP) if self.sums_over_ranks else None
        self._moe_mesh = (MoEMesh.from_mesh(mesh) if self.sums_over_ranks
                          and c.n_experts > 0 else None)
        self._pipe = None
        if self.pp_stages > 1:
            self._pipe = pipeline.pipe_transport(mesh.group(
                self.rules.mesh_axes("stage")))
        self._ring = None
        if self._sp_size() > 1:
            axis = self.rules.mesh_axes("act_seq")
            if not isinstance(axis, str):
                raise ValueError("ring attention needs act_seq mapped to "
                                 f"a single mesh axis, got {axis!r}")
            self._ring = ring_transport(mesh.group(axis))
        if c.remat and c.remat_policy not in _REMAT_CONTEXTS:
            raise ValueError(
                f"remat_policy must be one of {sorted(_REMAT_CONTEXTS)}, got "
                f"{c.remat_policy!r} (use remat=False to disable "
                "rematerialization entirely)")
        self.config = c
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        # on a process mesh each tensor is cut to this rank's part as soon
        # as it is drawn: a rank never holds more than its shards and one
        # full tensor (JAX's init runs under jit(out_shardings=...))
        draw = _Draw(gen, device, c.param_dtype,
                     self._local_part() if self.sums_over_ranks else None)
        d = c.d_model

        self.tok_embed = draw.normal("tok_embed", 0.02, c.vocab_size, d)
        # keyed by layer: a pipeline stage keeps its blocks' global names
        blocks = {str(i): Block(c, draw.scoped(f"blocks.{i}."))
                  for i in range(c.n_layers)}
        self.blocks = nn.ModuleDict({k: b for k, b in blocks.items()
                                     if b.wq is not None})
        del blocks
        self.norm_f = draw.const("norm_f", 1.0, d)
        if c.positions == "learned":
            self.pos_embed = draw.normal("pos_embed", 0.02, c.max_seq_len, d)
        if c.norm == "layernorm":
            self.bias_f = draw.const("bias_f", 0.0, d)
        if not c.tie_embeddings:
            self.lm_head = draw.normal("lm_head", 0.02, d, c.vocab_size)
        # the zero rows `_head` adds to this rank's head rows (its vocab
        # slice under tp) in its working copy; 0 where they are aligned
        rows = (self.tok_embed.shape[0] if c.tie_embeddings
                else self.lm_head.shape[1])
        self.head_pad_rows = -rows % HEAD_ROW_ALIGN
        if self.sums_over_ranks:
            self._shard()

    @property
    def pp_stages(self) -> int:
        return _pp_stages(self.mesh, self.rules)

    def _stage_layers(self, stage: int) -> range:
        per = self.config.n_layers // self.pp_stages
        return range(stage * per, (stage + 1) * per)

    def _local_part(self) -> Callable:
        """name, global shape -> this rank's slices of the parameter by the
        rules' tp and ep axes, or None for a block of another pipeline
        stage."""
        tp_rules = self.rules.only(AXIS_TP, AXIS_EP)
        axes = self.param_logical_axes()
        mine = None
        if self._pipe is not None:
            mine = self._stage_layers(self.mesh.coords[
                self.rules.mesh_axes("stage")])

        def local(name, shape):
            if mine is not None and name.startswith("blocks."):
                if int(name.split(".")[1]) not in mine:
                    return None
            return logical_sharding(self.mesh, tp_rules, axes[name], shape)
        return local

    def _shard(self) -> None:
        """This rank's layout on a process mesh, after `_Draw` has kept the
        blocks of its pipeline stage and cut every parameter to its tp and
        ep slice: FSDP2 over the (dp, fsdp) mesh, each block and then the
        root; the gradients are summed, not averaged (the loss is already
        each rank's share of the global one)."""
        from torch.distributed.fsdp import fully_shard

        tp_rules = self.rules.only(AXIS_TP, AXIS_EP)
        self._vocab_lo = logical_sharding(self.mesh, tp_rules, ("vocab",),
                                          (self.config.vocab_size,))[0].start
        for module in [*self.blocks.values(), self]:
            fully_shard(module, mesh=self.mesh.data_mesh)
            module.set_gradient_divide_factor(1.0)
            module.set_force_sum_reduction_for_comms(True)

    def param_logical_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """Parameter name -> its logical axes: JAX's table
        (``ray_tpu/models/gpt.py``, ``GPT.param_logical_axes``) keyed by
        the port's names, each block's without the stacked "layers" axis."""
        c = self.config
        block = {
            "norm1": (None,),
            "norm2": (None,),
            "wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed"),
        }
        if c.n_experts > 0:
            block["router"] = ("embed", None)
            block["w_up"] = ("expert", "embed", "mlp")
            block["w_gate"] = ("expert", "embed", "mlp")
            block["w_down"] = ("expert", "mlp", "embed")
        else:
            block["w_up"] = ("embed", "mlp")
            block["w_down"] = ("mlp", "embed")
            if c.activation == "swiglu":
                block["w_gate"] = ("embed", "mlp")
        if c.norm == "layernorm":
            block["bias1"] = (None,)
            block["bias2"] = (None,)
        axes: Dict[str, Tuple[Optional[str], ...]] = {
            "tok_embed": ("vocab", "embed"), "norm_f": (None,)}
        if c.positions == "learned":
            axes["pos_embed"] = (None, "embed")
        if c.norm == "layernorm":
            axes["bias_f"] = (None,)
        if not c.tie_embeddings:
            axes["lm_head"] = ("embed", "vocab")
        for i in range(c.n_layers):
            axes.update({f"blocks.{i}.{k}": v for k, v in block.items()})
        return axes

    def own_logical_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """`param_logical_axes` of the parameters this rank holds (on a
        pipeline stage: its blocks and the parameters outside them)."""
        own = {n for n, _ in self.named_parameters()}
        return {n: v for n, v in self.param_logical_axes().items()
                if n in own}

    def param_shard_axes(self) -> Dict[str, Tuple[str, ...]]:
        """Parameter name -> the mesh axes its local shard on this rank is
        cut over (fsdp by FSDP2, tp and ep by the rules, pp for the blocks
        of a pipeline stage): the groups over which sums of a gradient's
        squares run. Empty off a process mesh."""
        if not self.sums_over_ranks:
            return {n: () for n, _ in self.named_parameters()}
        rules = self.rules.only(AXIS_TP, AXIS_EP)
        out = {}
        for n, ax in self.own_logical_axes().items():
            cut = {a for entry in ax for a in _axes(rules.mesh_axes(entry))}
            out[n] = ((AXIS_FSDP,)
                      + tuple(a for a in (AXIS_EP, AXIS_TP) if a in cut)
                      + ((AXIS_PP,) if self._pipe is not None
                         and n.startswith("blocks.") else ()))
        return out

    def pp_replicated(self) -> list:
        """Names of the parameters every pipeline stage holds (those outside
        the blocks), whose gradients the step sums over pp; empty unless
        this is a process mesh with pp > 1."""
        if self._pipe is None or not self.sums_over_ranks:
            return []
        return [n for n, _ in self.named_parameters()
                if not n.startswith("blocks.")]

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    def _sp_size(self) -> int:
        """Size of the mesh axis act_seq maps to (sequence parallelism)."""
        if self.mesh is None:
            return 1
        ax = self.rules.mesh_axes("act_seq")
        if isinstance(ax, str) and ax in self.mesh.shape:
            return self.mesh.shape[ax]
        return 1

    # -- building blocks ---------------------------------------------------

    def _norm(self, x, scale, bias):
        """RMSNorm (eps 1e-6) or LayerNorm (eps 1e-5, population variance),
        computed in f32 by one fused op each and cast back."""
        c = self.config
        xf, shape = x.float(), (x.shape[-1],)
        if c.norm == "rmsnorm":
            out = F.rms_norm(xf, shape, scale.float(), eps=1e-6)
        else:
            out = F.layer_norm(xf, shape, scale.float(),
                               None if bias is None else bias.float(),
                               eps=1e-5)
        return out.to(c.dtype)

    def _rope(self, x, positions):
        """Half-split RoPE. x: [B, S, H, D_h]; positions: [B, S]."""
        c = self.config
        half = x.shape[-1] // 2
        freqs = c.rope_theta ** (-torch.arange(
            0, half, dtype=torch.float32, device=x.device) / half)
        angles = positions[..., None].float() * freqs       # [B, S, half]
        cos = torch.cos(angles)[:, :, None, :]
        sin = torch.sin(angles)[:, :, None, :]
        x1, x2 = x.float().split(half, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
        return out.to(x.dtype)

    @staticmethod
    def _proj(x, w):
        """x [..., d_in] @ w [d_in, *out] as one 2-D product -> [..., *out]."""
        lead, d_in = x.shape[:-1], x.shape[-1]
        out = x.reshape(-1, d_in) @ w.reshape(d_in, -1)
        return out.view(*lead, *w.shape[1:])

    def _tp_in(self, x):
        """The input of column-parallel products (gradient summed over tp);
        off a process mesh, `x`."""
        return x if self._tp is None else copy_to_tp(x, self._tp)

    def _tp_out(self, x):
        """The partial output of a row-parallel product, summed over tp;
        off a process mesh, `x`."""
        return x if self._tp is None else reduce_from_tp(x, self._tp)

    def _block(self, blk: Block, x, positions):
        """One transformer block. x: [B, S, D] in the activation dtype ->
        (x, MoE load-balance loss, or None for a dense block). Under tp the
        projections hold this rank's heads and mlp columns."""
        c = self.config
        dt = c.dtype
        h = self._tp_in(self._norm(x, blk.norm1, getattr(blk, "bias1", None)))
        q = self._proj(h, blk.wq.to(dt))                     # [B,S,H,hd]
        k = self._proj(h, blk.wk.to(dt))
        v = self._proj(h, blk.wv.to(dt))
        if c.positions == "rope":
            q = self._rope(q, positions)
            k = self._rope(k, positions)
        # [B,S,H,hd] -> [B,H,S,hd] as strided views: the kernels read them
        # in place and write the output in q's layout
        attn = self._attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2)).transpose(1, 2)
        attn = attn.reshape(*x.shape[:2], -1)
        x = x + self._tp_out(self._proj(attn,
                                        blk.wo.to(dt).reshape(-1, c.d_model)))

        h = self._norm(x, blk.norm2, getattr(blk, "bias2", None))
        if c.n_experts > 0:
            down, moe = moe_ffn(h, blk.router, blk.w_up, blk.w_gate,
                                blk.w_down, top_k=c.moe_top_k,
                                capacity_factor=c.moe_capacity_factor,
                                dtype=dt, mesh=self._moe_mesh)
            return x + down, moe["moe_aux_loss"]
        h = self._tp_in(h)
        up = self._proj(h, blk.w_up.to(dt))
        if c.activation == "swiglu":
            act = F.silu(self._proj(h, blk.w_gate.to(dt))) * up
        else:
            act = F.gelu(up, approximate="tanh")
        return x + self._tp_out(self._proj(act, blk.w_down.to(dt))), None

    def _attention(self, q, k, v):
        """[B, H, S, hd] -> [B, H, S, hd]: flash attention, or the ring over
        sp. On a loopback mesh S is the whole sequence, cut here into the
        ring's shards."""
        c = self.config
        if self._ring is None:
            return dot_product_attention(q, k, v, causal=True,
                                         impl=c.attention_impl)
        if self.mesh.loopback:
            n = self._ring.size
            outs = ring_attention(q.chunk(n, dim=2), k.chunk(n, dim=2),
                                  v.chunk(n, dim=2), self._ring, causal=True,
                                  impl=c.attention_impl)
            return torch.cat(outs, dim=2)
        return ring_attention(q, k, v, self._ring, causal=True,
                              impl=c.attention_impl)

    def _run_block(self, blk, x, positions):
        """The block_fn that `Block.forward` calls: `_block`, under the
        per-block checkpoint when remat is on (FSDP2's hooks lie outside
        it, so its recompute runs on the block's gathered parameters)."""
        c = self.config
        if not (c.remat and torch.is_grad_enabled()):
            return self._block(blk, x, positions)
        ctx = _REMAT_CONTEXTS[c.remat_policy]
        kw = {} if ctx is None else {"context_fn": ctx}
        return checkpoint(self._block, blk, x, positions,
                          use_reentrant=False, **kw)

    def _embed(self, tokens):
        """Token embeddings in the activation dtype. Under tp the table
        holds this rank's vocab rows: a masked local lookup, summed over tp
        (JAX all-gathers the table instead; the sums add zeros, so the
        numbers are the same)."""
        tbl = self.tok_embed.to(self.config.dtype)
        if self._tp is None:
            return F.embedding(tokens, tbl)
        local = tokens - self._vocab_lo
        mine = (local >= 0) & (local < tbl.shape[0])
        x = F.embedding(torch.where(mine, local, 0), tbl)
        return reduce_from_tp(torch.where(mine[..., None], x, 0), self._tp)

    def _embed_positions(self, tokens, positions):
        x = self._embed(tokens)
        if self.config.positions == "learned":
            x = x + F.embedding(positions, self.pos_embed.to(self.config.dtype))
        return x

    def _head(self, x):
        """The final norm and the head: f32 logits (under tp this rank's
        vocab columns), a new tensor (FSDP2 warns of a view as an output).
        The head's working copy in the activation dtype takes
        `head_pad_rows` zero rows, so the three products run at a multiple
        of `HEAD_ROW_ALIGN` rows; the logits and the head's gradient are
        cut back to its V rows in the casts that make them."""
        c = self.config
        x = self._tp_in(self._norm(x, self.norm_f,
                                   getattr(self, "bias_f", None)))
        head = (self.tok_embed.t() if c.tie_embeddings else self.lm_head)
        v = head.shape[1]
        w = _CastToWidth.apply(head, v + self.head_pad_rows, c.dtype)
        return _CastToWidth.apply(self._proj(x, w), v, torch.float32)

    def _positions(self, tokens, positions):
        """Positions default to the rank's global ones (its sequence shard's
        offset under a process-mesh ring)."""
        if positions is not None:
            return positions
        offset = 0
        if self._ring is not None and not self.mesh.loopback:
            offset = self.mesh.coords[self.rules.mesh_axes("act_seq")] \
                * tokens.shape[1]
        return torch.arange(offset, offset + tokens.shape[1],
                            device=tokens.device).expand(tokens.shape)

    # -- forward -----------------------------------------------------------

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                loss_inputs=None):
        """tokens [B, S] int -> (logits [B, S, V] f32, {"moe_aux_loss": the
        mean over layers of the MoE load-balance loss, 0 when dense}).

        On a process mesh, `tokens` are this rank's rows and sequence
        columns and `positions` default to their global ones; under tp the
        logits are this rank's vocab columns; with experts the load-balance
        loss is this rank's share of the global one. With pp > 1 the GPipe
        schedule runs the stages, and every pp rank gets the last stage's
        logits (no gradient flows across stages this way:
        `pipeline_loss(batch, backward=True)` trains). `loss_inputs` =
        (targets, loss_mask, total) is `pipeline_loss`'s: the last stage
        then keeps each microbatch's loss share, and the pipeline's run is
        returned."""
        c = self.config
        positions = self._positions(tokens, positions)
        if self.pp_stages > 1:
            return self._pipeline(tokens, positions, loss_inputs)
        x = self._embed_positions(tokens, positions)
        aux = []
        for blk in self.blocks.values():
            x, layer_aux = blk(self._run_block, x, positions)
            aux.append(layer_aux)
        logits = self._head(x)
        aux_loss = (torch.stack(aux).mean() if c.n_experts > 0 else
                    torch.zeros((), device=logits.device))
        return logits, {"moe_aux_loss": aux_loss}

    def forward_with_aux(self, tokens, positions=None):
        """`forward`, under JAX's name; called through the module, so that
        FSDP2's hooks run."""
        return self(tokens, positions)

    def apply(self, tokens, positions=None) -> torch.Tensor:
        """tokens: [B, S] → logits [B, S, V] (f32)."""
        return self(tokens, positions)[0]

    def _n_micro(self, batch: int) -> int:
        m = self.config.pp_microbatches or self.pp_stages
        if batch % m:
            raise ValueError(f"batch {batch} must divide into {m} "
                             "microbatches")
        return m

    def _pipeline(self, tokens, positions, loss_inputs):
        """GPipe over the stages (`ray_tpu_torch.parallel.pipeline`): this
        rank's rows split into M microbatches (JAX splits the global rows
        first, so a dp rank may hold other rows of a microbatch; the loss is
        a global sum either way)."""
        c = self.config
        M = self._n_micro(tokens.shape[0])
        P = self.pp_stages
        toks, pos = tokens.chunk(M), positions.chunk(M)
        nll = {}

        def first(m):
            return self._embed_positions(toks[m], pos[m])

        def stage(s, x, m):
            for i in self._stage_layers(s):
                x, _ = self.blocks[str(i)](self._run_block, x, pos[m])
            return x

        def last(y, m):
            logits = self._head(y)
            if loss_inputs is None:
                return logits
            targets, mask, total = loss_inputs
            loss, nll[m] = self._loss_share(logits, targets.chunk(M)[m],
                                            mask.chunk(M)[m], total)
            return loss

        like = ((tokens.shape[0] // M, tokens.shape[1], c.d_model), c.dtype,
                tokens.device)
        run = pipeline.forward(self._pipe, M, first, stage, last, like)
        if loss_inputs is not None:
            run["nll"] = [nll[m] for m in sorted(nll)]
            run["like"] = like
            return run
        logits = None
        if P - 1 in self._pipe.stages:
            logits = torch.cat([run["outputs"][P - 1, m] for m in range(M)])
        if self.sums_over_ranks:
            import torch.distributed as dist

            if logits is None:
                v = (self.tok_embed.shape[0] if c.tie_embeddings
                     else self.lm_head.shape[1])
                logits = torch.empty((*tokens.shape, v), device=tokens.device)
            dist.broadcast(logits, self._pipe.global_rank(P - 1),
                           group=self._pipe.group)
        return logits, {"moe_aux_loss": torch.zeros((), device=tokens.device)}

    def _lse_and_true_logit(self, logits, targets):
        """Per position, the log-sum-exp of the logits and the target's
        logit, in f32. Under tp each rank holds a vocab slice: its own
        log-sum-exp and (where the target falls in its slice) the target's
        logit are gathered over tp and combined; with one rank the
        combination returns them unchanged."""
        lse = torch.logsumexp(logits, dim=-1)                 # [B, S]
        if self._tp is None:
            return lse, logits.gather(-1, targets[..., None])[..., 0]
        local = targets - self._vocab_lo
        mine = (local >= 0) & (local < logits.shape[-1])
        true_logit = torch.where(mine, logits.gather(
            -1, torch.where(mine, local, 0)[..., None])[..., 0], 0.0)
        parts = gather_from_tp(torch.stack([lse, true_logit]), self._tp)
        return torch.logsumexp(parts[:, 0], dim=0), parts[:, 1].sum(0)

    def _loss_share(self, logits, targets, mask, total):
        """(this part's share of the cross entropy + z-loss, normalised by
        the global `total`, and its summed nll, detached)."""
        c = self.config
        lse, true_logit = self._lse_and_true_logit(logits, targets)
        nll_sum = ((lse - true_logit) * mask).sum()
        loss = nll_sum / total
        if c.z_loss:
            loss = loss + c.z_loss * (lse ** 2 * mask).sum() / total
        return loss, nll_sum.detach()

    def _count(self, mask):
        """The global mask count (over the batch group on a process mesh)."""
        count = mask.sum()
        if self.sums_over_ranks:
            count = self._sum_over_batch(count.detach())
        return count

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy (+ z-loss) with an optional loss mask.

        batch: the global batch {"tokens": [B, S] int, optional "loss_mask":
        [B, S]}. Targets are tokens shifted left; the final position is
        masked. On a process mesh this rank takes its part of the batch
        (`shard_batch`), the loss is its share of the global one, normalised
        by the global mask count, and the metrics are global. With pp > 1
        this is `pipeline_loss(batch)`: the forward alone, the loss the
        global one, detached.
        """
        if self.pp_stages > 1:
            with torch.no_grad():
                return self.pipeline_loss(batch)
        c = self.config
        global_shape = (*batch["tokens"].shape, c.vocab_size)
        batch = shard_batch(self.mesh, batch, self.rules)
        tokens, targets, mask = (batch["tokens"], batch["targets"],
                                 batch["loss_mask"])
        logits, aux = self(tokens, batch["positions"])
        with_logical_constraint(logits, "act_batch", "act_seq", "act_vocab",
                                global_shape=global_shape, rules=self.rules,
                                mesh=self.mesh)
        count = self._count(mask)
        total = count.clamp(min=1.0)
        loss, nll_sum = self._loss_share(logits, targets, mask, total)
        metrics = {
            "loss": loss.detach(),
            "ppl_log": nll_sum / total,
            "tokens": count,
        }
        if c.n_experts > 0:
            loss = loss + c.moe_aux_coeff * aux["moe_aux_loss"]
            metrics["moe_aux_loss"] = aux["moe_aux_loss"].detach()
        if self.sums_over_ranks:
            # one sum over the batch group: the loss shares, their nll, and
            # with experts the load-balance loss shares
            names = [n for n in ("loss", "ppl_log", "moe_aux_loss")
                     if n in metrics]
            summed = self._sum_over_batch(torch.stack(
                [metrics[n] for n in names]))
            metrics.update(zip(names, summed))
        if c.n_experts > 0:
            metrics["loss"] = (metrics["loss"]
                               + c.moe_aux_coeff * metrics["moe_aux_loss"])
        return loss, metrics

    def pipeline_loss(self, batch: Dict[str, torch.Tensor],
                      backward: bool = False
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """`loss` through the GPipe schedule (pp > 1), and with `backward`
        its backward too, which leaves each parameter's gradient of this
        rank's loss share in its ``.grad`` (the parameters outside the
        blocks only of the stages that use them: the step sums those over
        pp). Returns (the global loss, detached, and the metrics), the same
        on every rank."""
        c = self.config
        self._n_micro(batch["tokens"].shape[0])       # JAX's check, global B
        part = shard_batch(self.mesh, batch, self.rules)
        mask = part["loss_mask"]
        count = self._count(mask)
        total = count.clamp(min=1.0)
        run = self(part["tokens"], part["positions"],
                   loss_inputs=(part["targets"], mask, total))
        P, M = self.pp_stages, self._n_micro(part["tokens"].shape[0])
        stats = torch.zeros(2, device=mask.device)
        if P - 1 in self._pipe.stages:
            stats = torch.stack([
                sum(run["outputs"][P - 1, m].detach() for m in range(M)),
                sum(run["nll"]) / total])
        if backward:
            pipeline.backward(self._pipe, M, run, run["like"])
        if self.sums_over_ranks:
            import torch.distributed as dist

            stats = self._sum_over_batch(stats)
            dist.broadcast(stats, self._pipe.global_rank(P - 1),
                           group=self._pipe.group)
        metrics = {"loss": stats[0], "ppl_log": stats[1], "tokens": count}
        if c.n_experts > 0:                  # refused with pp > 1; as JAX
            metrics["moe_aux_loss"] = torch.zeros((), device=mask.device)
        return stats[0], metrics

    def _sum_over_batch(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of `t` over the ranks that hold different parts of the batch
        (dp x fsdp x sp), in place; the tp and ep ranks of one part hold the
        same numbers and are not summed."""
        import torch.distributed as dist

        dist.all_reduce(t, group=self.mesh.batch_group)
        return t
