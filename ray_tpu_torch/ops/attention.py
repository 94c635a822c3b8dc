"""Causal multi-head attention: plain PyTorch versions + hand-written CUDA
flash kernels for Hopper.

Counterpart of ``ray_tpu/ops/attention.py``. The three TPU Pallas kernels
there (forward, backward dQ, backward dK/dV) are CUDA C++ kernels here
(``ray_tpu_torch/csrc``), each with a plain PyTorch version of the same
function beside it. A wrapper takes the plain version only for tensors on
the CPU; on a CUDA tensor it launches its kernel or raises.

Shapes follow [batch, num_heads, seq, head_dim] ("BHSD"); GQA is
num_q_heads = G * num_kv_heads, q-head h reading kv-head h // G. The
causal mask is end-aligned: query i attends keys j <= i + (k_len - q_len).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _ext

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)

# Kernel launches since the last reset, one plain int per kernel.
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Reference implementation (ground truth)
# ---------------------------------------------------------------------------

def _causal_mask(q_len: int, k_len: int, device) -> torch.Tensor:
    qi = torch.arange(q_len, device=device)[:, None]
    kj = torch.arange(k_len, device=device)[None, :]
    return kj <= qi + (k_len - q_len)


def _repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    return x if group == 1 else x.repeat_interleave(group, dim=-3)


def attention_reference(q, k, v, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain f32 attention with GQA by repeat. q: [B,H,Sq,D]; k/v: [B,Hk,Sk,D]."""
    num_q_heads, q_len, head_dim = q.shape[-3:]
    k_len = k.shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(head_dim)
    group = num_q_heads // k.shape[-3]
    k = _repeat_kv(k, group).float()
    v = _repeat_kv(v, group).float()
    s = torch.einsum("...hqd,...hkd->...hqk", q.float(), k) * scale
    if causal:
        s = torch.where(_causal_mask(q_len, k_len, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...hqk,...hkd->...hqd", p, v).to(q.dtype)


# ---------------------------------------------------------------------------
# Plain versions of the three kernels (f32 math, same masking rules)
# ---------------------------------------------------------------------------

def _scores(q, k, causal, scale):
    """Scaled scores [B,H,Sq,Sk] in f32 and the validity mask (or None)."""
    group = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     _repeat_kv(k, group).float()) * scale
    mask = _causal_mask(q.shape[2], k.shape[2], q.device) if causal else None
    return s, mask


def flash_fwd_plain(q, k, v, causal: bool = True, scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel -> (out in q's dtype,
    lse [B,H,Sq] f32). A fully masked row gives out 0 and lse NEG_INF."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s, mask = _scores(q, k, causal, scale)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    group = q.shape[1] // k.shape[1]
    out = torch.einsum("bhqk,bhkd->bhqd", p, _repeat_kv(v, group).float())
    out = out / l_safe
    lse = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


def _probs(q, k, lse, causal, scale):
    s, mask = _scores(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    return p if mask is None else torch.where(mask, p, 0.0)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                       scale: Optional[float] = None,
                       keep_f32: bool = False) -> torch.Tensor:
    """Plain version of the dQ kernel: dQ = (P * (dO V^T - delta) * scale) K."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    group = q.shape[1] // k.shape[1]
    p = _probs(q, k, lse, causal, scale)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(),
                      _repeat_kv(v, group).float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, _repeat_kv(k, group).float())
    return dq if keep_f32 else dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel, per q-head: f32 [B,H,Sk,D] each.
    `_group_sum` reduces it over the GQA group, as the reference's glue
    does; the CUDA kernel does that sum itself."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    group = q.shape[1] // k.shape[1]
    p = _probs(q, k, lse, causal, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(),
                      _repeat_kv(v, group).float())
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dk, dv


def _group_sum(x: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    b, h, s, d = x.shape
    if h == num_kv_heads:
        return x
    return x.reshape(b, num_kv_heads, h // num_kv_heads, s, d).sum(dim=2)


# ---------------------------------------------------------------------------
# Kernel wrappers: CPU -> plain version, CUDA -> kernel (or raise)
# ---------------------------------------------------------------------------

def _check(q, k, v, *rest):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("attention wants [B, H, S, D] tensors")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"num_q_heads={h} is not a multiple of "
                         f"num_kv_heads={k.shape[1]}")
    devices = {t.device for t in (q, k, v, *rest)}
    if len(devices) != 1:
        raise ValueError(f"attention tensors on several devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention on {device} is not supported")
    return device.type == "cuda"


def _kernel_view(t: torch.Tensor, dtype) -> torch.Tensor:
    """The tensor as the kernels read it: dtype `dtype`, last dim
    contiguous, strides and base address aligned for 16-byte loads."""
    if t.dtype != dtype:
        raise TypeError(f"kernel input of dtype {t.dtype}, expected {dtype}")
    per16 = 16 // t.element_size()
    if (t.stride(-1) != 1 or any(s % per16 for s in t.stride()[:-1])
            or t.data_ptr() % 16):
        # a fresh copy: .contiguous() would keep a misaligned base as it is
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _bf16_view(t: torch.Tensor, dtype) -> torch.Tensor:
    """The tensor as the TMA kernels read it: bf16, 16-byte aligned. f32
    inputs are rounded to bf16 here (round to nearest even, as the
    kernels' own rounding would), their strides kept."""
    t = _kernel_view(t, dtype)
    return t if dtype == torch.bfloat16 else \
        _kernel_view(t.to(torch.bfloat16), torch.bfloat16)


def _params(q, k, causal, scale, **tensors) -> _ext.FlashParams:
    """The kernels' argument struct: pointers of q, k and `tensors` (named
    as the struct's fields), and the strides of each 4-D one."""
    p = _ext.FlashParams()
    for name, t in dict(q=q, k=k, **tensors).items():
        setattr(p, name, t.data_ptr())
        if t.dim() == 4:
            pre = "do" if name == "dout" else name
            for dim, stride in zip(("sb", "sh", "ss"), t.stride()):
                setattr(p, f"{pre}_{dim}", stride)
    p.B, p.H, p.Sq, p.D = q.shape
    p.Hk, p.Sk = k.shape[1], k.shape[2]
    p.scale, p.causal = float(scale), int(causal)
    return p


def _check_card(device) -> None:
    """The kernels are built for sm_90a (Hopper) alone: wgmma and setmaxnreg
    exist for no other target."""
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"ray_tpu_torch's flash kernels are built for sm_90a (Hopper, "
            f"compute capability 9.0); {torch.cuda.get_device_name(device)} "
            f"is {cap[0]}.{cap[1]}")


def _launch(name: str, p: _ext.FlashParams, device) -> None:
    _check_card(device)
    fn = _ext.kernel(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.byref(p), ctypes.c_void_p(stream))
    if err >= _ext.ERR_TENSOR_MAP:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed "
                           f"(CUresult {err - _ext.ERR_TENSOR_MAP})")
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    launches[name] += 1


def _kernel_dtype(q):
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernels take bf16 or f32, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash kernels support head_dim in {HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    return q.dtype


def flash_fwd(q, k, v, causal: bool = True, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel (`_fwd_kernel` on the TPU) -> (out, lse [B,H,Sq] f32)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not _check(q, k, v):
        return flash_fwd_plain(q, k, v, causal, scale)
    dt = _kernel_dtype(q)
    q = _kernel_view(q, dt)
    out = torch.empty_like(q)              # keeps q's (transposed) strides
    q, k, v = (_bf16_view(t, dt) for t in (q, k, v))
    lse = torch.empty(q.shape[:3], device=q.device, dtype=torch.float32)
    if q.numel() and k.shape[2]:
        p = _params(q, k, causal, scale, v=v, o=out, lse=lse)
        p.out_f32 = int(dt == torch.float32)
        _launch("flash_fwd", p, q.device)
    else:
        out.zero_()
        lse.fill_(NEG_INF)
    return out, lse


def flash_bwd(q, k, v, out, lse, do, causal: bool = True,
              scale: Optional[float] = None,
              delta: Optional[torch.Tensor] = None,
              keep_f32: bool = False):
    """Backward: the dQ kernel and the dK/dV kernel -> (dq, dk, dv).

    `delta` (rowsum(dO * O), [B,H,Sq] f32) is computed here when not given;
    a ring-attention caller passes the global one. With `keep_f32` the
    gradients stay f32 (for partial sums across ring steps); otherwise they
    come back in the inputs' dtypes."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if delta is None:
        delta = (do.float() * out.float()).sum(dim=-1)
    if not _check(q, k, v, lse, do, delta):
        dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale,
                                keep_f32)
        dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
        dk, dv = _group_sum(dk, k.shape[1]), _group_sum(dv, k.shape[1])
        if keep_f32:
            return dq, dk, dv
        return dq, dk.to(k.dtype), dv.to(v.dtype)
    dt = _kernel_dtype(q)
    # both kernels read bf16 through TMA; outputs keep the caller's dtype
    q, k, v, do = (_bf16_view(t, dt) for t in (q, k, v, do))
    # the dK/dV kernel reads both through 1-D tensor maps: 16-byte aligned
    lse, delta = (t.float().contiguous() for t in (lse, delta))
    lse, delta = (t.clone() if t.data_ptr() % 16 else t for t in (lse, delta))
    if lse.shape != q.shape[:3] or delta.shape != q.shape[:3]:
        raise ValueError("lse/delta must be [B, H, Sq]")
    gdt = torch.float32 if keep_f32 else dt
    dq = torch.empty_like(q, dtype=gdt)
    dk = torch.empty_like(k, dtype=gdt)
    dv = torch.empty_like(v, dtype=gdt)
    if not (q.numel() and k.shape[2]):
        return dq.zero_(), dk.zero_(), dv.zero_()
    p = _params(q, k, causal, scale, v=v, dout=do, lse=lse, delta=delta,
                dq=dq, dk=dk, dv=dv)
    p.out_f32 = int(gdt == torch.float32)
    _launch("flash_bwd_dq", p, q.device)
    _launch("flash_bwd_dkv", p, q.device)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Public flash attention with its gradient
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """Flash attention: forward kernel, backward dQ and dK/dV kernels.
    Saves (q, k, v, out, lse), so recomputation under checkpointing
    re-launches only the forward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True,
                scale: Optional[float] = None):
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention with autograd. [B, H, S, D]; GQA via Hk | H."""
    return FlashAttention.apply(q, k, v, causal, scale)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def dot_product_attention(q, k, v, causal: bool = True,
                          scale: Optional[float] = None,
                          impl: str = "auto") -> torch.Tensor:
    """Attention entry point used by models.

    impl: "auto" (the flash kernels on CUDA, their plain versions on the
    CPU, both through `FlashAttention`), "cuda" (the kernels; raises off
    CUDA), "reference".
    """
    if impl == "reference":
        return attention_reference(q, k, v, causal=causal, scale=scale)
    if impl == "cuda":
        if q.device.type != "cuda":
            raise ValueError(f"impl='cuda' needs CUDA tensors, got {q.device}")
        return flash_attention(q, k, v, causal, scale)
    if impl == "auto":
        return flash_attention(q, k, v, causal, scale)
    raise ValueError(f"unknown attention impl {impl!r}")
