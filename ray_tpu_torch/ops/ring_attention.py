"""Ring attention: exact attention with the sequence sharded over a ring.

Counterpart of ``ray_tpu/ops/ring_attention.py``. The sequence is split
into ``sp`` shards; each shard keeps its queries while the K/V blocks travel
around the ring, one hop a step, and the per-block softmax partials merge
online in f32 (m, l, acc). The backward runs the ring again with the
global lse and delta, carrying the f32 dK/dV sums along with K/V so that
after ``sp`` hops they are back on their home shard.

There is no kernel here: each partial is the flash forward kernel
(`flash_fwd`, causal on the diagonal step only) or the two backward kernels
(`flash_bwd(..., delta=, keep_f32=True)`), as the JAX ring reuses the
Pallas kernels.

Transports. `ProcessGroupRing` moves the blocks between ranks of a
`torch.distributed` group (``batch_isend_irecv``; gloo carries CPU
tensors, NCCL CUDA tensors). `LoopbackRing` holds every shard in one
process and rotates a Python list of them: it makes the same partial calls
as the ranks of a process-group ring would, with no copies.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from .attention import NEG_INF, _repeat_kv, flash_bwd, flash_fwd

_SKIP, _DIAG, _FULL = 0, 1, 2


def _mode(step: int, idx: int, causal: bool) -> int:
    """The block shard `idx` holds at `step` started on shard
    (idx - step) mod sp: step 0 is its own (the causal diagonal), a step
    <= idx an earlier shard (every key visible), a later step a later shard
    (every key masked: skipped, nothing launched)."""
    if not causal:
        return _FULL
    if step == 0:
        return _DIAG
    return _FULL if step <= idx else _SKIP


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------

class LoopbackRing:
    """Every shard of an sp ring in this process. `shift` hands shard i what
    shard i - 1 held by rotating the list; nothing is copied."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"ring size must be >= 1, got {size}")
        self.size = size
        self.indices = tuple(range(size))

    def shift(self, shards: List[tuple]) -> List[tuple]:
        return shards[-1:] + shards[:-1]


class ProcessGroupRing:
    """This rank's place in a ring over a `torch.distributed` group: it
    sends to group rank (r + 1) mod sp and receives from (r - 1) mod sp."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group if group is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.group)
        rank = dist.get_rank(self.group)
        self.indices = (rank,)
        # a P2POp names its peer by its global rank
        self._next = dist.get_global_rank(self.group, (rank + 1) % self.size)
        self._prev = dist.get_global_rank(self.group, (rank - 1) % self.size)
        self._gloo = dist.get_backend(self.group) == "gloo"

    def check(self, tensors: Sequence[torch.Tensor]) -> None:
        """gloo carries CPU tensors only; staging CUDA tensors through the
        host would be a hidden fallback, so they raise before any send."""
        if self._gloo:
            bad = sorted({str(t.device) for t in tensors
                          if t.device.type != "cpu"})
            if bad:
                raise RuntimeError(
                    f"a gloo ring carries CPU tensors only, got tensors on "
                    f"{bad}; use an NCCL group for CUDA tensors")

    def shift(self, shards: List[tuple]) -> List[tuple]:
        import torch.distributed as dist

        (tensors,) = shards
        self.check(tensors)
        if self.size == 1:
            return shards
        send = [t.contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in send]
        ops = ([dist.P2POp(dist.isend, t, self._next, self.group)
                for t in send]
               + [dist.P2POp(dist.irecv, t, self._prev, self.group)
                  for t in recv])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [tuple(recv)]


def ring_transport(group):
    """The ring over `group`: a `LoopbackRing` is its own transport, a
    process group gets a `ProcessGroupRing`."""
    if isinstance(group, (LoopbackRing, ProcessGroupRing)):
        return group
    return ProcessGroupRing(group)


# ---------------------------------------------------------------------------
# Partials: plain (copied from the JAX package) and through the kernels
# ---------------------------------------------------------------------------

def _diag_mask(q_len, k_len, device):
    qi = torch.arange(q_len, device=device)[:, None]
    kj = torch.arange(k_len, device=device)[None, :]
    return kj <= qi


def _partial_fwd_reference(q, k, v, scale, diag):
    """Blockwise attention partial -> (out f32, lse) in plain torch."""
    group = q.shape[-3] // k.shape[-3]
    k, v = _repeat_kv(k, group), _repeat_kv(v, group)
    s = torch.einsum("...hqd,...hkd->...hqk", q.float(), k.float()) * scale
    if diag:
        s = torch.where(_diag_mask(s.shape[-2], s.shape[-1], s.device), s,
                        NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("...hqk,...hkd->...hqd", p, v.float())
    l_safe = torch.where(l == 0.0, 1.0, l)
    return out / l_safe[..., None], m + torch.log(l_safe)


def _partial_bwd_reference(q, k, v, do, lse, delta, scale, diag):
    """Blockwise gradients (f32) given the *global* lse/delta statistics."""
    num_kv_heads = k.shape[-3]
    group = q.shape[-3] // num_kv_heads
    kr, vr = _repeat_kv(k, group).float(), _repeat_kv(v, group).float()
    s = torch.einsum("...hqd,...hkd->...hqk", q.float(), kr) * scale
    if diag:
        s = torch.where(_diag_mask(s.shape[-2], s.shape[-1], s.device), s,
                        NEG_INF)
    p = torch.exp(s - lse[..., None])
    do32 = do.float()
    dv = torch.einsum("...hqk,...hqd->...hkd", p, do32)
    dp = torch.einsum("...hqd,...hkd->...hqk", do32, vr)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("...hqk,...hkd->...hqd", ds, kr)
    dk = torch.einsum("...hqk,...hqd->...hkd", ds, q.float())
    if group > 1:
        b, h, klen, d = dk.shape
        dk = dk.reshape(b, num_kv_heads, group, klen, d).sum(dim=2)
        dv = dv.reshape(b, num_kv_heads, group, klen, d).sum(dim=2)
    return dq, dk, dv


def _partial_fwd_kernel(q, k, v, scale, diag):
    """The forward kernel's partial: out in q's dtype (rounded there, as the
    JAX ring rounds its Pallas partial), lse f32."""
    return flash_fwd(q, k, v, diag, scale)


def _partial_bwd_kernel(q, k, v, do, lse, delta, scale, diag):
    return flash_bwd(q, k, v, None, lse, do, diag, scale, delta=delta,
                     keep_f32=True)


_PARTIALS = {
    "reference": (_partial_fwd_reference, _partial_bwd_reference),
    "kernels": (_partial_fwd_kernel, _partial_bwd_kernel),
}


def _resolve(impl: str, q: torch.Tensor) -> str:
    """"auto": the kernels' wrappers (kernels on CUDA, their plain versions
    on the CPU); "cuda": the kernels, raising off CUDA; "reference": the
    plain partials."""
    if impl == "reference":
        return "reference"
    if impl == "cuda":
        if q.device.type != "cuda":
            raise ValueError(f"impl='cuda' needs CUDA tensors, got {q.device}")
        return "kernels"
    if impl == "auto":
        return "kernels"
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------

def _ring_fwd(qs, ks, vs, transport, causal, scale, fwd):
    """Forward over this process's shards -> (outs in q's dtype, lses)."""
    acc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    m = [torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                    device=q.device) for q in qs]
    l = [torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
         for q in qs]
    kv = list(zip(ks, vs))
    for step in range(transport.size):
        for j, idx in enumerate(transport.indices):
            mode = _mode(step, idx, causal)
            if mode == _SKIP:
                # JAX merges (0, lse NEG_INF) here: once step 0 has given
                # every row a finite m, that merge leaves m, l, acc as they
                # are (alpha 1, beta 0)
                continue
            o_s, lse_s = fwd(qs[j], kv[j][0], kv[j][1], scale, mode == _DIAG)
            m_new = torch.maximum(m[j], lse_s)
            alpha = torch.exp(m[j] - m_new)
            beta = torch.exp(lse_s - m_new)
            acc[j] = acc[j] * alpha[..., None] + o_s * beta[..., None]
            l[j] = l[j] * alpha + beta
            m[j] = m_new
        if step + 1 < transport.size:     # the last hop would only go home
            kv = transport.shift(kv)
    outs, lses = [], []
    for q, a, mj, lj in zip(qs, acc, m, l):
        l_safe = torch.where(lj == 0.0, 1.0, lj)
        outs.append((a / l_safe[..., None]).to(q.dtype))
        lses.append(mj + torch.log(l_safe))
    return outs, lses


def _ring_bwd(qs, ks, vs, outs, lses, gs, transport, causal, scale, bwd):
    """Backward over this process's shards -> (dqs, dks, dvs)."""
    deltas = [(g.float() * o.float()).sum(dim=-1) for g, o in zip(gs, outs)]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in qs]
    state = [(k, v, torch.zeros(k.shape, dtype=torch.float32,
                                device=k.device),
              torch.zeros(v.shape, dtype=torch.float32, device=v.device))
             for k, v in zip(ks, vs)]
    for step in range(transport.size):
        for j, idx in enumerate(transport.indices):
            mode = _mode(step, idx, causal)
            if mode == _SKIP:
                continue
            k_cur, v_cur, dk_cur, dv_cur = state[j]
            dq_s, dk_s, dv_s = bwd(qs[j], k_cur, v_cur, gs[j], lses[j],
                                   deltas[j], scale, mode == _DIAG)
            dq[j] += dq_s
            dk_cur += dk_s
            dv_cur += dv_s
        if step + 1 < transport.size:
            state = transport.shift(state)
        else:   # after sp hops the dK/dV sums are home; K/V need not go
            state = transport.shift([st[2:] for st in state])
    dqs = [d.to(q.dtype) for d, q in zip(dq, qs)]
    dks = [st[0].to(k.dtype) for st, k in zip(state, ks)]
    dvs = [st[1].to(v.dtype) for st, v in zip(state, vs)]
    return dqs, dks, dvs


class RingAttention(torch.autograd.Function):
    """Ring attention over this process's `n` shards, passed flat as
    q_1..q_n, k_1..k_n, v_1..v_n. Saves the shards, outputs and global lse,
    so recomputation under checkpointing re-runs the whole ring forward
    (and, over a process group, its exchange)."""

    @staticmethod
    def forward(ctx, transport, causal, scale, partials, n, *tensors):
        qs, ks, vs = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        outs, lses = _ring_fwd(qs, ks, vs, transport, causal, scale,
                               _PARTIALS[partials][0])
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.args = (transport, causal, scale, partials, n)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        transport, causal, scale, partials, n = ctx.args
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * n:(i + 1) * n] for i in range(5))
        dqs, dks, dvs = _ring_bwd(qs, ks, vs, outs, lses, gs, transport,
                                  causal, scale, _PARTIALS[partials][1])
        return (None,) * 5 + (*dqs, *dks, *dvs)


def ring_attention(q, k, v, transport, causal: bool = True,
                   scale: Optional[float] = None, impl: str = "auto"):
    """Exact attention with the sequence sharded over `transport`'s ring.

    q: [B, H, S_local, D]; k/v: [B, Hk, S_local, D], this rank's shard. A
    `LoopbackRing` takes (and returns) lists of every shard, in sequence
    order. Returns the output in q's dtype.
    """
    loopback = isinstance(q, (list, tuple))
    qs, ks, vs = (list(x) if loopback else [x] for x in (q, k, v))
    n = len(transport.indices)
    if not (len(qs) == len(ks) == len(vs) == n):
        raise ValueError(f"ring of {transport.size} holds {n} shard(s) here, "
                         f"got {len(qs)}/{len(ks)}/{len(vs)}")
    for t in (*qs, *ks, *vs):
        if t.dim() != 4:
            raise ValueError("ring attention wants [B, H, S, D] shards")
    if len({t.shape[2] for t in (*qs, *ks, *vs)}) != 1:
        raise ValueError("ring attention wants equal-length shards")
    partials = _resolve(impl, qs[0])
    scale = scale if scale is not None else 1.0 / math.sqrt(qs[0].shape[-1])
    outs = RingAttention.apply(transport, causal, scale, partials, n,
                               *qs, *ks, *vs)
    return list(outs) if loopback else outs[0]
