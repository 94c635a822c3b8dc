"""Settled CPU numerics: the same values give the same bits on every call.

Torch's CPU `exp`, `log`, `tanh` and the other transcendental unary ops
run through MKL's vector math library (VML). VML picks its kernel for each
function on the function's first call in the process, and when torch's
intra-op threads make that first call at once (an op over a tensor larger
than one grain, on 2 or more threads), one thread's chunk can run on VML's
low-accuracy kernel: its `exp` reads 1.5e-4 relative from float64 where
later calls read 6e-8. Every later call is bit-stable. So the first pass of
a fresh process can differ from the second in the rows that thread held
(the causal ring partial's `exp`, batch 0 or 1 at 2 threads).

`settle_cpu_numerics` makes that first call on one element, in one thread,
for each such function on f32 and f64. A program that compares two passes
bit for bit, or resumes a run in a fresh process and expects the
uninterrupted run's bits, calls it before its first op.
"""

from __future__ import annotations

from typing import Optional

import torch

# the VML-backed unary ops the port's CPU paths reach (attention's exp and
# log, GELU's tanh, RoPE's sin/cos, Adam's sqrt, ...)
_VML_OPS = (torch.exp, torch.log, torch.tanh, torch.sin, torch.cos,
            torch.sqrt, torch.erf, torch.log1p, torch.expm1, torch.rsqrt)


def settle_cpu_numerics(num_threads: Optional[int] = None) -> None:
    """Set torch's intra-op thread count (when given), then make the first
    call of each VML-backed op on a one-element tensor, which runs in the
    calling thread alone."""
    if num_threads is not None:
        torch.set_num_threads(num_threads)
    for dtype in (torch.float32, torch.float64):
        x = torch.full((1,), 0.5, dtype=dtype)
        for op in _VML_OPS:
            op(x)
